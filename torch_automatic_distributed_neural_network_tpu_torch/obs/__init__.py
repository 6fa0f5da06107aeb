"""Observability: the span/event journal (``obs.journal``), its event
schema registry (``obs.schema``), the goodput breakdown
(``obs.goodput``), the merge of per-host journals (``obs.aggregate``),
the live serving windows (``obs.live``), the SLO monitor over them
(``obs.slo_monitor``), the ``torch.profiler`` step capture and its
attribution (``obs.trace``), the collective-bytes accounting
(``obs.comms``) and the ``tadnn report`` backend (``obs.report``,
imported on use, as in the JAX package).  Library code emits to a
process-global journal (``set_default`` / ``TADNN_JOURNAL``); when none
is installed every call is a cheap no-op."""

from . import aggregate, live, schema, slo_monitor, trace
from .goodput import BUCKETS, GoodputMeter
from .journal import (
    Journal,
    as_default,
    event,
    get_default,
    set_default,
    span,
)
from .live import LatencySketch, LiveAggregator, aggregate_stream
from .slo_monitor import MonitorPolicy, SLOMonitor

__all__ = [
    "BUCKETS", "GoodputMeter", "Journal", "LatencySketch", "LiveAggregator",
    "MonitorPolicy", "SLOMonitor", "aggregate", "aggregate_stream",
    "as_default", "event", "get_default", "live", "schema", "set_default",
    "slo_monitor", "span", "trace",
]
