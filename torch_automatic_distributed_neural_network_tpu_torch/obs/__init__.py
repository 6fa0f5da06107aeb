"""Observability: the span/event journal (``obs.journal``), its event
schema registry (``obs.schema``), the goodput breakdown
(``obs.goodput``) and the merge of per-host journals
(``obs.aggregate``).  Library code emits to a
process-global journal (``set_default`` / ``TADNN_JOURNAL``); when none
is installed every call is a cheap no-op."""

from . import aggregate, schema
from .goodput import BUCKETS, GoodputMeter
from .journal import (
    Journal,
    as_default,
    event,
    get_default,
    set_default,
    span,
)

__all__ = [
    "BUCKETS", "GoodputMeter", "Journal", "aggregate", "as_default", "event",
    "get_default", "schema", "set_default", "span",
]
