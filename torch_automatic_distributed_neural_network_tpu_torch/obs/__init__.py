"""Observability: the span/event journal (``obs.journal``) and the
goodput breakdown (``obs.goodput``).  Library code emits to a
process-global journal (``set_default`` / ``TADNN_JOURNAL``); when none
is installed every call is a cheap no-op."""

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
    "BUCKETS", "GoodputMeter", "Journal", "as_default", "event",
    "get_default", "set_default", "span",
]
