"""Observability: the span/event journal (``obs.journal``)."""
