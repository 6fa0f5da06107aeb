"""Goodput accounting: bucket run wall-clock into where it actually went.

The JAX package's ``obs/goodput.py`` with the same buckets; the port
compiles no step, so ``compile`` holds its warm-up instead:

- ``compile``      init or checkpoint restore, and the first step of a
                   ``fit`` (the CUDA kernels build at first use, cuBLAS
                   and the caching allocator warm up)
- ``step``         steady-state training-step host time (the goodput)
- ``checkpoint``   save dispatch, restore and async-commit waits
- ``eval``         periodic evaluation passes
- ``trace``        profiler-instrumented steps (not ported yet: always 0)
- ``input_stall``  waiting on the data source for the next batch
- ``idle``         everything unaccounted (guards, logging, callbacks,
                   host-side bookkeeping) — computed as the remainder

``summary()`` fractions are of total wall-clock and sum to ~1.0 by
construction; ``goodput`` is step / total.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

BUCKETS = ("compile", "step", "checkpoint", "eval", "trace",
           "input_stall", "idle")


class GoodputMeter:
    """Accumulates seconds per bucket against a run-start reference."""

    def __init__(self):
        self._t_start = time.monotonic()
        self.seconds: dict[str, float] = {b: 0.0 for b in BUCKETS}

    def add(self, bucket: str, seconds: float) -> None:
        if bucket not in self.seconds:
            raise ValueError(
                f"unknown goodput bucket {bucket!r}; expected one of {BUCKETS}"
            )
        self.seconds[bucket] += max(0.0, seconds)

    @contextlib.contextmanager
    def measure(self, bucket: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(bucket, time.monotonic() - t0)

    def total_wall_s(self) -> float:
        return time.monotonic() - self._t_start

    def summary(self, total_wall_s: float | None = None) -> dict:
        """Bucket seconds + fractions-of-wall-clock summing to ~1.0.

        ``idle`` is the remainder of the wall clock not claimed by any
        measured bucket, clamped at 0 (measured buckets can slightly
        overlap the total on coarse clocks).
        """
        total = total_wall_s if total_wall_s is not None else self.total_wall_s()
        secs = dict(self.seconds)
        measured = sum(v for b, v in secs.items() if b != "idle")
        secs["idle"] = max(0.0, total - measured)
        total = max(total, 1e-9)
        return {
            "total_wall_s": total,
            "seconds": {b: secs[b] for b in BUCKETS},
            "fractions": {b: secs[b] / total for b in BUCKETS},
            "goodput": secs["step"] / total,
        }
