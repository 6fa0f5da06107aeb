"""Streaming serving telemetry: fold a live journal into rolling
windows.

``tadnn report`` is post-hoc — it parses a finished journal.  This
module is the live half: :meth:`Journal.follow` tails the file while
the engine is still appending, and :class:`LiveAggregator` folds each
``serve.*`` event into fixed-width event-time windows the instant it
arrives, keeping per-window TTFT/ITL/latency percentiles (a mergeable
log-bucketed :class:`LatencySketch` — bounded memory, mergeable across
windows and hosts), token throughput, occupancy, preemptions, prefix
hit rate, and speculative accept rate.

Windows are keyed on the records' own monotonic ``t`` stamps, not on
the reader's wall clock, so replaying a committed journal produces
byte-identical windows to having followed it live.  A ``clock`` is
injectable only for the live-tail case of flushing a window that
traffic stopped feeding.

The PyTorch package's copy of the JAX package's ``obs/live.py``, on the
port's schema registry: both fold the same journal into the same
windows.  Pure stdlib.
"""

from __future__ import annotations

import math
import time
from typing import Any, Iterable, Iterator

from .schema import names_for

# bucket boundaries grow geometrically by this factor: a reported
# percentile sits at its bucket's geometric midpoint, i.e. within
# sqrt(GROWTH) of the true value — <= ~4% relative error
GROWTH = 1.08


class LatencySketch:
    """Log-bucketed histogram: bounded memory, mergeable, ~4% error.

    ``add`` drops a value into the bucket whose geometric span covers
    it; ``percentile`` walks the buckets and answers with the covering
    bucket's geometric midpoint, clamped to the exact observed min/max
    (so p0/p100 are exact and tiny samples cannot overshoot).  Two
    sketches with the same shape merge by adding bucket counts — the
    property that lets per-window and per-host sketches roll up into
    run-wide percentiles without storing a single raw sample.
    """

    __slots__ = ("growth", "min_value", "_log_g", "buckets", "n",
                 "total", "vmin", "vmax")

    def __init__(self, growth: float = GROWTH,
                 min_value: float = 1e-6):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_g = math.log(self.growth)
        self.buckets: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def _index(self, v: float) -> int:
        if v <= self.min_value:
            return 0
        return 1 + int(math.floor(
            math.log(v / self.min_value) / self._log_g))

    def add(self, v: float) -> None:
        v = float(v)
        if math.isnan(v) or math.isinf(v):
            return
        v = max(v, 0.0)
        i = self._index(v)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        if (other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError("cannot merge sketches of different shape")
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        self.n += other.n
        self.total += other.total
        for v in (other.vmin, other.vmax):
            if v is None:
                continue
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
        return self

    @property
    def mean(self) -> float | None:
        return (self.total / self.n) if self.n else None

    def percentile(self, q: float) -> float | None:
        """Value at quantile ``q`` in [0, 1] (None when empty)."""
        if not self.n:
            return None
        rank = min(self.n, max(1, math.ceil(q * self.n)))
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                if i == 0:
                    v = self.min_value
                else:
                    # geometric midpoint of [g^(i-1), g^i) * min_value
                    v = self.min_value * self.growth ** (i - 0.5)
                return min(max(v, self.vmin), self.vmax)
        return self.vmax  # unreachable; defensive

    def to_json(self) -> dict:
        return {"growth": self.growth, "min_value": self.min_value,
                "n": self.n, "total": self.total,
                "vmin": self.vmin, "vmax": self.vmax,
                "buckets": {str(i): c for i, c in
                            sorted(self.buckets.items())}}

    @classmethod
    def from_json(cls, d: dict) -> "LatencySketch":
        s = cls(growth=d["growth"], min_value=d["min_value"])
        s.n = int(d["n"])
        s.total = float(d["total"])
        s.vmin = d.get("vmin")
        s.vmax = d.get("vmax")
        s.buckets = {int(i): int(c)
                     for i, c in (d.get("buckets") or {}).items()}
        return s


class _Window:
    """One event-time window's accumulators (internal)."""

    def __init__(self, key: int, width_s: float):
        self.key = key
        self.width_s = width_s
        self.ttft = LatencySketch()
        self.itl = LatencySketch()
        self.latency = LatencySketch()
        self.n_done = 0
        self.new_tokens = 0       # from serve.step new_tokens
        self.done_tokens = 0      # fallback: request_done n_new
        self.steps_with_tokens = 0
        self.n_steps = 0
        self.occupancy_sum = 0.0
        self.queued_sum = 0.0
        self.preemptions = 0
        self.cached_tokens = 0
        self.prompt_tokens = 0
        self.drafted = 0
        self.accepted = 0

    def empty(self) -> bool:
        # a window holding serve.step events but zero request_done is
        # NOT empty: it must be emitted with explicit zero throughput
        # (an engine grinding through prefills or a stalled queue is a
        # real zero-tok/s observation, unlike an idle engine)
        return not (self.n_done or self.n_steps or self.preemptions)


def _num(v: Any) -> float | None:
    return float(v) if isinstance(v, (int, float)) else None


class LiveAggregator:
    """Incremental event-time windowing over a journal record stream.

    ``add(record)`` returns the list of windows that record *closed*
    (zero or one in practice: a record belonging to window k+1 seals
    window k).  ``flush()`` seals the in-progress window — the replay
    path calls it once at end-of-file; a live monitor calls it when
    ``stale()`` says traffic stopped mid-window.  Windows that saw no
    serving traffic are never emitted: an idle engine is not a
    zero-throughput SLO violation.
    """

    def __init__(self, window_s: float = 5.0, *,
                 time_field: str = "t",
                 clock=time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self.time_field = time_field
        self.clock = clock
        self._cur: _Window | None = None
        self._last_t: float | None = None
        self._last_seen_clock: float | None = None
        self.windows: list[dict] = []
        # run-wide roll-ups (merged from every window, incl. partial)
        self.ttft_all = LatencySketch()
        self.itl_all = LatencySketch()
        self.latency_all = LatencySketch()
        self.totals = {"n_done": 0, "new_tokens": 0, "preemptions": 0,
                       "n_steps": 0, "occupancy_sum": 0.0}

    # -- folding -------------------------------------------------------------

    def add(self, rec: dict) -> list[dict]:
        t = _num(rec.get(self.time_field))
        name = rec.get("name", "")
        if t is None or not isinstance(name, str):
            return []
        closed: list[dict] = []
        key = int(t // self.window_s)
        if self._cur is None:
            self._cur = _Window(key, self.window_s)
        elif key > self._cur.key:
            w = self._seal()
            if w is not None:
                closed.append(w)
            self._cur = _Window(key, self.window_s)
        self._last_t = t
        self._last_seen_clock = self.clock() if self.clock else None
        self._fold(self._cur, rec, name)
        return closed

    def _fold(self, w: _Window, rec: dict, name: str) -> None:
        # alias-resolved acceptance: the schema registry supplies the
        # deprecated names too, so pre-rename journals still fold
        if name in names_for("serve.request_done"):
            w.n_done += 1
            ttft = _num(rec.get("ttft_s"))
            if ttft is not None:
                w.ttft.add(ttft)
            for itl in (rec.get("itl_s") or ()):
                itl = _num(itl)
                if itl is not None:
                    w.itl.add(itl)
            total = _num(rec.get("total_s"))
            if total is not None:
                w.latency.add(total)
            w.done_tokens += int(_num(rec.get("n_new")) or 0)
            w.cached_tokens += int(_num(rec.get("cached_tokens")) or 0)
            w.prompt_tokens += int(_num(rec.get("n_prompt")) or 0)
        elif name == "serve.step":
            w.n_steps += 1
            occ = _num(rec.get("occupancy"))
            if occ is not None:
                w.occupancy_sum += occ
            w.queued_sum += _num(rec.get("n_queued")) or 0.0
            nt = _num(rec.get("new_tokens"))
            if nt is not None:
                w.new_tokens += int(nt)
                w.steps_with_tokens += 1
        elif name == "serve.preempt":
            w.preemptions += 1
        elif name == "serve.speculate":
            w.drafted += int(_num(rec.get("drafted")) or 0)
            w.accepted += int(_num(rec.get("accepted")) or 0)

    # -- sealing -------------------------------------------------------------

    def _seal(self) -> dict | None:
        w = self._cur
        if w is None or w.empty():
            return None
        # journals without per-step token counts fall back to
        # completion-time attribution (lumpier, still correct in total).
        # Step-only windows (zero completions) emit tokens == 0 — an
        # explicit zero-throughput observation, never a skipped window
        # and never a divide against an empty accumulator.
        tokens = (w.new_tokens if w.steps_with_tokens else w.done_tokens)
        out = {
            "window": w.key,
            "start_s": w.key * self.window_s,
            "end_s": (w.key + 1) * self.window_s,
            "window_s": self.window_s,
            "n_done": w.n_done,
            "n_steps": w.n_steps,
            "new_tokens": tokens,
            "tok_s": tokens / self.window_s,
            "ttft_p50_s": w.ttft.percentile(0.50),
            "ttft_p99_s": w.ttft.percentile(0.99),
            "itl_p50_s": w.itl.percentile(0.50),
            "itl_p99_s": w.itl.percentile(0.99),
            "p50_s": w.latency.percentile(0.50),
            "p99_s": w.latency.percentile(0.99),
            "occupancy": (w.occupancy_sum / w.n_steps
                          if w.n_steps else None),
            "queued_mean": (w.queued_sum / w.n_steps
                            if w.n_steps else None),
            "preemptions": w.preemptions,
            "prefix_hit_rate": (w.cached_tokens / w.prompt_tokens
                                if w.prompt_tokens else None),
            "accept_rate": (w.accepted / w.drafted
                            if w.drafted else None),
        }
        self.windows.append(out)
        self.ttft_all.merge(w.ttft)
        self.itl_all.merge(w.itl)
        self.latency_all.merge(w.latency)
        self.totals["n_done"] += w.n_done
        self.totals["new_tokens"] += tokens
        self.totals["preemptions"] += w.preemptions
        self.totals["n_steps"] += w.n_steps
        self.totals["occupancy_sum"] += w.occupancy_sum
        return out

    def flush(self) -> dict | None:
        """Seal the in-progress window (None when it saw no traffic)."""
        w = self._seal()
        self._cur = None
        return w

    def stale(self, idle_s: float | None = None) -> bool:
        """True when the live tail has gone quiet mid-window: no record
        for ``idle_s`` (default: one window width) on the injected
        clock — the signal to ``flush()`` rather than wait forever for
        a record from the next window to seal this one."""
        if self._cur is None or self._last_seen_clock is None:
            return False
        if self.clock is None:
            return False
        idle = self.window_s if idle_s is None else idle_s
        return (self.clock() - self._last_seen_clock) >= idle

    # -- run-wide view -------------------------------------------------------

    def summary(self) -> dict:
        """Roll-up across every sealed window (sketches merged, totals
        summed) — the whole-journal percentiles the monitor prints."""
        span = None
        if self.windows:
            span = (self.windows[-1]["end_s"]
                    - self.windows[0]["start_s"])
        return {
            "n_windows": len(self.windows),
            "n_done": self.totals["n_done"],
            "new_tokens": self.totals["new_tokens"],
            "n_steps": self.totals["n_steps"],
            "preemptions": self.totals["preemptions"],
            "span_s": span,
            # guarded divides: a run of step-only windows has tokens
            # and steps but possibly zero completions — the roll-up
            # must report explicit zeros, and an all-done-only journal
            # (no serve.step records) must not divide by zero steps
            "tok_s": (self.totals["new_tokens"] / span
                      if span else None),
            "occupancy": (self.totals["occupancy_sum"]
                          / self.totals["n_steps"]
                          if self.totals["n_steps"] else None),
            "ttft_p50_s": self.ttft_all.percentile(0.50),
            "ttft_p99_s": self.ttft_all.percentile(0.99),
            "itl_p50_s": self.itl_all.percentile(0.50),
            "itl_p99_s": self.itl_all.percentile(0.99),
            "p50_s": self.latency_all.percentile(0.50),
            "p99_s": self.latency_all.percentile(0.99),
        }


def aggregate_stream(records: Iterable[dict], *,
                     window_s: float = 5.0,
                     time_field: str = "t") -> Iterator[dict]:
    """Generator over sealed windows of a record stream: lazily folds
    ``records`` (a list or a live :meth:`Journal.follow` tail) and
    yields each window the moment it closes, then the final partial."""
    agg = LiveAggregator(window_s=window_s, time_field=time_field,
                         clock=None)
    for rec in records:
        yield from agg.add(rec)
    last = agg.flush()
    if last is not None:
        yield last
