"""Fleet fault-tolerance policies: circuit breaking, hedging, degrade.

The gateway's failure model has three tiers, cheapest reaction first:

1. **Circuit breaker** (per replica) — a replica that heartbeats but
   makes no forward progress while loaded (a stall: wedged collective,
   livelocked host loop) is OPENED out of the routing set long before
   the autoscaler's SLO windows would notice.  The breaker is the
   classic three-state machine driven by a windowed failure rate: the
   gateway feeds one observation per serving step (progressed / did
   not), the window is pruned on the injected clock, and open →
   half-open → closed transitions are pure functions of (rate, time)
   so a chaos replay reproduces them byte-for-byte.
2. **Hedging** (per request) — a request that has made no token
   progress for ``HedgePolicy.after_s`` (queued too long behind a slow
   replica, or mid-decode on a stalled one) is speculatively
   re-dispatched to a second replica under the SAME rid.
   First-writer-wins: whichever copy finishes first resolves the
   request and the loser is cancelled; the ingress token cursor
   guarantees the merged stream is exactly-once regardless of which
   copy produced which token (greedy decode makes the copies
   content-identical).
3. **Degrade ladder** (fleet-wide) — when the fleet cannot scale its
   way out (sustained breach at ``max_replicas``, or capacity lost to
   failures), the controller walks the gateway down a deterministic
   ladder: disable speculation, tighten admission, shed priority
   classes LOWEST-first (batch before interactive).  Every transition
   journals ``gateway.degrade`` / ``gateway.restore`` so the shed
   history is auditable post-mortem (``tadnn doctor --gateway-dir``).

Everything here is host-side bookkeeping on an injected clock — no
device state, no wall-clock reads, no sleeps.

The PyTorch package's copy of the JAX package's
``inference/gateway/fault.py``; the ingress (:mod:`.ingress`) drives
the breakers, hedging and the ladder.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Per-replica circuit breaker knobs.

    An observation is one gateway step over a LOADED replica: ok when
    the replica advanced (steps counter moved), failure when it did
    not.  The breaker opens when at least ``min_observations`` land
    inside ``window_s`` and the failure fraction reaches
    ``failure_rate``; it half-opens after ``open_s`` and closes again
    after ``clean_s`` without a failure observation.
    """

    window_s: float = 0.25
    min_observations: int = 10
    failure_rate: float = 0.5
    open_s: float = 0.5
    clean_s: float = 0.25


class CircuitBreaker:
    """Three-state (closed/open/half_open) breaker on an injected clock."""

    def __init__(self, name: str, policy: BreakerPolicy, *,
                 clock: Callable[[], float] = time.monotonic,
                 journal=None):
        self.name = name
        self.policy = policy
        self.clock = clock
        self.journal = journal
        self.state = "closed"
        self._window: deque[tuple[float, bool]] = deque()
        self._opened_t: float | None = None
        self._last_failure_t: float | None = None
        self.n_opens = 0
        self.transitions: list[dict] = []

    def _set_state(self, state: str) -> None:
        if state == self.state:
            return
        rec = {"replica": self.name, "from": self.state, "to": state}
        self.state = state
        if state == "open":
            self.n_opens += 1
            self._opened_t = self.clock()
            self._window.clear()
        self.transitions.append(rec)
        if self.journal is not None:
            self.journal.event("gateway.breaker", **rec)

    def observe(self, ok: bool) -> None:
        """One loaded-replica step outcome; prunes the window, then
        applies the state machine."""
        now = self.clock()
        if not ok:
            self._last_failure_t = now
        pol = self.policy
        if self.state == "open":
            return  # open ignores traffic; only time can half-open it
        if self.state == "half_open":
            if not ok:
                self._set_state("open")
            return
        self._window.append((now, ok))
        while self._window and self._window[0][0] < now - pol.window_s:
            self._window.popleft()
        n = len(self._window)
        if n >= pol.min_observations:
            fails = sum(1 for _, o in self._window if not o)
            if fails / n >= pol.failure_rate:
                self._set_state("open")

    def tick(self) -> None:
        """Time-based transitions (call once per gateway step)."""
        now = self.clock()
        pol = self.policy
        if (self.state == "open" and self._opened_t is not None
                and now - self._opened_t >= pol.open_s):
            self._set_state("half_open")
        elif self.state == "half_open":
            last_fail = self._last_failure_t
            if last_fail is None or now - last_fail >= pol.clean_s:
                self._set_state("closed")

    def allow(self) -> bool:
        """May the router place NEW work here?  Half-open admits probe
        traffic — a success observation closes the breaker, a failure
        re-opens it."""
        return self.state != "open"


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Tail-hedging knobs: a request with no token progress for
    ``after_s`` is re-dispatched once to the least-loaded OTHER healthy
    replica; first writer wins and the loser is cancelled."""

    after_s: float = 0.25
    max_hedges_per_request: int = 1


# -- degrade ladder -----------------------------------------------------------
#
# Levels are cumulative and deterministic; shedding walks priority
# classes from the LOWEST (highest numeric value) up, never touching
# class 0 (interactive) until everything below it is gone.

#: level -> fraction of the configured per-tenant queue limit admitted
ADMISSION_FACTOR = {0: 1.0, 1: 0.5, 2: 0.5, 3: 0.25}

MAX_DEGRADE_LEVEL = 3


def shed_threshold(level: int, known_classes: list[int]) -> int | None:
    """The lowest priority VALUE rejected at this degrade level, or
    None when nothing is shed.

    Level 0 and 1 shed nothing (level 1 only disables speculation and
    tightens admission); from level 2 each further level sheds one
    more class from the bottom of ``known_classes``, never shedding
    class 0 — with the default {interactive: 0, batch: 1} table level
    2+ sheds batch and interactive always survives.
    """
    if level < 2:
        return None
    classes = sorted(set(known_classes))
    n_shed = min(level - 1, max(0, len(classes) - 1))
    if n_shed <= 0:
        return None
    return classes[len(classes) - n_shed]


def degrade_effects(level: int, known_classes: list[int]) -> dict:
    """The full knob set at a ladder level (journaled on transition)."""
    level = max(0, min(MAX_DEGRADE_LEVEL, int(level)))
    thr = shed_threshold(level, known_classes)
    return {
        "level": level,
        "speculation": level < 1,
        "admission_factor": ADMISSION_FACTOR[level],
        "shed_threshold": thr,
        "shed_classes": ([c for c in sorted(set(known_classes))
                          if thr is not None and c >= thr]),
    }
