"""Async ingress: HTTP/SSE front door over a replica fleet.

Stdlib only (asyncio + json): the gateway is part of the serving
runtime, not a web-framework dependency.  One process owns N replicas,
a :class:`~.router.Router` placing requests by prefix affinity, and
(optionally) a :class:`~.controller.FleetController` resizing the
fleet against its SLO.  The HTTP layer streams tokens per request as
Server-Sent Events::

    POST /v1/generate        {"prompt": [1,2,3], "max_new_tokens": 16,
                              "tenant": "acme", "priority": "interactive"}
    -> 200 text/event-stream
       data: {"i": 0, "token": 42}
       ...
       data: {"done": true, "rid": 7, "usage": {...}}

Admission control happens BEFORE the scheduler ever sees a request:

- token-bucket rate limit per tenant (429; burst-tolerant, refilled on
  the injected clock);
- bounded in-flight queue per tenant (503 backpressure: a slow tenant
  queues against itself, not the fleet);
- priority classes ("interactive" < "batch") mapped onto
  ``Request.priority``, which the scheduler orders admission by.

Requests then flow through the SAME ``Scheduler``/``admission_plan``
interface and stamp the SAME ``serve.request_done`` spans as the
direct-engine path, so ``obs/live``, ``tadnn monitor`` and ``tadnn
report`` work unchanged on a gateway journal.

The :class:`Gateway` core is sync and clock-injected; the asyncio
server is a thin pump around it.  Tests and the chaos smoke drive
``Gateway.step()`` directly on virtual time — no sockets, no sleeps.

The PyTorch package's copy of the JAX package's
``inference/gateway/ingress.py``.  Its replicas are the port's
:class:`~.router.EngineReplica` (a ``ServeEngine`` whose decode
attention is the paged-attention kernel) or :class:`~.router.SimReplica`;
the HTTP server runs in the caller's event loop, the engines' steps in
that loop's thread.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from typing import Any, Callable, Sequence

from ...obs import journal as journal_mod
from ...obs.journal import Journal
from ..serve.scheduler import Request
from .controller import AutoscalePolicy, FleetController
from .fault import (
    MAX_DEGRADE_LEVEL,
    BreakerPolicy,
    CircuitBreaker,
    HedgePolicy,
    degrade_effects,
)
from .router import NoHealthyReplica, Router

PRIORITY_CLASSES = {"interactive": 0, "batch": 1}


class GatewayError(RuntimeError):
    status = 500
    # advisory back-off (seconds) the HTTP layer maps to a Retry-After
    # header on 429/503 — None means no estimate
    retry_after: float | None = None


class RateLimited(GatewayError):
    """Tenant exceeded its token-bucket rate (HTTP 429)."""
    status = 429


class Saturated(GatewayError):
    """Tenant's in-flight queue is full (HTTP 503 backpressure)."""
    status = 503


class TokenBucket:
    """Classic token bucket on an injected clock: ``rate_per_s``
    sustained, ``burst`` instantaneous."""

    def __init__(self, rate_per_s: float, burst: int, *,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self._last = clock()

    def try_take(self) -> bool:
        now = self.clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def seconds_until_token(self) -> float:
        """Refill time until the next ``try_take`` could succeed —
        the 429 response's Retry-After."""
        now = self.clock()
        tokens = min(self.burst,
                     self.tokens + (now - self._last) * self.rate)
        if tokens >= 1.0 or self.rate <= 0:
            return 0.0
        return (1.0 - tokens) / self.rate


class Gateway:
    """Sync, clock-injected gateway core: admission control, routing,
    fleet stepping, elastic resize.  The asyncio server and the chaos
    smoke are both thin loops over ``submit``/``step``."""

    def __init__(self, replicas: Sequence, *,
                 journal: Journal | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 router: Router | None = None,
                 autoscale: AutoscalePolicy | None = None,
                 make_replica: Callable[[str], Any] | None = None,
                 rate_limit_per_s: float | None = None,
                 burst: int | None = None,
                 queue_limit: int = 64,
                 router_policy: str = "affinity",
                 heartbeat_s: float | None = None,
                 hedge: HedgePolicy | None = None,
                 breaker: BreakerPolicy | None = None,
                 stream_retention: int = 65536,
                 step_costs: tuple[float, float] = (1e-3, 1e-3),
                 traffic_horizon_s: float = 8.0):
        if not replicas:
            raise ValueError("gateway needs at least one replica")
        self.clock = clock
        self.journal = (journal if journal is not None
                        else journal_mod.get_default())
        self.router = router or Router(
            replicas, block_size=replicas[0].block_size,
            policy=router_policy, clock=clock, journal=self.journal)
        self.make_replica = make_replica
        self._next_replica_idx = len(self.router.replicas)
        self.rate_limit_per_s = rate_limit_per_s
        self.burst = burst or (int(rate_limit_per_s * 2)
                               if rate_limit_per_s else 0)
        self.queue_limit = int(queue_limit)
        # (prefill_chunk_s, decode_step_s): the candidate-replay cost
        # model for the controller; SimReplica fleets pass the tick
        self.step_costs = step_costs
        self.traffic_horizon_s = float(traffic_horizon_s)
        self._buckets: dict[str, TokenBucket] = {}
        self._pending: dict[str, int] = {}       # tenant -> in flight
        self._meta: dict[int, dict] = {}         # rid -> bookkeeping
        # gateway-minted request ids: per-gateway, starting at 0, so a
        # virtual-clock scenario journals the SAME rids every run (the
        # scheduler's module-global counter is process-lifetime)
        self._next_rid = 0
        self._submits: deque = deque()           # (t, n_prompt, max_new, n_dec)
        self.n_accepted = 0
        self.n_rejected = 0
        self.n_done = 0
        # -- fault tolerance --------------------------------------------------
        # no heartbeat within this window => the replica is declared
        # dead and its in-flight work fails over (None disables)
        self.heartbeat_s = heartbeat_s
        self.hedge = hedge
        self.breaker_policy = breaker
        self._breakers: dict[str, CircuitBreaker] = {}
        self._replica_marker: dict[str, Any] = {}  # name -> last steps ctr
        if breaker is not None and self.router.gate is None:
            self.router.gate = self._breaker_allows
        # exactly-once token ledger: rid -> every token DELIVERED so
        # far, a monotone cursor over whichever copy of the request is
        # furthest along.  Preemption/failover shrink a copy's
        # out_tokens; the ledger never rolls back, so a resumed stream
        # is deduplicated (greedy recompute re-derives the same ids)
        self._delivered: dict[int, list[int]] = {}
        self._progress_t: dict[int, float] = {}  # rid -> last new token
        self._done_rids: deque = deque()
        self.stream_retention = int(stream_retention)
        self._rid_alias: dict[int, int] = {}     # engine hedge rid map
        self._orphans: list[Request] = []        # awaiting any replica
        self.n_failovers = 0
        self.n_hedges = 0
        self.n_hedge_wins = 0
        # degraded-mode state (fault.degrade_effects): level 0 = normal
        self.degrade_level = 0
        self.speculation_enabled = True
        self._admission_factor = 1.0
        self._shed_threshold: int | None = None
        self.controller = (FleetController(self, autoscale,
                                           journal=self.journal)
                           if autoscale is not None else None)
        if self.controller is not None:
            self.journal.subscribe(self.controller.offer)

    # -- admission -----------------------------------------------------------

    def _bucket(self, tenant: str) -> TokenBucket | None:
        if not self.rate_limit_per_s:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                self.rate_limit_per_s, self.burst, clock=self.clock)
        return b

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               tenant: str = "default",
               priority: int | str = "interactive",
               eos_id: int | None = None,
               n_decode: int | None = None) -> Request:
        """Admission-check, route, and queue one request.  Raises
        :class:`RateLimited` / :class:`Saturated` with the HTTP status
        the server maps them to; both are journaled so rejected load is
        visible in the report."""
        if isinstance(priority, str):
            if priority not in PRIORITY_CLASSES:
                raise ValueError(
                    f"unknown priority class {priority!r} "
                    f"(known: {sorted(PRIORITY_CLASSES)})")
            priority = PRIORITY_CLASSES[priority]
        # traffic is recorded at OFFER time, before admission: the
        # controller plans capacity against what clients are asking
        # for — planning against post-throttle throughput is the
        # classic autoscaler trap (a saturated fleet rejects its way
        # to a "healthy" accepted rate and never scales)
        self._submits.append((self.clock(), len(prompt),
                              int(max_new_tokens),
                              int(n_decode or max_new_tokens)))
        if (self._shed_threshold is not None
                and int(priority) >= self._shed_threshold):
            self.n_rejected += 1
            retry = self._queue_drain_estimate()
            self.journal.event("gateway.reject", kind="degraded",
                              tenant=tenant, priority=int(priority),
                              level=self.degrade_level,
                              retry_after=round(retry, 6))
            err = Saturated(
                f"priority class {int(priority)} shed at degrade "
                f"level {self.degrade_level}")
            err.retry_after = retry
            raise err
        bucket = self._bucket(tenant)
        if bucket is not None and not bucket.try_take():
            self.n_rejected += 1
            retry = bucket.seconds_until_token()
            self.journal.event("gateway.reject", kind="rate_limit",
                              tenant=tenant,
                              retry_after=round(retry, 6))
            err = RateLimited(f"tenant {tenant!r} over rate limit")
            err.retry_after = retry
            raise err
        limit = max(1, int(self.queue_limit * self._admission_factor))
        if self._pending.get(tenant, 0) >= limit:
            self.n_rejected += 1
            retry = self._queue_drain_estimate()
            self.journal.event("gateway.reject", kind="backpressure",
                              tenant=tenant,
                              pending=self._pending[tenant],
                              retry_after=round(retry, 6))
            err = Saturated(
                f"tenant {tenant!r} has {self._pending[tenant]} "
                f"requests in flight (limit {limit})")
            err.retry_after = retry
            raise err
        replica = self.router.route(prompt)
        rid = self._next_rid
        self._next_rid += 1
        req = replica.submit(prompt, max_new_tokens, eos_id=eos_id,
                             priority=int(priority), n_decode=n_decode,
                             rid=rid)
        if req.rid != rid:
            # EngineReplica mints its own rids; alias them back so the
            # ledger, hedging and failover all key on the gateway rid
            self._rid_alias[req.rid] = rid
        self._pending[tenant] = self._pending.get(tenant, 0) + 1
        self._meta[rid] = {"tenant": tenant, "replica": replica,
                           "n_decode": n_decode, "req": req,
                           "hedge": None, "n_hedges": 0}
        self._delivered[rid] = []
        self._progress_t[rid] = self.clock()
        self.n_accepted += 1
        self.journal.event("gateway.request", rid=rid,
                           tenant=tenant, priority=int(priority),
                           replica=replica.name, n_prompt=len(prompt))
        return req

    def _queue_drain_estimate(self) -> float:
        """Advisory Retry-After for 503s: pending work / fleet decode
        throughput, floored so clients never hot-loop."""
        pending = sum(self._pending.values())
        slots = sum(r.n_slots for r in self.active_replicas()) or 1
        decode_mean = 8.0
        if self._submits:
            decode_mean = (sum(s[3] for s in self._submits)
                           / len(self._submits))
        est = pending * decode_mean * self.step_costs[1] / slots
        return max(0.05, est)

    # -- serving loop --------------------------------------------------------

    def active_replicas(self) -> list:
        return [r for r in self.router.replicas
                if not r.retired and not r.draining]

    def n_active_replicas(self) -> int:
        return len(self.active_replicas())

    def idle(self) -> bool:
        return all(r.idle() for r in self.active_replicas())

    def step(self) -> list[Request]:
        """Advance every active replica one iteration; returns the
        requests that finished this step (pending counts released).
        The journal tap feeds the controller as records are written —
        a breach detected in this step's windows can resize the fleet
        before the next step.

        Fault-tolerance order matters: harvest tokens into the ledger
        BEFORE declaring anything dead (so failover never loses
        already-computed tokens), then breakers, then heartbeat
        failover, then hedging, then resolution."""
        self._place_orphans()
        finished: list[Request] = []
        for r in list(self.router.replicas):
            if r.retired:
                continue
            r.step()
            finished.extend(r.take_finished())
        now = self.clock()
        self._harvest(now)
        if self.breaker_policy is not None:
            self._feed_breakers(now)
        if self.heartbeat_s is not None:
            for r in list(self.router.replicas):
                if r.retired or r.draining:
                    continue
                if now - r.last_step_t > self.heartbeat_s:
                    self._failover(r, reason="heartbeat_expired")
        if self.hedge is not None:
            self._maybe_hedge(now)
        return self._resolve(finished)

    # -- fault tolerance -----------------------------------------------------

    def _gw_rid(self, rid: int) -> int:
        return self._rid_alias.get(rid, rid)

    def _breaker(self, name: str) -> CircuitBreaker:
        br = self._breakers.get(name)
        if br is None:
            br = self._breakers[name] = CircuitBreaker(
                name, self.breaker_policy, clock=self.clock,
                journal=self.journal)
        return br

    def _breaker_allows(self, replica) -> bool:
        br = self._breakers.get(replica.name)
        return br is None or br.allow()

    def _harvest(self, now: float) -> None:
        """Advance every rid's delivered-token ledger to the furthest
        copy.  The ledger is the exactly-once cursor: it only ever
        extends, so a preempted/failed-over copy whose out_tokens
        shrank is waited out (greedy recompute re-derives the same
        ids) and a hedged copy merges losslessly."""
        for rid, meta in self._meta.items():
            ledger = self._delivered.get(rid)
            if ledger is None:
                ledger = self._delivered[rid] = []
            best = meta["req"].out_tokens
            h = meta.get("hedge")
            if h is not None and len(h["req"].out_tokens) > len(best):
                best = h["req"].out_tokens
            if len(best) > len(ledger):
                ledger.extend(best[len(ledger):])
                self._progress_t[rid] = now

    def _feed_breakers(self, now: float) -> None:
        """One observation per loaded replica per step: ok iff its
        steps counter advanced.  A stalled-but-heartbeating replica
        accumulates failures and is opened out of routing before the
        heartbeat or the autoscaler can react."""
        for r in self.router.replicas:
            if r.retired:
                continue
            br = self._breaker(r.name)
            marker = getattr(r, "steps", None)
            if not getattr(r, "idle", lambda: True)():
                prev = self._replica_marker.get(r.name)
                br.observe(marker is None or marker != prev)
            self._replica_marker[r.name] = marker
            br.tick()

    def _failover(self, replica, *, reason: str) -> None:
        """Declare ``replica`` dead: drain its in-flight work through
        the scheduler's class-preserving requeue and re-route every
        request under its ORIGINAL rid.  Prefill restarts cheaply on
        the survivors via prefix-cache hits; the ledger guarantees the
        resumed stream is exactly-once."""
        salvaged = replica.drain()
        self.router.forget(replica.name)
        self.n_failovers += 1
        self.journal.event(
            "gateway.failover", kind="redispatch",
            replica=replica.name, reason=reason,
            n_requeued=len(salvaged),
            rids=[self._gw_rid(r.rid) for r in salvaged])
        self._redispatch(salvaged)

    def _redispatch(self, reqs: Sequence[Request], *,
                    quiet: bool = False) -> None:
        for req in reqs:
            rid = self._gw_rid(req.rid)
            meta = self._meta.get(rid)
            if meta is None:
                continue
            h = meta.get("hedge")
            if h is not None and req is h["req"]:
                # the dead replica held the hedge CLONE — drop it, the
                # primary copy elsewhere is still live
                meta["hedge"] = None
                if req.rid != rid:
                    self._rid_alias.pop(req.rid, None)
                continue
            try:
                target = self.router.route(req.prompt)
            except NoHealthyReplica:
                self._orphans.append(req)
                if not quiet:
                    self.journal.event("gateway.failover",
                                       kind="parked", rid=rid)
                continue
            target.resubmit(req, n_decode=meta.get("n_decode"))
            meta["replica"] = target

    def _place_orphans(self) -> None:
        """Retry requests salvaged while no replica was healthy."""
        if not self._orphans:
            return
        orphans, self._orphans = self._orphans, []
        self._redispatch(orphans, quiet=True)

    def _maybe_hedge(self, now: float) -> None:
        """Re-dispatch no-progress requests to a second replica under
        the same rid; first writer wins at resolve time."""
        pol = self.hedge
        for rid, meta in list(self._meta.items()):
            if meta.get("hedge") is not None:
                continue
            if meta["n_hedges"] >= pol.max_hedges_per_request:
                continue
            if now - self._progress_t.get(rid, now) < pol.after_s:
                continue
            current = meta["replica"]
            candidates = [r for r in self.router.healthy()
                          if r is not current]
            if not candidates:
                continue
            target = min(candidates, key=lambda r: r.load())
            req = meta["req"]
            clone = target.submit(
                list(req.prompt), req.max_new_tokens,
                eos_id=req.eos_id, priority=req.priority,
                n_decode=meta.get("n_decode"), rid=rid)
            if clone.rid != rid:
                self._rid_alias[clone.rid] = rid
            meta["hedge"] = {"req": clone, "replica": target}
            meta["n_hedges"] += 1
            self.n_hedges += 1
            self._progress_t[rid] = now
            self.journal.event(
                "gateway.hedge", kind="dispatch", rid=rid,
                replica=target.name, primary=current.name)

    def _resolve(self, finished: list[Request]) -> list[Request]:
        """Resolution with first-writer-wins hedge semantics: only the
        first copy of a rid to finish counts; the loser is cancelled
        on its replica and its finish (if it races in the same step)
        is ignored."""
        out: list[Request] = []
        for req in finished:
            rid = self._gw_rid(req.rid)
            meta = self._meta.pop(rid, None)
            if meta is None:
                continue  # the losing copy of an already-resolved rid
            h = meta.get("hedge")
            if h is not None:
                winner_is_hedge = req is h["req"]
                loser_req = meta["req"] if winner_is_hedge else h["req"]
                loser_rep = (meta["replica"] if winner_is_hedge
                             else h["replica"])
                if not getattr(loser_rep, "retired", False):
                    loser_rep.cancel(loser_req.rid)
                if winner_is_hedge:
                    self.n_hedge_wins += 1
                self.journal.event(
                    "gateway.hedge", kind="win", rid=rid,
                    winner=("hedge" if winner_is_hedge else "primary"))
            ledger = self._delivered.get(rid)
            if ledger is not None and len(req.out_tokens) > len(ledger):
                ledger.extend(req.out_tokens[len(ledger):])
            t = meta["tenant"]
            self._pending[t] = max(0, self._pending.get(t, 1) - 1)
            self.n_done += 1
            self._done_rids.append(rid)
            out.append(req)
        while len(self._done_rids) > self.stream_retention:
            old = self._done_rids.popleft()
            self._delivered.pop(old, None)
            self._progress_t.pop(old, None)
            # aliases (engine-minted rids) live until their stream is
            # trimmed so the HTTP pump can map finished requests back
            stale = [k for k, v in self._rid_alias.items() if v == old]
            for k in stale:
                del self._rid_alias[k]
        return out

    def delivered(self, rid: int) -> list[int]:
        """The exactly-once token stream for ``rid`` (a copy)."""
        return list(self._delivered.get(rid, ()))

    # -- degraded modes ------------------------------------------------------

    def set_degrade(self, level: int, *, reason: str = "") -> None:
        """Walk the degrade ladder (idempotent, journaled): level 1
        disables speculation and halves admission; level 2+ sheds
        priority classes lowest-first, never interactive."""
        level = max(0, min(MAX_DEGRADE_LEVEL, int(level)))
        if level == self.degrade_level:
            return
        rising = level > self.degrade_level
        effects = degrade_effects(
            level, list(PRIORITY_CLASSES.values()))
        self._apply_speculation(effects["speculation"])
        self._admission_factor = effects["admission_factor"]
        self._shed_threshold = effects["shed_threshold"]
        prev = self.degrade_level
        self.degrade_level = level
        self.journal.event(
            "gateway.degrade" if rising else "gateway.restore",
            level=level, prev=prev, reason=reason, **{
                k: v for k, v in effects.items() if k != "level"})

    def _apply_speculation(self, enabled: bool) -> None:
        if enabled == self.speculation_enabled:
            return
        self.speculation_enabled = enabled
        for r in self.router.replicas:
            engine = getattr(r, "engine", None)
            if engine is None or not hasattr(engine, "speculative"):
                continue
            if not enabled:
                r._stashed_speculative = engine.speculative
                engine.speculative = 0
            else:
                engine.speculative = getattr(
                    r, "_stashed_speculative", engine.speculative)

    def run_until_idle(self, *, max_steps: int = 100_000
                       ) -> list[Request]:
        out: list[Request] = []
        for _ in range(max_steps):
            if self.idle():
                break
            out.extend(self.step())
        return out

    # -- elastic resize ------------------------------------------------------

    def replica_shape(self) -> dict:
        """The active replicas' scheduling shape, for the controller's
        candidate replay (homogeneous fleet assumed)."""
        active = self.active_replicas()
        # after a failover storm the active set can momentarily be
        # empty; any replica's shape works (homogeneous fleet)
        r = active[0] if active else self.router.replicas[0]
        return {
            "n_slots": r.n_slots,
            "block_size": r.block_size,
            "max_len": r.max_len,
            "admission": getattr(r, "admission", "reserve"),
            "prefill_chunk": getattr(r, "prefill_chunk", 32) or 32,
            "prefill_chunks_per_step": getattr(
                r, "prefill_chunks_per_step", 1),
            "prefix_cache": getattr(r, "prefix_cache", None) is not None,
            "prefill_chunk_s": self.step_costs[0],
            "decode_step_s": self.step_costs[1],
        }

    def traffic_snapshot(self) -> dict:
        """The measured arrival process over the trailing horizon —
        what the controller simulates candidate fleets against."""
        now = self.clock()
        horizon = self.traffic_horizon_s
        while self._submits and self._submits[0][0] < now - horizon:
            self._submits.popleft()
        subs = list(self._submits)
        if not subs:
            return {"rate_per_s": 0.0, "prompt_mean": 1, "max_new": 1,
                    "decode_mean": 1, "shared_prefix": 0}
        span = max(now - subs[0][0], 1e-9)
        return {
            "rate_per_s": len(subs) / span,
            "prompt_mean": sum(s[1] for s in subs) / len(subs),
            "max_new": max(s[2] for s in subs),
            "decode_mean": sum(s[3] for s in subs) / len(subs),
            "shared_prefix": 0,
        }

    def scale_to(self, n: int, *, reason: str = "manual") -> None:
        """Resize the active fleet to ``n`` replicas.

        Scale-out: the ``make_replica`` factory builds each new replica
        (a factory may prewarm it and mark it ``prewarmed``, which the
        scale record carries).  Scale-in:
        retire the youngest replicas, drain each through the
        scheduler's requeue path, forget its router claims, and
        resubmit its requests through the router."""
        n = max(1, int(n))
        while self.n_active_replicas() < n:
            if self.make_replica is None:
                self.journal.event("gateway.scale", kind="blocked",
                                   reason="no replica factory")
                break
            name = f"replica{self._next_replica_idx}"
            self._next_replica_idx += 1
            replica = self.make_replica(name)
            self.router.replicas.append(replica)
            self.journal.event(
                "gateway.scale", kind="out", replica=name,
                reason=reason, n_replicas=self.n_active_replicas(),
                prewarmed=bool(getattr(replica, "prewarmed", False)))
        while self.n_active_replicas() > n:
            victim = self.active_replicas()[-1]
            drained = victim.drain()
            self.router.forget(victim.name)
            self.journal.event(
                "gateway.scale", kind="in", replica=victim.name,
                reason=reason, requeued=len(drained),
                n_replicas=self.n_active_replicas())
            self._redispatch(drained)

    # -- summary -------------------------------------------------------------

    def summary(self) -> dict:
        prefix = [r.prefix_stats() for r in self.router.replicas]
        out = {
            "n_replicas": self.n_active_replicas(),
            "accepted": self.n_accepted,
            "rejected": self.n_rejected,
            "done": self.n_done,
            "router": self.router.stats(),
            "prefix_hit_tokens": sum(p["hit_tokens"] for p in prefix),
            "prefix_queries": sum(p["queries"] for p in prefix),
            "prefix_hit_requests": sum(p["hit_requests"]
                                       for p in prefix),
            "failovers": self.n_failovers,
            "hedges": self.n_hedges,
            "hedge_wins": self.n_hedge_wins,
            "degrade_level": self.degrade_level,
            "parked": len(self._orphans),
        }
        if self._breakers:
            out["breakers"] = {name: br.state
                               for name, br in self._breakers.items()}
        if self.controller is not None:
            out["controller"] = self.controller.stats()
        return out


# -- asyncio HTTP/SSE layer ---------------------------------------------------


def _sse(data: dict) -> bytes:
    return f"data: {json.dumps(data)}\n\n".encode()


def _http_response(status: int, body: dict,
                   headers: dict[str, str] | None = None) -> bytes:
    payload = json.dumps(body).encode()
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              429: "Too Many Requests",
              503: "Service Unavailable"}.get(status, "Error")
    extra = "".join(f"{k}: {v}\r\n"
                    for k, v in (headers or {}).items())
    return (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"{extra}"
            f"Connection: close\r\n\r\n").encode() + payload


def _retry_headers(e: GatewayError) -> dict[str, str] | None:
    """RFC 7231 Retry-After (integer seconds, ceil, min 1) for
    throttle/backpressure responses carrying an estimate."""
    if e.retry_after is None:
        return None
    return {"Retry-After": str(max(1, int(-(-e.retry_after // 1))))}


_SSE_HEADER = (b"HTTP/1.1 200 OK\r\n"
               b"Content-Type: text/event-stream\r\n"
               b"Cache-Control: no-cache\r\n"
               b"Connection: close\r\n\r\n")


class HttpIngress:
    """Asyncio server pumping one :class:`Gateway`.

    A background task steps the gateway whenever any replica has work
    and fans fresh tokens out to per-request asyncio queues; request
    handlers await their queue and write SSE frames.  Everything runs
    on one event loop — the gateway core is not thread-safe and never
    needs to be."""

    def __init__(self, gateway: Gateway, *, host: str = "127.0.0.1",
                 port: int = 0, poll_s: float = 0.005):
        self.gateway = gateway
        self.host = host
        self.port = port
        self.poll_s = poll_s
        self._server: asyncio.AbstractServer | None = None
        self._pump_task: asyncio.Task | None = None
        self._streams: dict[int, asyncio.Queue] = {}
        self._sent: dict[int, int] = {}
        self._stopping = False

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.create_task(self._pump())

    async def stop(self) -> None:
        self._stopping = True
        if self._pump_task is not None:
            await self._pump_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- pump ----------------------------------------------------------------

    async def _pump(self) -> None:
        while not self._stopping:
            if self.gateway.idle() and not self._streams:
                await asyncio.sleep(self.poll_s)
                continue
            finished = (self.gateway.step()
                        if not self.gateway.idle() else [])
            gw = self.gateway
            for rid, q in list(self._streams.items()):
                # the gateway's delivered-token ledger IS the stream:
                # it survives preemption, failover and hedging and
                # only ever extends, so emitting everything past our
                # high-water mark is exactly-once by construction
                ledger = gw._delivered.get(rid)
                if ledger is None:
                    continue
                sent = self._sent.get(rid, 0)
                for i in range(sent, len(ledger)):
                    q.put_nowait({"i": i, "token": ledger[i]})
                self._sent[rid] = max(sent, len(ledger))
            for req in finished:
                rid = gw._gw_rid(req.rid)
                q = self._streams.get(rid)
                if q is not None:
                    total = (req.t_done - req.t_submit
                             if req.t_done is not None else None)
                    q.put_nowait({
                        "done": True, "rid": rid,
                        "usage": {"n_prompt": req.n_prompt,
                                  "n_new": req.n_generated,
                                  "cached_tokens": req.cached_tokens,
                                  "preempted": req.preempted,
                                  "total_s": total}})
            await asyncio.sleep(0)

    # -- connection handling -------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            await self._handle_inner(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_inner(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        request_line = (await reader.readline()).decode("latin-1")
        parts = request_line.split()
        if len(parts) < 2:
            return
        method, path = parts[0], parts[1]
        headers: dict[str, str] = {}
        while True:
            line = (await reader.readline()).decode("latin-1").strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        if method == "GET" and path == "/healthz":
            gw = self.gateway
            writer.write(_http_response(200, {
                "ok": True, **gw.summary()}))
            await writer.drain()
            return
        if method != "POST" or path != "/v1/generate":
            writer.write(_http_response(404, {"error": "not found"}))
            await writer.drain()
            return
        n = int(headers.get("content-length", 0))
        body = await reader.readexactly(n) if n else b"{}"
        try:
            payload = json.loads(body)
            prompt = [int(t) for t in payload["prompt"]]
            max_new = int(payload.get("max_new_tokens", 16))
        except (ValueError, KeyError, TypeError) as e:
            writer.write(_http_response(400, {"error": str(e)}))
            await writer.drain()
            return
        try:
            req = self.gateway.submit(
                prompt, max_new,
                tenant=str(payload.get("tenant", "default")),
                priority=payload.get("priority", "interactive"),
                eos_id=payload.get("eos_id"))
        except (RateLimited, Saturated) as e:
            writer.write(_http_response(e.status, {"error": str(e)},
                                        headers=_retry_headers(e)))
            await writer.drain()
            return
        except (NoHealthyReplica, ValueError) as e:
            writer.write(_http_response(503, {"error": str(e)}))
            await writer.drain()
            return
        # key the stream by the GATEWAY rid (engines mint their own;
        # the ledger, failover and hedging all speak gateway rids)
        rid = self.gateway._gw_rid(req.rid)
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        self._sent[rid] = 0
        writer.write(_SSE_HEADER)
        await writer.drain()
        try:
            while True:
                item = await q.get()
                writer.write(_sse(item))
                await writer.drain()
                if item.get("done"):
                    break
        finally:
            self._streams.pop(rid, None)
            self._sent.pop(rid, None)


async def serve_forever(gateway: Gateway, *, host: str = "127.0.0.1",
                        port: int = 8080) -> None:
    """Run the ingress until cancelled (the CLI's --port mode)."""
    ingress = HttpIngress(gateway, host=host, port=port)
    await ingress.start()
    try:
        await asyncio.Event().wait()
    finally:
        await ingress.stop()


def sse_generate(host: str, port: int, payload: dict, *,
                 timeout: float = 60.0,
                 on_event: Callable[[dict], None] | None = None
                 ) -> list[dict]:
    """Blocking SSE client (stdlib http.client): POST a generate
    request, return every event frame.  Bench and tests drive real
    HTTP through this.  ``on_event`` sees each frame as it arrives (a
    client's clock for TTFT).  A refusal raises :class:`GatewayError`
    carrying the response's ``status`` and its Retry-After seconds as
    ``retry_after``."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    body = json.dumps(payload)
    conn.request("POST", "/v1/generate", body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        data = resp.read().decode()
        retry = resp.getheader("Retry-After")
        conn.close()
        err = GatewayError(f"HTTP {resp.status}: {data}")
        err.status = resp.status
        err.retry_after = float(retry) if retry is not None else None
        raise err
    events: list[dict] = []
    buf = ""
    while True:
        # read1: what has arrived, without waiting for a full buffer,
        # so a frame is seen when it is sent
        chunk = resp.read1(4096)
        if not chunk:
            break
        buf += chunk.decode()
        while "\n\n" in buf:
            frame, _, buf = buf.partition("\n\n")
            for line in frame.splitlines():
                if line.startswith("data: "):
                    events.append(json.loads(line[6:]))
                    if on_event is not None:
                        on_event(events[-1])
            if events and events[-1].get("done"):
                conn.close()
                return events
    conn.close()
    return events
