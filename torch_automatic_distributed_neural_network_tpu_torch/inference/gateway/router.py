"""Multi-replica front: prefix-affinity routing over serving replicas.

One ``ServeEngine`` is one replica — its paged pool, radix index and
scheduler are private.  A fleet of N replicas therefore has N disjoint
prefix caches, and WHERE a request lands decides whether its shared
preamble is a hit or a cold re-prefill.  The router's job is to make
that placement content-aware: requests are keyed by the SAME chained
block content hashes the radix index uses (``prefix_cache.
block_hashes``), and each hash key remembers which replica first
prefilled it.  A new request walks its own keys front-to-back and goes
to the replica owning its DEEPEST indexed prefix — shared-prefix
traffic piles onto the replica where its KV already lives, unique
traffic falls through to least-loaded.  This is the standard
cache-aware routing result (e.g. SGLang's router): affinity beats
round-robin/least-loaded on hit rate precisely when traffic is
prefix-heavy, which is what production multi-tenant mixes are.

Affinity yields to load: when the owning replica's queue is more than
``imbalance_factor``× the least-loaded replica's (plus its slot count,
so small absolute differences never trigger), the request falls back
to least-loaded — a hot system prompt must not starve the rest of the
fleet behind one replica.

Two replica flavors, one protocol (submit/step/load/drain/idle):

- :class:`EngineReplica` wraps a real :class:`ServeEngine` (the
  port's, its decode attention on the paged-attention kernel).
- :class:`SimReplica` is the discrete-event twin: the REAL
  ``Scheduler`` + ``PrefixCache`` + ``BlockAllocator`` on an injected
  virtual clock with modeled step costs, emitting the same
  ``serve.step`` / ``serve.request_done`` / ``serve.prefix`` journal
  records as the engine, one iteration a call so N replicas interleave
  under one loop — no device, no sleeps, byte-replayable.

The PyTorch package's copy of the JAX package's
``inference/gateway/router.py``, on the port's ``kv_pool``,
``prefix_cache`` and ``scheduler``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

from ..serve.kv_pool import BlockAllocator, blocks_for_tokens
from ..serve.prefix_cache import PrefixCache, block_hashes
from ..serve.scheduler import Request, Scheduler


class NoHealthyReplica(RuntimeError):
    """Every replica is draining, retired, or heartbeat-stale."""


class SimReplica:
    """Virtual-time serving replica: real scheduling, modeled compute.

    Runs the serving replay's phases (evict → admit → prefill chunk →
    decode), but steps ONE iteration per call
    so a gateway can interleave many replicas and inject traffic
    between steps.  Token values are emulated (EOS exactly at each
    request's ``n_decode``); timestamps come from the shared injected
    clock, which the gateway advances between ticks.
    """

    def __init__(self, name: str, *, n_slots: int = 4,
                 block_size: int = 8, max_len: int = 256,
                 num_blocks: int | None = None,
                 admission: str = "reserve",
                 prefill_chunk: int = 8,
                 prefill_chunks_per_step: int = 1,
                 prefix_cache: bool = True,
                 prefix_ttl_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 journal=None):
        self.name = name
        self.clock = clock
        self.journal = journal
        self.n_slots = int(n_slots)
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        self.admission = admission
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_chunks_per_step = int(prefill_chunks_per_step)
        self.prefix_ttl_s = prefix_ttl_s
        if num_blocks is None:
            num_blocks = (n_slots
                          * blocks_for_tokens(max_len, block_size) + 1)
        self.allocator = BlockAllocator(num_blocks)
        self.prefix_cache = (
            PrefixCache(block_size=block_size, allocator=self.allocator,
                        clock=clock, journal=journal)
            if prefix_cache else None)
        self.scheduler = Scheduler(
            n_slots=n_slots, allocator=self.allocator,
            block_size=block_size, admission=admission,
            prefix_cache=self.prefix_cache, clock=clock)
        self._prefill_pos: dict[int, int] = {}
        self._n_decode: dict[int, int] = {}
        self.finished: list[Request] = []
        self._taken = 0  # finished-list cursor for take_finished
        self.draining = False
        self.retired = False
        # chaos fault state: a dead replica stops heartbeating (the
        # gateway's failover trigger); a stalled one heartbeats but
        # never advances (the circuit breaker's target); slow_factor n
        # makes only every n-th step do work (the hedging target)
        self.alive = True
        self.stalled = False
        self.slow_factor = 1
        self._slow_phase = 0
        self.last_step_t = clock()
        self.steps = 0
        self.prompt_tokens = 0

    # -- protocol ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: int | None = 0, priority: int = 0,
               n_decode: int | None = None,
               rid: int | None = None) -> Request:
        """Queue one request.  ``n_decode`` is the emulated true decode
        length (EOS emitted there); defaults to the full budget.
        ``rid`` lets the gateway mint ids itself — the module-global
        rid counter is process-lifetime, which would make two chaos
        runs in one process journal different ids."""
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} "
                f"exceeds replica max_len {self.max_len}")
        kw = {} if rid is None else {"rid": int(rid)}
        req = Request(prompt=list(map(int, prompt)),
                      max_new_tokens=int(max_new_tokens),
                      eos_id=eos_id, priority=int(priority), **kw)
        # the dataclass stamps wall time; this replica lives on the
        # injected clock
        req.t_submit = self.clock()
        self._n_decode[req.rid] = int(n_decode or max_new_tokens)
        self.prompt_tokens += len(prompt)
        self.scheduler.submit(req)
        return req

    def resubmit(self, req: Request, *,
                 n_decode: int | None = None) -> Request:
        """Re-queue a request drained off a retiring replica: keeps its
        identity (rid, t_submit, priority) so the request's span still
        measures from ORIGINAL submission — a scale-in must show up in
        the victim requests' latency, not hide it."""
        self._n_decode[req.rid] = int(n_decode or req.max_new_tokens)
        self.scheduler.submit(req)
        return req

    def load(self) -> int:
        return self.scheduler.n_queued + self.scheduler.n_active

    def idle(self) -> bool:
        return self.scheduler.idle()

    def take_finished(self) -> list[Request]:
        out = self.finished[self._taken:]
        self._taken = len(self.finished)
        return out

    # -- fault injection / recovery ------------------------------------------

    def kill(self) -> None:
        """Hard-kill: the replica stops stepping AND stops advancing
        its heartbeat, so the gateway's expiry check sees it die."""
        self.alive = False

    def cancel(self, rid: int) -> bool:
        """Remove one request (by rid) from this replica without
        journaling a completion — the hedge loser / stale-copy path.
        Queue first, then slots (blocks freed, no request_done span).
        Returns False when no copy of ``rid`` is resident here."""
        sched = self.scheduler
        for r in list(sched.queue):
            if r.rid == rid:
                sched.queue.remove(r)
                self._n_decode.pop(rid, None)
                return True
        for s in range(self.n_slots):
            r = sched.slots[s]
            if r is not None and r.rid == rid:
                sched.evict(s)
                self._n_decode.pop(rid, None)
                self._prefill_pos.pop(rid, None)
                return True
        return False

    # -- one serving iteration ----------------------------------------------

    def _emit(self, req: Request) -> None:
        eos_at = self._n_decode.get(req.rid, req.max_new_tokens)
        req.out_tokens.append(
            0 if req.n_generated + 1 >= eos_at else 1)
        req.token_walls.append(self.clock())

    def _finish(self, req: Request) -> None:
        self._n_decode.pop(req.rid, None)
        self._prefill_pos.pop(req.rid, None)
        self.finished.append(req)
        if self.journal is None:
            return
        itl = [b - a for a, b in zip(req.token_walls,
                                     req.token_walls[1:])]
        total = (req.t_done - req.t_submit
                 if req.t_done is not None else None)
        self.journal.event(
            "serve.request_done", rid=req.rid, replica=self.name,
            n_prompt=req.n_prompt, n_new=req.n_generated,
            queue_s=(req.t_admit - req.t_submit
                     if req.t_admit is not None else None),
            total_s=total,
            tokens_per_s=(req.n_generated / total
                          if total else None),
            preempted=req.preempted,
            ttft_s=(req.t_first_token - req.t_submit
                    if req.t_first_token is not None else None),
            itl_s=itl,
            itl_mean_s=(sum(itl) / len(itl) if itl else None),
            cached_tokens=req.cached_tokens,
            prefill_chunks=req.prefill_chunks, lost_s=req.lost_s)

    def step(self) -> int:
        """One iteration: evict finished, admit, advance prefill
        chunks, decode every running slot.  Returns tokens emitted.
        Journals ``serve.step`` only when there was work — an idle
        replica is silent, like an idle engine."""
        if not self.alive:
            return 0  # dead: no heartbeat, no progress
        sched = self.scheduler
        self.last_step_t = self.clock()
        if self.stalled:
            return 0  # wedged: heartbeats but never advances
        if self.slow_factor > 1:
            self._slow_phase = (self._slow_phase + 1) % self.slow_factor
            if self._slow_phase != 0:
                return 0
        if sched.idle():
            return 0
        new_tokens = 0
        for s in range(self.n_slots):
            req = sched.slots[s]
            if (req is not None and req.state == "running"
                    and req.finished()):
                self._finish(sched.evict(s))
        step_pf = 0
        for slot, req in sched.admit():
            if req.cached_tokens and self.journal is not None:
                self.journal.event(
                    "serve.prefix", kind="match", rid=req.rid,
                    replica=self.name, hit=True,
                    cached_tokens=req.cached_tokens,
                    cached_blocks=req.cached_blocks)
            req.state = "prefilling"
            self._prefill_pos[req.rid] = req.cached_tokens
        started: set[int] = set()
        for slot, req in sched.prefill_plan(self.prefill_chunks_per_step):
            pos = self._prefill_pos[req.rid]
            pos += min(self.prefill_chunk, req.n_prompt - pos)
            self._prefill_pos[req.rid] = pos
            req.prefill_chunks += 1
            step_pf += 1
            if pos >= req.n_prompt:
                del self._prefill_pos[req.rid]
                if self.prefix_cache is not None:
                    n_pub = req.n_prompt // self.block_size
                    new = self.prefix_cache.insert(
                        req.prompt[:n_pub * self.block_size],
                        req.blocks[:n_pub], ttl_s=self.prefix_ttl_s)
                    if new and self.journal is not None:
                        self.journal.event(
                            "serve.prefix", kind="publish",
                            rid=req.rid, replica=self.name,
                            n_blocks=new)
                self._emit(req)
                req.t_first_token = self.clock()
                req.state = "running"
                started.add(req.rid)
                new_tokens += 1
                if req.finished():
                    self._finish(sched.evict(slot))
        for req in list(sched.slots):
            if (req is not None and req.state == "running"
                    and req.rid not in started):
                self._emit(req)
                new_tokens += 1
        self.steps += 1
        if self.journal is not None:
            self.journal.event(
                "serve.step", replica=self.name,
                n_active=sched.n_active, n_queued=sched.n_queued,
                new_tokens=new_tokens,
                occupancy=sched.n_active / self.n_slots,
                free_blocks=self.allocator.n_free,
                prefill_chunks=step_pf)
        return new_tokens

    # -- elastic resize ------------------------------------------------------

    def drain(self) -> list[Request]:
        """Drain-then-retire: bounce every occupied slot back through
        the scheduler's requeue path (blocks freed, recompute-style),
        then hand the whole queue back for resubmission elsewhere.
        The replica is retired afterwards."""
        self.draining = True
        sched = self.scheduler
        for s in range(self.n_slots):
            if sched.slots[s] is not None:
                sched.requeue(s)
        out = list(sched.queue)
        sched.queue.clear()
        for req in out:
            req.state = "queued"
            self._n_decode.pop(req.rid, None)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.retired = True
        return out

    # -- stats ---------------------------------------------------------------

    def prefix_stats(self) -> dict:
        pc = self.prefix_cache
        if pc is None:
            return {"queries": 0, "hit_requests": 0, "hit_tokens": 0,
                    "expired_blocks": 0}
        return {"queries": pc.queries, "hit_requests": pc.hit_requests,
                "hit_tokens": pc.hit_tokens,
                "expired_blocks": pc.expired_blocks}


class EngineReplica:
    """A real :class:`ServeEngine` behind the replica protocol.

    The engine journals its own ``serve.*`` spans (pass the gateway's
    journal at engine construction so all replicas share one file);
    this wrapper adds only the fleet bookkeeping the router and
    controller need — load, heartbeat, drain."""

    def __init__(self, name: str, engine, *,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.engine = engine
        self.clock = clock
        self.n_slots = engine.n_slots
        self.block_size = engine.pool.block_size
        self.max_len = engine.max_len
        self.draining = False
        self.retired = False
        self.alive = True
        self.last_step_t = clock()
        self._taken = 0
        self.prompt_tokens = 0

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: int | None = None, priority: int = 0,
               n_decode: int | None = None,
               rid: int | None = None) -> Request:
        # ``rid`` is ignored: the engine mints its own (real serving
        # doesn't need cross-run id determinism; the virtual-time
        # chaos runs do, and those use SimReplica)
        self.prompt_tokens += len(prompt)
        return self.engine.submit(list(prompt), max_new_tokens,
                                  eos_id=eos_id, priority=priority)

    def resubmit(self, req: Request, *,
                 n_decode: int | None = None) -> Request:
        self.engine.scheduler.submit(req)
        return req

    def load(self) -> int:
        s = self.engine.scheduler
        return s.n_queued + s.n_active

    def idle(self) -> bool:
        return self.engine.scheduler.idle()

    def step(self) -> int:
        before = self.engine.tokens_emitted
        if not self.engine.scheduler.idle():
            self.engine.step()
        self.last_step_t = self.clock()
        return self.engine.tokens_emitted - before

    def take_finished(self) -> list[Request]:
        out = self.engine.finished[self._taken:]
        self._taken = len(self.engine.finished)
        return out

    def cancel(self, rid: int) -> bool:
        """Drop one request (hedge loser) without a completion span —
        the engine twin of :meth:`SimReplica.cancel`."""
        sched = self.engine.scheduler
        for r in list(sched.queue):
            if r.rid == rid:
                sched.queue.remove(r)
                return True
        for s in range(sched.n_slots):
            r = sched.slots[s]
            if r is not None and r.rid == rid:
                sched.evict(s)
                return True
        return False

    def drain(self) -> list[Request]:
        self.draining = True
        sched = self.engine.scheduler
        for s in range(sched.n_slots):
            if sched.slots[s] is not None:
                sched.requeue(s)
        out = list(sched.queue)
        sched.queue.clear()
        for req in out:
            req.state = "queued"
        if self.engine._prefix_cache is not None:
            self.engine._prefix_cache.clear()
        self.retired = True
        return out

    def prefix_stats(self) -> dict:
        pc = self.engine._prefix_cache
        if pc is None:
            return {"queries": 0, "hit_requests": 0, "hit_tokens": 0,
                    "expired_blocks": 0}
        return {"queries": pc.queries, "hit_requests": pc.hit_requests,
                "hit_tokens": pc.hit_tokens,
                "expired_blocks": pc.expired_blocks}


class Router:
    """Content-hash affinity placement with least-loaded fallback."""

    def __init__(self, replicas: Sequence, *, block_size: int,
                 policy: str = "affinity",
                 imbalance_factor: float = 2.0,
                 heartbeat_s: float | None = None,
                 gate: Callable[[Any], bool] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 journal=None):
        if policy not in ("affinity", "least_loaded"):
            raise ValueError(f"unknown router policy {policy!r}")
        self.replicas: list = list(replicas)
        self.block_size = int(block_size)
        self.policy = policy
        self.imbalance_factor = float(imbalance_factor)
        self.heartbeat_s = heartbeat_s
        # optional routing gate (the gateway's per-replica circuit
        # breakers): a replica the gate vetoes takes no NEW placements
        # but keeps its in-flight work and its affinity claims
        self.gate = gate
        self.clock = clock
        self.journal = journal
        # chained content-hash key -> replica NAME that first prefilled
        # it (first owner wins, exactly the index's first-publisher
        # rule; retiring a replica forgets its claims)
        self._owner: dict[str, str] = {}
        self.n_routed = 0
        self.n_affinity = 0
        self.n_fallback = 0
        self.n_decayed = 0

    def healthy(self) -> list:
        out = []
        now = self.clock()
        for r in self.replicas:
            if r.draining or r.retired or not getattr(r, "alive", True):
                continue
            if (self.heartbeat_s is not None
                    and now - r.last_step_t > self.heartbeat_s):
                continue
            if self.gate is not None and not self.gate(r):
                continue
            out.append(r)
        return out

    def _owner_dead(self, name: str | None,
                    by_name: dict[str, Any]) -> bool:
        """True when a claim's owner no longer exists as a live
        replica (retired, killed, or forgotten) — its KV is gone for
        good, so the claim is a corpse, not a temporary outage."""
        if name is None:
            return False
        rep = by_name.get(name)
        return (rep is None or rep.retired
                or not getattr(rep, "alive", True))

    def route(self, prompt: Sequence[int]):
        """Pick the replica for ``prompt`` and stamp its content keys.

        Affinity: deepest contiguous owned prefix wins, unless the
        owner is overloaded vs the least-loaded healthy replica; ties
        and unknown content go least-loaded (stable by name)."""
        cands = self.healthy()
        if not cands:
            raise NoHealthyReplica(
                f"no healthy replica among {len(self.replicas)}")
        least = min(cands, key=lambda r: (r.load(), r.name))
        keys = block_hashes(list(prompt), self.block_size)
        chosen = least
        depth = 0
        if self.policy == "affinity" and keys:
            by_name = {r.name: r for r in cands}
            node = None
            for key in keys:
                owner = self._owner.get(key)
                if owner is None or owner not in by_name:
                    break
                node = owner
                depth += 1
            if node is not None:
                aff = by_name[node]
                # affinity yields to gross imbalance: a hot prefix
                # must not serialize the fleet behind one replica
                if (aff.load() <= self.imbalance_factor * least.load()
                        + aff.n_slots):
                    chosen = aff
                else:
                    depth = 0
        self.n_routed += 1
        if depth:
            self.n_affinity += 1
        else:
            self.n_fallback += 1
        all_by_name = {r.name: r for r in self.replicas}
        for key in keys:
            cur = self._owner.get(key)
            if cur is None:
                self._owner[key] = chosen.name
            elif self._owner_dead(cur, all_by_name):
                # decay: the owning replica is dead, its KV with it —
                # re-own the block where this traffic actually lands
                # so failover traffic stops chasing the corpse
                self._owner[key] = chosen.name
                self.n_decayed += 1
        return chosen

    def forget(self, name: str) -> int:
        """Drop a retired replica's content claims (its index is gone);
        returns how many keys were released."""
        dead = [k for k, v in self._owner.items() if v == name]
        for k in dead:
            del self._owner[k]
        return len(dead)

    def stats(self) -> dict:
        return {"n_routed": self.n_routed,
                "n_affinity": self.n_affinity,
                "n_fallback": self.n_fallback,
                "n_decayed": self.n_decayed,
                "owned_keys": len(self._owner)}
