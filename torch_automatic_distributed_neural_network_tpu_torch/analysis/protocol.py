"""Protocol models for the serving control plane (PC0xx rules).

The JAX package's ``analysis/protocol.py``, run over this package's
serving objects: the models, scopes, rules and mutations are the same,
so a counterexample script saved by either package replays through the
other's model with the same rule code.

Each :class:`~.model_check.ProtocolModel` here wraps the REAL serving
objects — ``BlockAllocator``, ``Scheduler`` (+ the real
``AdapterAllocator`` pin machine), ``PrefixCache``, and the full
``Gateway`` over ``SimReplica`` fleets — and exposes their operations
as events for bounded BFS exploration (``model_check.explore``).  The
models add only *ghost state* (ownership tables, expected token
streams, step budgets) needed to state the invariants; every state
transition is executed by the shipped code.

Rules:

- **PC001** — allocator refcount safety: conservation (free + live ==
  pool), refcount == ghost holders, no null block, free-list sanity.
- **PC002** — scheduler protocol: ``check_invariants`` under every
  interleaving, FIFO queue order, no over-generation.
- **PC003** — prefix-cache lease/refcount discipline: index blocks
  backed by exactly one index reference, expired leases never match.
- **PC004** — gateway exactly-once ledger: append-only, a prefix of
  the expected stream, terminal streams exact.
- **PC005** — circuit-breaker transitions restricted to the legal
  closed/open/half-open edges.
- **PC006** — liveness: quiescence implies all blocks free / pins
  dropped / rids resolved; a stuck non-quiescent world is a violation.
- **PC007** — (warning) exploration truncated by the state/depth caps,
  so the scope was not exhaustively checked.

``MUTATIONS`` is the checker's own validation: ~10 single-line
semantic mutations of scheduler/kv_pool/prefix/fault code, each of
which the corresponding model must catch with a replayable
counterexample (``tests/test_torch_port_protocol.py`` asserts this).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from types import SimpleNamespace
from typing import Any, Callable, Sequence

from ..inference.gateway.fault import BreakerPolicy, CircuitBreaker, HedgePolicy
from ..inference.gateway.ingress import Gateway
from ..inference.gateway.router import SimReplica
from ..inference.serve.adapters import AdapterAllocator, IDENTITY_ADAPTER
from ..inference.serve.kv_pool import NULL_BLOCK, BlockAllocator
from ..inference.serve.prefix_cache import PrefixCache
from ..inference.serve.scheduler import Request, Scheduler
from ..obs import journal as journal_mod
from .model_check import (Event, ModelResult, ProtocolModel,
                          ProtocolViolation, canonical, explore,
                          save_script)


class VirtualClock:
    """Deterministic injectable clock.

    A plain callable *object* (not a closure): ``deepcopy`` of a world
    copies it and rebinds every component's ``.clock`` to the same
    copy, so copied worlds never share time with their parent — the
    property the whole checker rests on."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class _PinPool:
    """Minimal ``adapter_pool`` stand-in: the REAL ``AdapterAllocator``
    pin/LRU state machine without device weight storage (the scheduler
    only touches ``acquire``/``release``/``allocator``)."""

    def __init__(self, n_adapters: int):
        self.allocator = AdapterAllocator(n_adapters)

    def acquire(self, name: str):
        return self.allocator.acquire(name)

    def release(self, name: str) -> None:
        self.allocator.release(name)

    def has(self, name: str) -> bool:
        return True


# -- model 1: BlockAllocator acquire/ref/release + CoW fork -------------------


class AllocatorModel(ProtocolModel):
    """Ghost owner tables vs the real allocator's refcounts."""

    name = "allocator"
    rule = "PC001"

    def __init__(self, scope: dict | None = None):
        super().__init__(scope)
        self.num_blocks = int(self.scope.get("num_blocks", 5))
        self.n_owners = int(self.scope.get("n_owners", 2))
        self.max_hold = int(self.scope.get("max_hold", 3))
        self.scope = {"num_blocks": self.num_blocks,
                      "n_owners": self.n_owners,
                      "max_hold": self.max_hold}

    def initial(self) -> Any:
        return SimpleNamespace(
            alloc=BlockAllocator(self.num_blocks),
            owners=[[] for _ in range(self.n_owners)])

    def enabled(self, w: Any) -> list[Event]:
        evs: list[Event] = []
        for i in range(self.n_owners):
            hold = len(w.owners[i])
            for n in (1, 2):
                if hold + n <= self.max_hold and w.alloc.n_free >= n:
                    evs.append(("acquire", i, n))
            if hold:
                evs.append(("release", i))
                if (w.alloc.refcount(w.owners[i][-1]) > 1
                        and w.alloc.n_free >= 1):
                    evs.append(("fork", i))
            for j in range(self.n_owners):
                if j != i and w.owners[j] and hold < self.max_hold:
                    evs.append(("share", i, j))
        return evs

    def apply(self, w: Any, ev: Event) -> None:
        if ev[0] == "acquire":
            _, i, n = ev
            got = w.alloc.acquire(n)
            if got is not None:
                w.owners[i].extend(got)
        elif ev[0] == "release":
            _, i = ev
            w.alloc.release([w.owners[i].pop()])
        elif ev[0] == "share":
            _, i, j = ev
            b = w.owners[j][0]
            w.alloc.ref(b)
            w.owners[i].append(b)
        elif ev[0] == "fork":
            # CoW at the allocator level: a writer sharing its last
            # block takes a private copy, then drops the shared ref
            _, i = ev
            old = w.owners[i][-1]
            got = w.alloc.acquire(1)
            if got is not None:
                w.alloc.release([old])
                w.owners[i][-1] = got[0]
        else:  # pragma: no cover - unknown events never enabled
            raise ValueError(f"unknown event {ev!r}")

    def violations(self, w: Any) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        alloc = w.alloc
        held = Counter(b for t in w.owners for b in t)
        if NULL_BLOCK in held:
            out.append(("PC001", "an owner table holds the null block"))
        if alloc.n_free + alloc.n_live != alloc.num_blocks - 1:
            out.append(("PC001",
                        f"conservation broken: free {alloc.n_free} + "
                        f"live {alloc.n_live} != {alloc.num_blocks - 1}"))
        if set(held) != set(alloc._live):
            out.append(("PC001",
                        f"live set {sorted(alloc._live)} != ghost-held "
                        f"{sorted(held)}"))
        else:
            for b, n in sorted(held.items()):
                if alloc.refcount(b) != n:
                    out.append(("PC001",
                                f"block {b}: refcount "
                                f"{alloc.refcount(b)} != {n} holders"))
        free = list(alloc._free)
        if len(set(free)) != len(free):
            out.append(("PC001", "free list holds a duplicate block id"))
        if set(free) & set(held):
            out.append(("PC001",
                        "a held block is simultaneously on the free "
                        "list (double-free)"))
        return out

    def quiescent(self, w: Any) -> bool:
        return not any(w.owners)

    def terminal_violations(self, w: Any) -> list[tuple[str, str]]:
        if w.alloc.n_live != 0:
            return [("PC006",
                     f"quiescent but {w.alloc.n_live} blocks still "
                     "live (leak)")]
        return []

    def fingerprint(self, w: Any) -> Any:
        return canonical(w, exclude=frozenset({"journal"}))


# -- model 2: Scheduler admission/preemption/prefill/requeue ------------------


class SchedulerModel(ProtocolModel):
    """The real ``Scheduler`` + real ``AdapterAllocator`` driven
    through the engine's event decomposition (submit / admit / prefill
    chunk / decode / finish / preempt), with the adapter-bounce requeue
    path reachable by construction (one pinnable pool slot, two
    adapter-bearing requests)."""

    rule = "PC002"

    def __init__(self, scope: dict | None = None):
        super().__init__(scope)
        self.admission = str(self.scope.get("admission", "reserve"))
        self.name = f"scheduler-{self.admission}"
        self.n_slots = int(self.scope.get("n_slots", 2))
        self.num_blocks = int(self.scope.get("num_blocks", 6))
        self.block_size = int(self.scope.get("block_size", 4))
        self.n_adapters = int(self.scope.get("n_adapters", 2))
        self.prefill_chunk = int(self.scope.get("prefill_chunk", 4))
        self.preempt_budget = int(self.scope.get("preempt_budget", 1))
        reqs = self.scope.get(
            "requests",
            [[6, 2, "a", 0], [4, 2, "b", 0], [9, 2, None, 0]])
        self.requests = [(int(p), int(m), a, int(pr))
                         for p, m, a, pr in reqs]
        self.scope = {"admission": self.admission,
                      "n_slots": self.n_slots,
                      "num_blocks": self.num_blocks,
                      "block_size": self.block_size,
                      "n_adapters": self.n_adapters,
                      "prefill_chunk": self.prefill_chunk,
                      "preempt_budget": self.preempt_budget,
                      "requests": [list(r) for r in self.requests]}

    def initial(self) -> Any:
        clock = VirtualClock()
        alloc = BlockAllocator(self.num_blocks)
        pool = (_PinPool(self.n_adapters)
                if any(r[2] for r in self.requests) else None)
        sched = Scheduler(
            n_slots=self.n_slots, allocator=alloc,
            block_size=self.block_size, admission=self.admission,
            adapter_pool=pool, clock=clock)
        return SimpleNamespace(
            clock=clock, alloc=alloc, pool=pool, sched=sched,
            reqs=[None] * len(self.requests), prefill={},
            preempts_left=self.preempt_budget)

    @staticmethod
    def _idx(w: Any, req: Request) -> int:
        for i, r in enumerate(w.reqs):
            if r is req:
                return i
        raise KeyError(f"request {req.rid} not in the model's set")

    def enabled(self, w: Any) -> list[Event]:
        evs: list[Event] = []
        for i, r in enumerate(w.reqs):
            if r is None:
                evs.append(("submit", i))
        occupied = [r for r in w.sched.slots if r is not None]
        if w.sched.queue and len(occupied) < self.n_slots:
            evs.append(("admit",))
        if any(r.state == "prefilling" for r in occupied):
            evs.append(("prefill",))
        running = [r for r in occupied if r.state == "running"]
        if any(not r.finished() for r in running):
            evs.append(("decode",))
        if any(r.finished() for r in running):
            evs.append(("finish",))
        if w.preempts_left > 0 and occupied:
            evs.append(("preempt",))
        return evs

    def apply(self, w: Any, ev: Event) -> None:
        w.clock.advance(1.0)
        sched = w.sched
        if ev[0] == "submit":
            i = ev[1]
            n_prompt, max_new, adapter, prio = self.requests[i]
            req = Request(prompt=[i + 1] * n_prompt,
                          max_new_tokens=max_new, eos_id=None,
                          adapter=adapter, priority=prio)
            req.t_submit = w.clock()
            sched.submit(req)
            w.reqs[i] = req
        elif ev[0] == "admit":
            for _slot, req in sched.admit():
                # the engine flips admitted slots into prefill and
                # tracks the chunk cursor host-side
                req.state = "prefilling"
                w.prefill[self._idx(w, req)] = req.cached_tokens
        elif ev[0] == "prefill":
            for slot, req in sched.prefill_plan(1):
                i = self._idx(w, req)
                pos = min(w.prefill[i] + self.prefill_chunk,
                          req.n_prompt)
                if pos >= req.n_prompt:
                    del w.prefill[i]
                    info = sched.pin_adapter(req)
                    if info is None:
                        # every pool slot pinned by other running
                        # requests: the engine bounces the slot
                        sched.requeue(slot)
                    else:
                        req.state = "running"
                        req.out_tokens.append(1)
                        if req.finished():
                            sched.evict(slot)
                else:
                    w.prefill[i] = pos
        elif ev[0] == "decode":
            for victim in sched.grow_for_step():
                w.prefill.pop(self._idx(w, victim), None)
            for req in sched.slots:
                # finished slots take no decode write: the engine
                # evicts them at the top of the step, always
                if (req is not None and req.state == "running"
                        and not req.finished()):
                    req.out_tokens.append(1)
        elif ev[0] == "finish":
            for s in range(self.n_slots):
                req = sched.slots[s]
                if (req is not None and req.state == "running"
                        and req.finished()):
                    sched.evict(s)
        elif ev[0] == "preempt":
            w.preempts_left -= 1
            victim = sched.preempt_youngest()
            if victim is not None:
                w.prefill.pop(self._idx(w, victim), None)
        else:  # pragma: no cover
            raise ValueError(f"unknown event {ev!r}")

    def violations(self, w: Any) -> list[tuple[str, str]]:
        try:
            w.sched.check_invariants()
        except AssertionError as e:
            return [("PC002", f"check_invariants: {e}")]
        out: list[tuple[str, str]] = []
        keys = [Scheduler._queue_key(r) for r in w.sched.queue]
        if keys != sorted(keys):
            out.append(("PC002",
                        "queue not in FIFO (priority, t_submit, rid) "
                        "order"))
        for i, r in enumerate(w.reqs):
            if r is not None and r.n_generated > r.max_new_tokens:
                out.append(("PC002",
                            f"request {i} over-generated: "
                            f"{r.n_generated} > {r.max_new_tokens}"))
        ghost = set(w.prefill)
        real = {self._idx(w, r) for r in w.sched.slots
                if r is not None and r.state == "prefilling"}
        if ghost != real:
            out.append(("PC002",
                        f"prefill cursors {sorted(ghost)} != "
                        f"prefilling slots {sorted(real)}"))
        return out

    def quiescent(self, w: Any) -> bool:
        return all(r is not None for r in w.reqs) and w.sched.idle()

    def terminal_violations(self, w: Any) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        if w.alloc.n_free != self.num_blocks - 1:
            out.append(("PC006",
                        f"quiescent but only {w.alloc.n_free}/"
                        f"{self.num_blocks - 1} blocks free (leak)"))
        if w.pool is not None and w.pool.allocator.pinned_names():
            out.append(("PC006",
                        f"quiescent but adapter pins remain: "
                        f"{w.pool.allocator.pinned_names()}"))
        for i, r in enumerate(w.reqs):
            if r is None or r.state != "done":
                out.append(("PC006",
                            f"quiescent but request {i} is "
                            f"{'unsubmitted' if r is None else r.state}"))
            elif r.n_generated != r.max_new_tokens:
                out.append(("PC006",
                            f"request {i} resolved with "
                            f"{r.n_generated}/{r.max_new_tokens} tokens"))
        return out

    def fingerprint(self, w: Any) -> Any:
        # timestamps are monotone per-path (the clock ticks every
        # event), so raw times would make every interleaving distinct;
        # behavior only depends on their RELATIVE order, captured here
        # as rid order (== submission order) and admission-rank order.
        def req_fp(r):
            if r is None:
                return None
            return (r.state, tuple(r.blocks), r.n_generated,
                    r.adapter_idx)

        sub_order = tuple(sorted(
            (i for i, r in enumerate(w.reqs) if r is not None),
            key=lambda i: w.reqs[i].rid))
        queue = tuple(self._idx(w, r) for r in w.sched.queue)
        slots = tuple(
            None if r is None else (self._idx(w, r),) + req_fp(r)
            for r in w.sched.slots)
        admit_order = tuple(sorted(
            (s for s, r in enumerate(w.sched.slots) if r is not None),
            key=lambda s: (w.sched.slots[s].t_admit or 0.0, s)))
        alloc = (tuple(w.alloc._free),
                 tuple(sorted(w.alloc._refs.items())))
        pool = (canonical(w.pool.allocator.__dict__)
                if w.pool is not None else None)
        states = tuple(req_fp(r) for r in w.reqs)
        return (sub_order, queue, slots, admit_order, alloc, pool,
                tuple(sorted(w.prefill.items())), states,
                w.preempts_left)


# -- model 3: PrefixCache insert/match/evict/TTL-expire -----------------------


class PrefixCacheModel(ProtocolModel):
    """Radix-lease discipline vs allocator refcounts: ghost tables
    stand in for request block tables; leases expire across virtual
    clock ticks."""

    name = "prefix"
    rule = "PC003"

    def __init__(self, scope: dict | None = None):
        super().__init__(scope)
        self.num_blocks = int(self.scope.get("num_blocks", 7))
        self.block_size = int(self.scope.get("block_size", 2))
        self.ttl_s = float(self.scope.get("ttl_s", 5.0))
        self.tick_dt = float(self.scope.get("tick_dt", 3.0))
        self.n_ticks = int(self.scope.get("n_ticks", 2))
        prompts = self.scope.get(
            "prompts", [[1, 2, 3, 4], [1, 2, 7, 8]])
        self.prompts = [[int(t) for t in p] for p in prompts]
        self.scope = {"num_blocks": self.num_blocks,
                      "block_size": self.block_size,
                      "ttl_s": self.ttl_s, "tick_dt": self.tick_dt,
                      "n_ticks": self.n_ticks,
                      "prompts": [list(p) for p in self.prompts]}

    def initial(self) -> Any:
        clock = VirtualClock()
        alloc = BlockAllocator(self.num_blocks)
        cache = PrefixCache(block_size=self.block_size,
                            allocator=alloc, clock=clock)
        return SimpleNamespace(clock=clock, alloc=alloc, cache=cache,
                               tables={}, ticks_left=self.n_ticks,
                               pub_left=[1] * len(self.prompts),
                               match_left=[2] * len(self.prompts))

    def enabled(self, w: Any) -> list[Event]:
        evs: list[Event] = []
        for i, p in enumerate(self.prompts):
            need = len(p) // self.block_size
            if w.pub_left[i] and w.alloc.n_free >= need:
                evs.append(("publish", i))
            # budget 2: one match before and one after a lease tick —
            # unbounded re-matching only multiplies identical states
            if (w.match_left[i] and f"match{i}" not in w.tables
                    and w.cache.n_blocks):
                evs.append(("match", i))
        for key in sorted(w.tables):
            evs.append(("drop", key))
        if w.cache.n_blocks:
            evs.append(("evict",))
        if w.ticks_left > 0:
            evs.append(("tick",))
        return evs

    def apply(self, w: Any, ev: Event) -> None:
        if ev[0] == "publish":
            i = ev[1]
            prompt = self.prompts[i]
            need = len(prompt) // self.block_size
            w.pub_left[i] -= 1
            got = w.alloc.acquire(need)
            if got is not None:
                # the publisher's table holds the blocks; the index
                # refs what it newly adopts (first publisher wins)
                w.cache.insert(prompt, got, ttl_s=self.ttl_s)
                w.tables[f"pub{i}"] = got
        elif ev[0] == "match":
            i = ev[1]
            w.match_left[i] -= 1
            prompt = self.prompts[i]
            blocks, _n = w.cache.match(prompt,
                                       max_tokens=len(prompt))
            now = w.clock()
            for node in w.cache._nodes.values():
                if (node.block in blocks
                        and node.expires_at is not None
                        and now >= node.expires_at):
                    raise ProtocolViolation(
                        "PC003",
                        f"match returned block {node.block} whose "
                        f"lease expired at {node.expires_at} "
                        f"(now {now})")
            if blocks:
                for b in blocks:
                    w.alloc.ref(b)
                w.tables[f"match{i}"] = list(blocks)
        elif ev[0] == "drop":
            w.alloc.release(w.tables.pop(ev[1]))
        elif ev[0] == "evict":
            w.cache.evict(1)
        elif ev[0] == "tick":
            w.clock.advance(self.tick_dt)
            w.ticks_left -= 1
            w.cache.expire()
        else:  # pragma: no cover
            raise ValueError(f"unknown event {ev!r}")

    def violations(self, w: Any) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        alloc = w.alloc
        held = Counter(b for t in w.tables.values() for b in t)
        index = w.cache.blocks()
        if NULL_BLOCK in index:
            out.append(("PC003", "radix index holds the null block"))
        live = set(held) | index
        if live != set(alloc._live):
            out.append(("PC003",
                        f"live set {sorted(alloc._live)} != "
                        f"tables+index {sorted(live)}"))
        else:
            for b in sorted(live):
                want = held.get(b, 0) + (1 if b in index else 0)
                if alloc.refcount(b) != want:
                    out.append(("PC003",
                                f"block {b}: refcount "
                                f"{alloc.refcount(b)} != "
                                f"{held.get(b, 0)} tables + "
                                f"{int(b in index)} index ref"))
        if alloc.n_free + alloc.n_live != alloc.num_blocks - 1:
            out.append(("PC003",
                        f"conservation broken: free {alloc.n_free} + "
                        f"live {alloc.n_live} != "
                        f"{alloc.num_blocks - 1}"))
        return out

    def quiescent(self, w: Any) -> bool:
        return not w.tables and w.cache.n_blocks == 0

    def terminal_violations(self, w: Any) -> list[tuple[str, str]]:
        if w.alloc.n_live != 0:
            return [("PC006",
                     f"index empty and tables dropped but "
                     f"{w.alloc.n_live} blocks live (leak)")]
        return []

    def fingerprint(self, w: Any) -> Any:
        nodes = tuple(sorted(
            (key, n.block, n.parent.key if n.parent is not None else "",
             n.last_hit, n.expires_at)
            for key, n in w.cache._nodes.items()))
        return (nodes, tuple(w.alloc._free),
                tuple(sorted(w.alloc._refs.items())),
                canonical(w.tables), w.clock.t, w.ticks_left,
                tuple(w.pub_left), tuple(w.match_left),
                w.cache._next_expiry)


# -- model 4: gateway failover/hedge/ledger protocol --------------------------

_LEGAL_BREAKER_EDGES = {("closed", "open"), ("open", "half_open"),
                        ("half_open", "closed"), ("half_open", "open")}


class GatewayModel(ProtocolModel):
    """The full ``Gateway`` over two ``SimReplica`` fleets, with kill /
    stall / restore fault events in a bounded window.  Checks the
    exactly-once ledger (append-only, prefix of the expected stream,
    terminally exact), breaker-edge legality, and that every fault
    schedule still resolves every rid within the step budget."""

    name = "gateway"
    rule = "PC004"

    def __init__(self, scope: dict | None = None):
        super().__init__(scope)
        self.n_replicas = int(self.scope.get("n_replicas", 2))
        self.n_decode = int(self.scope.get("n_decode", 2))
        prompts = self.scope.get(
            "prompts",
            [[11, 12, 13, 14], [21, 22, 23, 24], [31, 32, 33, 34]])
        self.prompts = [[int(t) for t in p] for p in prompts]
        self.max_steps = int(self.scope.get("max_steps", 30))
        self.submit_until = int(self.scope.get("submit_until", 2))
        self.fault_from = int(self.scope.get("fault_from", 1))
        self.fault_until = int(self.scope.get("fault_until", 4))
        self.unstall_until = int(self.scope.get("unstall_until", 10))
        # scope restrictions for targeted runs: "faults" limits the
        # fault alphabet ("all"/"kill"/"none"); "hedge" strips the
        # hedging rescue path so redispatch bugs cannot hide behind it
        self.faults = str(self.scope.get("faults", "all"))
        self.hedge_enabled = bool(self.scope.get("hedge", True))
        self.scope = {"n_replicas": self.n_replicas,
                      "n_decode": self.n_decode,
                      "prompts": [list(p) for p in self.prompts],
                      "max_steps": self.max_steps,
                      "submit_until": self.submit_until,
                      "fault_from": self.fault_from,
                      "fault_until": self.fault_until,
                      "unstall_until": self.unstall_until,
                      "faults": self.faults,
                      "hedge": self.hedge_enabled}

    def initial(self) -> Any:
        clock = VirtualClock()
        journal = journal_mod._NullJournal()
        replicas = [
            SimReplica(f"r{k}", n_slots=2, block_size=4, max_len=16,
                       prefill_chunk=4, prefix_cache=False,
                       clock=clock, journal=journal)
            for k in range(self.n_replicas)]
        gw = Gateway(
            replicas, journal=journal, clock=clock, queue_limit=100,
            router_policy="least_loaded", heartbeat_s=3.5,
            hedge=(HedgePolicy(after_s=6.0, max_hedges_per_request=1)
                   if self.hedge_enabled else None),
            breaker=BreakerPolicy(window_s=8.0, min_observations=2,
                                  failure_rate=0.5, open_s=5.0,
                                  clean_s=2.0),
            step_costs=(1.0, 1.0))
        nd = self.n_decode
        return SimpleNamespace(
            clock=clock, gw=gw, replicas=replicas,
            handles=[None] * len(self.prompts),
            expected=[[1] * (nd - 1) + [0] for _ in self.prompts],
            seen={}, steps=0, fault=None, unstalled=False)

    def _resolved(self, w: Any) -> bool:
        # every request submitted ON THIS PATH has resolved; paths
        # that never submit are trivially resolved (submission is an
        # optional event, not an obligation)
        return not w.gw._meta

    def _check_ledger(self, w: Any) -> None:
        for i, h in enumerate(w.handles):
            if h is None:
                continue
            cur = w.gw.delivered(h.rid)
            prev = w.seen.get(i, [])
            if cur[:len(prev)] != prev:
                raise ProtocolViolation(
                    "PC004",
                    f"ledger for rid {h.rid} rewrote history: "
                    f"{prev} -> {cur}")
            want = w.expected[i]
            if len(cur) > len(want):
                raise ProtocolViolation(
                    "PC004",
                    f"rid {h.rid} delivered {len(cur)} tokens, "
                    f"requested {len(want)}")
            if cur != want[:len(cur)]:
                raise ProtocolViolation(
                    "PC004",
                    f"rid {h.rid} stream diverged (duplicated or "
                    f"skipped token): got {cur}, want a prefix of "
                    f"{want}")
            w.seen[i] = cur

    def enabled(self, w: Any) -> list[Event]:
        evs: list[Event] = []
        nxt = next((i for i, h in enumerate(w.handles) if h is None),
                   None)
        if nxt is not None and w.steps <= self.submit_until:
            evs.append(("submit", nxt))
        if w.steps < self.max_steps and not self.quiescent(w):
            evs.append(("step",))
        any_inflight = any(h is not None for h in w.handles)
        if (w.fault is None and any_inflight
                and self.fault_from <= w.steps <= self.fault_until):
            if self.faults in ("all", "kill"):
                evs.append(("kill",))
            if self.faults == "all":
                evs.append(("stall",))
        if (w.fault == "stall" and not w.unstalled
                and w.steps <= self.unstall_until):
            evs.append(("unstall",))
        return evs

    def apply(self, w: Any, ev: Event) -> None:
        if ev[0] == "submit":
            i = ev[1]
            req = w.gw.submit(self.prompts[i], self.n_decode,
                              tenant="t", eos_id=0,
                              n_decode=self.n_decode)
            w.handles[i] = req
        elif ev[0] == "step":
            w.gw.step()
            w.clock.advance(1.0)
            w.steps += 1
        elif ev[0] == "kill":
            w.replicas[-1].kill()
            w.fault = "kill"
        elif ev[0] == "stall":
            w.replicas[-1].stalled = True
            w.fault = "stall"
        elif ev[0] == "unstall":
            w.replicas[-1].stalled = False
            w.unstalled = True
        else:  # pragma: no cover
            raise ValueError(f"unknown event {ev!r}")
        self._check_ledger(w)

    def violations(self, w: Any) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        for br in w.gw._breakers.values():
            if br.state not in ("closed", "open", "half_open"):
                out.append(("PC005",
                            f"breaker {br.name} in unknown state "
                            f"{br.state!r}"))
            for tr in br.transitions:
                if (tr["from"], tr["to"]) not in _LEGAL_BREAKER_EDGES:
                    out.append(("PC005",
                                f"illegal breaker transition on "
                                f"{tr['replica']}: {tr['from']} -> "
                                f"{tr['to']}"))
        return out

    def quiescent(self, w: Any) -> bool:
        return self._resolved(w) and w.gw.idle()

    def terminal_violations(self, w: Any) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        for i, h in enumerate(w.handles):
            if h is None:
                continue
            got = w.gw.delivered(h.rid)
            if got != w.expected[i]:
                out.append(("PC004",
                            f"terminal stream for rid {h.rid}: got "
                            f"{got}, want {w.expected[i]} exactly"))
        for r in w.replicas:
            if r.retired or not r.alive:
                continue  # dead state is frozen mid-flight by design
            if not r.idle():
                out.append(("PC006",
                            f"resolved but replica {r.name} is not "
                            "idle"))
            elif r.allocator.n_free != r.allocator.num_blocks - 1:
                out.append(("PC006",
                            f"replica {r.name} leaked blocks: "
                            f"{r.allocator.n_free}/"
                            f"{r.allocator.num_blocks - 1} free"))
        return out

    def fingerprint(self, w: Any) -> Any:
        # telemetry-only fields (wall stamps per token, offered-traffic
        # samples) are excluded; everything behavioral stays
        return canonical(w, exclude=frozenset({
            "journal", "_submits", "token_walls", "t_first_token",
            "lost_s"}))


# -- registry / entry points ------------------------------------------------

MODEL_NAMES = ("allocator", "scheduler-reserve",
               "scheduler-optimistic", "prefix", "gateway")

#: documented default scope (scope=1): 2 replicas, 3 requests per
#: model, >= 4 usable blocks.


def default_scope(name: str, scope: int = 1) -> dict:
    """Scope-N parameters for a model; N=1 is the documented default,
    larger N widens the instance (more owners/requests/ticks)."""
    n = max(1, int(scope))
    if name == "allocator":
        return {"num_blocks": 4 + n, "n_owners": 2 if n < 3 else 3,
                "max_hold": 3}
    if name in ("scheduler-reserve", "scheduler-optimistic"):
        reqs = [[6, 2, "a", 0], [4, 2, "b", 0], [9, 2, None, 0]]
        if n >= 2:
            reqs.append([5, 1, None, 1])
        return {"admission": name.split("-", 1)[1],
                "num_blocks": 6 + 2 * (n - 1), "preempt_budget": n,
                "requests": reqs}
    if name == "prefix":
        prompts = [[1, 2, 3, 4], [1, 2, 7, 8]]
        if n >= 2:
            prompts.append([9, 10, 11, 12])
        return {"num_blocks": 7 + 2 * (n - 1), "n_ticks": 1 + n,
                "prompts": prompts}
    if name == "gateway":
        return {"submit_until": 1 + n, "fault_until": 3 + n,
                "max_steps": 28 + 4 * (n - 1)}
    raise ValueError(f"unknown protocol model {name!r} "
                     f"(known: {', '.join(MODEL_NAMES)})")


def build_model(name: str, scope: dict | None = None) -> ProtocolModel:
    """(name, scope-dict) -> model; the hook ``replay_script`` uses."""
    if name == "allocator":
        return AllocatorModel(scope)
    if name in ("scheduler-reserve", "scheduler-optimistic"):
        sc = dict(scope or {})
        sc.setdefault("admission", name.split("-", 1)[1])
        return SchedulerModel(sc)
    if name == "prefix":
        return PrefixCacheModel(scope)
    if name == "gateway":
        return GatewayModel(scope)
    raise ValueError(f"unknown protocol model {name!r} "
                     f"(known: {', '.join(MODEL_NAMES)})")


def run_protocol_check(*, scope: int = 1,
                       models: Sequence[str] | None = None,
                       max_states: int = 400_000,
                       counterexample_dir: str | None = None,
                       journal=None) -> tuple[list, list[ModelResult]]:
    """Explore every protocol model at ``scope``; returns (findings,
    per-model results).  Violations become PC0xx ERROR findings (one
    per counterexample, minimized); a truncated exploration becomes a
    PC007 WARN.  Emits one ``lint.protocol`` journal event per model
    (rendered by ``tadnn report``)."""
    from . import ERROR, WARN, Finding
    jr = journal if journal is not None else journal_mod.get_default()
    findings: list = []
    results: list[ModelResult] = []
    for name in (models or MODEL_NAMES):
        model = build_model(name, default_scope(name, scope))
        res = explore(model, max_states=max_states)
        results.append(res)
        jr.event("lint.protocol", model=name, scope=scope,
                 states=res.states, transitions=res.transitions,
                 depth=res.depth, frontier_peak=res.frontier_peak,
                 wall_s=round(res.wall_s, 3), complete=res.complete,
                 violations=len(res.counterexamples))
        for k, cx in enumerate(res.counterexamples):
            where = f"protocol:{name}"
            if counterexample_dir is not None:
                import os
                os.makedirs(counterexample_dir, exist_ok=True)
                path = os.path.join(counterexample_dir,
                                    f"{name}-{cx.code}-{k}.json")
                save_script(cx, path)
                where = f"{where} ({path})"
            findings.append(Finding(
                code=cx.code, severity=ERROR, layer="protocol",
                where=where,
                msg=f"{cx.message} [{len(cx.events)}-event "
                    f"counterexample]"))
        if not res.complete:
            findings.append(Finding(
                code="PC007", severity=WARN, layer="protocol",
                where=f"protocol:{name}",
                msg=f"exploration truncated at {res.states} states "
                    f"(depth {res.depth}); scope not exhausted"))
    return findings, results


# -- seeded-mutation validation ----------------------------------------------


@contextlib.contextmanager
def _patched(obj: Any, attr: str, fn: Callable):
    orig = getattr(obj, attr)
    setattr(obj, attr, fn)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _mut_alloc_extra_ref():
    orig = BlockAllocator.acquire

    def acquire(self, n):
        got = orig(self, n)
        if got:
            self._refs[got[0]] += 1  # MUTATION: phantom reference
        return got

    return _patched(BlockAllocator, "acquire", acquire)


def _mut_alloc_skip_free():
    orig = BlockAllocator.release

    def release(self, blocks):
        n0 = len(self._free)
        orig(self, blocks)
        del self._free[n0:]  # MUTATION: freed ids never return

    return _patched(BlockAllocator, "release", release)


def _mut_sched_evict_skip_release():
    def evict(self, slot):
        req = self.slots[slot]
        assert req is not None, f"evict of empty slot {slot}"
        self.unpin_adapter(req)
        # MUTATION: self.allocator.free(req.blocks) dropped
        req.blocks = []
        req.cached_blocks = req.cached_tokens = 0
        req.slot = None
        req.state = "done"
        req.t_done = self.clock()
        self.slots[slot] = None
        self.n_finished += 1
        return req

    return _patched(Scheduler, "evict", evict)


def _mut_sched_requeue_append():
    def _requeue_fifo(self, req):
        self.queue.append(req)  # MUTATION: FIFO insert -> plain append

    return _patched(Scheduler, "_requeue_fifo", _requeue_fifo)


def _mut_sched_unpin_skip():
    def unpin_adapter(self, req):
        # MUTATION: pool release dropped; only the slot index resets
        req.adapter_idx = IDENTITY_ADAPTER

    return _patched(Scheduler, "unpin_adapter", unpin_adapter)


def _mut_prefix_drop_leak():
    orig = PrefixCache._drop

    def _drop(self, node):
        # MUTATION: net effect of skipping the index's release
        self.allocator.ref(node.block)
        orig(self, node)

    return _patched(PrefixCache, "_drop", _drop)


def _mut_prefix_match_expired():
    orig = PrefixCache.match

    def match(self, tokens, **kw):
        saved = {k: n.expires_at for k, n in self._nodes.items()}
        for n in self._nodes.values():
            n.expires_at = None  # MUTATION: lease check bypassed
        try:
            return orig(self, tokens, **kw)
        finally:
            for k, n in self._nodes.items():
                if k in saved:
                    n.expires_at = saved[k]

    return _patched(PrefixCache, "match", match)


def _mut_gw_ledger_skip_first():
    orig = Gateway._harvest

    def _harvest(self, now):
        fresh = [rid for rid in self._meta
                 if not self._delivered.get(rid)]
        orig(self, now)
        for rid in fresh:
            led = self._delivered.get(rid)
            if led:
                del led[0]  # MUTATION: first token never enters ledger

    return _patched(Gateway, "_harvest", _harvest)


def _mut_gw_ledger_dup():
    orig = Gateway._harvest

    def _harvest(self, now):
        lens = {rid: len(self._delivered.get(rid) or [])
                for rid in self._meta}
        orig(self, now)
        for rid, n0 in lens.items():
            led = self._delivered.get(rid)
            if led is not None and len(led) > n0:
                led.insert(n0, led[n0])  # MUTATION: token emitted twice

    return _patched(Gateway, "_harvest", _harvest)


def _mut_breaker_illegal_close():
    orig = CircuitBreaker.tick

    def tick(self):
        before = self.state
        orig(self)
        if before == "open" and self.state == "half_open":
            # MUTATION: open snaps straight back to closed
            self.state = "closed"
            self.transitions[-1]["to"] = "closed"

    return _patched(CircuitBreaker, "tick", tick)


def _mut_alloc_ref_noop():
    def ref(self, block):
        # MUTATION: the share is never accounted
        if block not in self._refs:
            raise ValueError(f"ref of unallocated block {block}")

    return _patched(BlockAllocator, "ref", ref)


def _mut_gw_failover_drop_salvage():
    def _failover(self, replica, *, reason):
        replica.drain()
        self.router.forget(replica.name)
        self.n_failovers += 1
        # MUTATION: salvaged requests never redispatched

    return _patched(Gateway, "_failover", _failover)


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One planted single-line protocol bug + the model that must
    catch it.  ``scope`` overrides narrow the instance when redundancy
    in the full protocol would mask the bug (e.g. hedging rescues a
    dropped failover redispatch — strip it so the primary path is
    load-bearing)."""

    name: str
    model: str
    note: str
    patch: Callable[[], Any]
    scope: dict | None = None


MUTATIONS: dict[str, Mutation] = {m.name: m for m in [
    Mutation("alloc-extra-ref", "allocator",
             "acquire leaves a phantom refcount on the first block",
             _mut_alloc_extra_ref),
    Mutation("alloc-skip-free", "allocator",
             "release drops ids instead of returning them to the "
             "free list", _mut_alloc_skip_free),
    Mutation("sched-evict-skip-release", "scheduler-reserve",
             "evict forgets allocator.free(req.blocks)",
             _mut_sched_evict_skip_release),
    Mutation("sched-requeue-append", "scheduler-reserve",
             "requeue appends instead of FIFO-inserting",
             _mut_sched_requeue_append),
    Mutation("sched-unpin-skip", "scheduler-reserve",
             "unpin_adapter skips the pool release",
             _mut_sched_unpin_skip),
    Mutation("prefix-drop-leak", "prefix",
             "radix node drop skips the index's block release",
             _mut_prefix_drop_leak),
    Mutation("prefix-match-expired", "prefix",
             "match ignores lease expiry", _mut_prefix_match_expired),
    Mutation("gw-ledger-skip-first", "gateway",
             "first harvested token never reaches the ledger",
             _mut_gw_ledger_skip_first),
    Mutation("gw-ledger-dup", "gateway",
             "harvest double-appends the first new token",
             _mut_gw_ledger_dup),
    Mutation("breaker-illegal-close", "gateway",
             "open breaker snaps straight to closed (skips half-open)",
             _mut_breaker_illegal_close),
    Mutation("gw-failover-drop-salvage", "gateway",
             "failover drains the dead replica but never redispatches",
             _mut_gw_failover_drop_salvage,
             scope={"hedge": False, "faults": "kill"}),
    Mutation("alloc-ref-noop", "allocator",
             "ref() forgets to bump the refcount (CoW under-count)",
             _mut_alloc_ref_noop),
]}


def run_mutation(name: str, *, scope: int = 1,
                 max_states: int = 400_000) -> ModelResult:
    """Explore the mutation's target model with the bug planted; a
    healthy checker returns at least one counterexample."""
    mut = MUTATIONS[name]
    sc = default_scope(mut.model, scope)
    if mut.scope:
        sc.update(mut.scope)
    with mut.patch():
        model = build_model(mut.model, sc)
        return explore(model, max_states=max_states,
                       max_violations=1)


__all__ = [
    "AllocatorModel", "GatewayModel", "MODEL_NAMES", "MUTATIONS",
    "Mutation", "PrefixCacheModel", "SchedulerModel", "VirtualClock",
    "build_model", "default_scope", "run_mutation",
    "run_protocol_check",
]
