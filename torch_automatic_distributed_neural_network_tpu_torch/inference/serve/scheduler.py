"""Continuous-batching scheduler: iteration-level admission/eviction.

The unit of scheduling is the *decode step*, not the batch: between any
two steps the scheduler may evict finished sequences (freeing their KV
blocks) and admit queued requests into the vacated slots — new work
joins a running batch without draining it.

Admission is gated by a **static KV fit check** — a request enters a
slot only if the pool can cover its blocks under the chosen policy:

- ``"reserve"`` (default): allocate the WORST-CASE blocks up front
  (prompt + max_new_tokens).  A running request can never hit an
  allocation failure mid-decode, so there is no preemption.
- ``"optimistic"``: allocate only the prompt's blocks at admission and
  grow one block at a time as decode crosses block boundaries.  A
  mid-decode allocation failure **preempts the youngest slot**: its
  blocks are freed and the request is re-queued by ``(priority,
  t_submit, rid)`` to be recomputed from scratch (``Request.preempted``
  counts the restarts).

Under prefix caching (``prefix_cache``, a
:class:`~.prefix_cache.PrefixCache`) admission matches each request's
prompt against the radix index, refs the matched blocks into its table,
charges only the uncached remainder, and evicts cold index leaves before
refusing a request or preempting a slot.

Multi-tenant state rides along: each request may name a LoRA
``adapter``; the scheduler pins it in the ``AdapterPool`` exactly when
the request enters the RUNNING state and unpins on evict, preempt and
requeue, so queued, prefilling and preempted requests never hold a
pinned reference (``check_invariants`` asserts it).  Prefix matches are
keyed by the adapter too (``prefix_cache.block_hashes``): a tenant
reuses only KV computed through its own weights.

A framework-free copy of the JAX package's scheduler, without
disaggregated KV shipping (not ported yet).  The scheduler owns no
device state: it moves ``Request`` objects between queue and slots and
block ids between the allocator and block tables.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Callable, Sequence

from .kv_pool import NULL_BLOCK, BlockAllocator, blocks_for_tokens

IDENTITY_ADAPTER = 0  # the base model's adapter slot

_rid_counter = itertools.count()


# -- pure decision functions --------------------------------------------------
#
# The scheduler's POLICY as plain functions of integers and tuples: no
# Request objects, no allocator, no device.


def blocks_at_admission(n_prompt: int, max_new_tokens: int, *,
                        block_size: int, admission: str,
                        spec_lookahead: int = 0) -> int:
    """KV blocks a request must be granted to enter a slot: the worst
    case under ``reserve``, the prompt's blocks under ``optimistic``."""
    if admission == "reserve":
        return blocks_for_tokens(
            n_prompt + max_new_tokens + spec_lookahead, block_size)
    return blocks_for_tokens(n_prompt, block_size)


def admission_plan(queued: Sequence[tuple], n_free_slots: int,
                   n_free_blocks: int, *, block_size: int, admission: str,
                   spec_lookahead: int = 0, n_evictable: int = 0) -> int:
    """How many queue-front requests to admit this step.

    ``queued`` is the FIFO queue as ``(n_prompt, max_new_tokens[,
    n_cached_tokens])`` tuples.  Walks the front while a free slot
    remains and the pool covers the fit check; stops at the FIRST
    request that does not fit (strict FIFO)."""
    n_admit = 0
    free = int(n_free_blocks) + int(n_evictable)
    for item in queued:
        n_prompt, max_new = item[0], item[1]
        cached_tokens = item[2] if len(item) > 2 else 0
        if n_admit >= n_free_slots:
            break
        need = blocks_at_admission(
            n_prompt, max_new, block_size=block_size,
            admission=admission, spec_lookahead=spec_lookahead)
        need -= cached_tokens // block_size
        if need > free:
            break
        free -= need
        n_admit += 1
    return n_admit


def prefill_schedule(prefilling: Sequence[tuple[float | None, int]],
                     max_chunks: int | None) -> list[int]:
    """Which prefilling slots advance a chunk this step: FIFO by
    ``(t_admit, slot)``, at most ``max_chunks`` of them (None: all)."""
    order = sorted(((t or 0.0), s) for t, s in prefilling)
    if max_chunks is not None:
        order = order[:max_chunks]
    return [s for _, s in order]


def decode_needs_block(n_prompt: int, n_generated: int, n_blocks: int, *,
                       block_size: int, spec_lookahead: int = 0) -> bool:
    """True when a running request's next decode step writes KV beyond
    its owned blocks.  This step writes at absolute position
    ``n_prompt + n_generated - 1`` (the first generated token came from
    prefill, before any paged write) through ``spec_lookahead``
    positions beyond it."""
    pos = n_prompt + n_generated - 1 + spec_lookahead
    return pos // block_size >= n_blocks


def preemption_victim(occupied: Sequence[tuple[float | None, int]]
                      ) -> int | None:
    """The slot to preempt: most recently admitted, earliest slot index
    on ties (``occupied`` is ``(t_admit, slot)`` in slot order).  None
    when no slot is occupied."""
    best_t: float | None = None
    best_slot: int | None = None
    for t, slot in occupied:
        t = t or 0.0
        if best_t is None or t > best_t:
            best_t, best_slot = t, slot
    return best_slot


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle bookkeeping."""

    prompt: list[int]
    max_new_tokens: int
    rid: int = dataclasses.field(
        default_factory=lambda: next(_rid_counter))
    eos_id: int | None = None
    # LoRA tenant: referenced by NAME until the request is running, at
    # which point the scheduler pins it and adapter_idx holds its pool
    # slot (IDENTITY_ADAPTER for base-model requests and all non-running
    # states)
    adapter: str | None = None
    adapter_idx: int = IDENTITY_ADAPTER
    # admission class: lower value is more urgent; queue order is
    # ``(priority, t_submit, rid)`` — strict FIFO within a class
    priority: int = 0

    # lifecycle: queued -> [prefilling ->] running -> done (preemption
    # loops back to queued)
    state: str = "queued"
    slot: int | None = None
    blocks: list[int] = dataclasses.field(default_factory=list)
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    preempted: int = 0
    # prefix-cache accounting, set at admission: the first
    # ``cached_blocks`` entries of ``blocks`` are shared references into
    # KV an earlier request computed (covering ``cached_tokens`` prompt
    # tokens); prefill starts after them and commit skips them
    cached_blocks: int = 0
    cached_tokens: int = 0
    # memoized chained block hashes of the prompt (admission planning
    # re-matches every queued request every step)
    _prefix_keys: list | None = dataclasses.field(
        default=None, repr=False, compare=False)

    # wall-clock marks for the serve.request_done span fields
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    t_admit: float | None = None
    t_first_token: float | None = None
    t_kv_shipped: float | None = None
    t_done: float | None = None
    # per-token emission stamps (scheduler clock); cleared with
    # out_tokens on preemption
    token_walls: list[float] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    # chunked-prefill accounting, cumulative across attempts
    prefill_chunks: int = 0
    prefill_compute_s: float = 0.0
    # wall time spent in attempts that were later thrown away
    lost_s: float = 0.0

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)

    @property
    def n_generated(self) -> int:
        return len(self.out_tokens)

    @property
    def max_tokens_total(self) -> int:
        return self.n_prompt + self.max_new_tokens

    def finished(self) -> bool:
        if self.n_generated >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.out_tokens
                and self.out_tokens[-1] == self.eos_id)


class Scheduler:
    """Queue + slots + block accounting (host-side, no device state)."""

    def __init__(self, *, n_slots: int, allocator: BlockAllocator,
                 block_size: int, admission: str = "reserve",
                 adapter_pool=None, spec_lookahead: int = 0,
                 prefix_cache=None, match_align: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.n_slots = n_slots
        self.allocator = allocator
        self.block_size = block_size
        self.admission = admission
        self.adapter_pool = adapter_pool
        # cross-request prefix reuse; ``match_align`` floors a match to a
        # multiple of this many tokens (>= block_size; the engine passes
        # the prefill-chunk lcm in int8 mode so reuse stays bit-exact)
        self.prefix_cache = prefix_cache
        self.match_align = int(match_align or block_size)
        if self.match_align % block_size:
            raise ValueError(
                f"match_align {self.match_align} must be a multiple of "
                f"block_size {block_size}")
        # speculative decode writes up to `spec_lookahead` extra KV
        # positions per step — block coverage must lead by that much
        self.spec_lookahead = int(spec_lookahead)
        # timestamps come from here so a replay can run on virtual time
        self.clock = clock
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self.n_finished = 0
        self.n_preemptions = 0

    # -- introspection -------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def n_decoding(self) -> int:
        """Slots actively decoding (excludes chunked-prefill slots)."""
        return sum(r is not None and r.state == "running"
                   for r in self.slots)

    @property
    def n_prefilling(self) -> int:
        return sum(r is not None and r.state == "prefilling"
                   for r in self.slots)

    def idle(self) -> bool:
        return self.n_active == 0 and not self.queue

    def check_invariants(self) -> None:
        """Structural invariants; raises AssertionError on violation.

        A block appears at most once per table and its refcount equals
        the number of tables holding it plus one if the radix index
        holds it; no live request (nor the index) holds the null block;
        the live set is exactly tables union index; free + live ==
        num_blocks - 1; queued requests hold no blocks."""
        table_count: dict[int, int] = {}
        for r in self.slots:
            if r is None:
                continue
            mine: set[int] = set()
            for b in r.blocks:
                assert b != NULL_BLOCK, (
                    f"request {r.rid} holds the null block")
                assert b not in mine, (
                    f"block {b} twice on request {r.rid}'s table")
                mine.add(b)
                table_count[b] = table_count.get(b, 0) + 1
            assert r.cached_blocks <= len(r.blocks)
        index_blocks = (self.prefix_cache.blocks()
                        if self.prefix_cache is not None else set())
        assert NULL_BLOCK not in index_blocks, (
            "radix index holds the null block")
        live = set(table_count) | index_blocks
        assert live == self.allocator._live, (
            f"allocator live set {sorted(self.allocator._live)} != "
            f"tables+index {sorted(live)}")
        assert (self.allocator.n_free + len(live)
                == self.allocator.num_blocks - 1), "block leak"
        for b in live:
            want = table_count.get(b, 0) + (1 if b in index_blocks else 0)
            assert self.allocator.refcount(b) == want, (
                f"block {b}: refcount {self.allocator.refcount(b)} != "
                f"{table_count.get(b, 0)} table holders "
                f"+ {int(b in index_blocks)} index reference")
        for r in self.queue:
            assert not r.blocks, (
                f"queued request {r.rid} still holds blocks")
        # adapter pins back live decode reads ONLY: a slot pins exactly
        # while running, so preemption and eviction never leak a pin
        for r in self.slots:
            if r is not None and r.state != "running":
                assert r.adapter_idx == IDENTITY_ADAPTER, (
                    f"{r.state} request {r.rid} holds a pinned adapter "
                    f"reference (idx {r.adapter_idx})")
        for r in self.queue:
            assert r.adapter_idx == IDENTITY_ADAPTER, (
                f"queued/preempted request {r.rid} holds a pinned "
                f"adapter reference (idx {r.adapter_idx})")
        if self.adapter_pool is not None:
            want: dict[str, int] = {}
            for r in self.slots:
                if (r is not None and r.state == "running"
                        and r.adapter is not None
                        and r.adapter_idx != IDENTITY_ADAPTER):
                    want[r.adapter] = want.get(r.adapter, 0) + 1
            have = self.adapter_pool.allocator.pinned_names()
            assert want == have, (
                f"adapter pin leak: running slots pin {want}, pool "
                f"holds {have}")

    # -- admission / eviction ------------------------------------------------

    @staticmethod
    def _queue_key(req: Request) -> tuple[int, float, int]:
        return (req.priority, req.t_submit, req.rid)

    def submit(self, req: Request) -> None:
        req.state = "queued"
        # priority-ordered insert: FIFO within a class; with the default
        # priority 0 everywhere this is a plain append
        if not self.queue or self._queue_key(self.queue[-1]) < \
                self._queue_key(req):
            self.queue.append(req)
        else:
            self._requeue_fifo(req)

    def _blocks_at_admission(self, req: Request) -> int:
        return blocks_at_admission(
            req.n_prompt, req.max_new_tokens, block_size=self.block_size,
            admission=self.admission, spec_lookahead=self.spec_lookahead)

    def _requeue_fifo(self, req: Request) -> None:
        """Re-insert by ``(priority, t_submit, rid)``: a bounced request
        rejoins exactly where its class and arrival put it."""
        key = self._queue_key(req)
        idx = next((i for i, r in enumerate(self.queue)
                    if self._queue_key(r) > key), len(self.queue))
        self.queue.insert(idx, req)

    # -- adapter pins --------------------------------------------------------

    def pin_adapter(self, req: Request) -> dict | None:
        """Pin ``req``'s adapter for decode; called exactly at the
        transition into the RUNNING state.  Returns a fault-info dict
        ({} for base-model requests), or None when every pool slot is
        pinned by other running requests — the caller must NOT run the
        request (the engine requeues it)."""
        if req.adapter is None or self.adapter_pool is None:
            return {}
        got = self.adapter_pool.acquire(req.adapter)
        if got is None:
            return None
        slot, was_resident, evicted = got
        req.adapter_idx = slot
        return {"idx": slot, "hit": was_resident, "evicted": evicted}

    def unpin_adapter(self, req: Request) -> None:
        if req.adapter_idx != IDENTITY_ADAPTER and req.adapter is not None:
            assert self.adapter_pool is not None
            self.adapter_pool.release(req.adapter)
        req.adapter_idx = IDENTITY_ADAPTER

    def requeue(self, slot: int) -> Request:
        """Bounce a slot's request back to the queue (blocks freed,
        recompute-style): the adapter-stall path, where its prefill
        finished but every adapter pool slot is pinned by other running
        requests.  Counted as a preemption."""
        req = self.slots[slot]
        assert req is not None, f"requeue of empty slot {slot}"
        self.unpin_adapter(req)
        self.allocator.free(req.blocks)
        req.blocks = []
        req.cached_blocks = req.cached_tokens = 0
        req.slot = None
        req.state = "queued"
        req.out_tokens = []
        req.token_walls = []
        if req.t_admit is not None:
            req.lost_s += max(0.0, self.clock() - req.t_admit)
        req.preempted += 1
        self.n_preemptions += 1
        self.slots[slot] = None
        self._requeue_fifo(req)
        return req

    def match_prefix(self, req: Request) -> tuple[list[int], int]:
        """The request's longest reusable prompt prefix in the radix
        index, capped so at least one prompt token is recomputed (the
        final chunk must produce first-token logits) and floored to
        ``match_align`` tokens.  The keys commit to the request's
        adapter, so a tenant matches only blocks its own weights
        computed."""
        if self.prefix_cache is None:
            return [], 0
        if req._prefix_keys is None:
            from .prefix_cache import block_hashes

            req._prefix_keys = block_hashes(req.prompt, self.block_size,
                                            adapter=req.adapter)
        cap = ((req.n_prompt - 1) // self.match_align) * self.match_align
        return self.prefix_cache.match(req.prompt, max_tokens=cap,
                                       keys=req._prefix_keys)

    def admit(self) -> list[tuple[int, Request]]:
        """Move queued requests into free slots (FIFO) while the fit
        check passes; returns the (slot, request) pairs admitted this
        step — the engine prefills exactly these.

        Under prefix caching each admitted request refs its matched
        blocks (shared, already resident) and allocates only the
        uncached remainder; the plan may count on index eviction, so a
        shortfall reclaims cold leaves before granting."""
        free_slots = [s for s in range(self.n_slots)
                      if self.slots[s] is None]
        if not free_slots or not self.queue:
            return []
        pc = self.prefix_cache
        n_admit = admission_plan(
            [(r.n_prompt, r.max_new_tokens, self.match_prefix(r)[1])
             for r in self.queue],
            len(free_slots), self.allocator.n_free,
            block_size=self.block_size, admission=self.admission,
            spec_lookahead=self.spec_lookahead,
            n_evictable=(pc.n_evictable() if pc is not None else 0))
        admitted: list[tuple[int, Request]] = []
        for slot in free_slots[:n_admit]:
            req = self.queue.popleft()
            matched, n_cached = self.match_prefix(req)
            # ref matched blocks first: the eviction that makes room for
            # the fresh remainder must not reclaim them
            for b in matched:
                self.allocator.ref(b)
            need = self._blocks_at_admission(req) - len(matched)
            short = need - self.allocator.n_free
            if short > 0 and pc is not None:
                pc.evict(short)
            got = self.allocator.acquire(need)
            if got is None:
                # an eviction shrank a later match the plan counted on;
                # undo and keep strict FIFO (retry next step)
                self.allocator.release(matched)
                self.queue.appendleft(req)
                break
            if pc is not None:
                pc.record_query(n_cached)
            req.blocks = matched + got
            req.cached_blocks = len(matched)
            req.cached_tokens = n_cached
            req.slot = slot
            req.state = "running"
            req.out_tokens = []
            req.t_admit = self.clock()
            self.slots[slot] = req
            admitted.append((slot, req))
        return admitted

    def prefill_plan(self, max_chunks: int | None
                     ) -> list[tuple[int, Request]]:
        """The prefilling slots due a chunk this step: FIFO by admission
        time, at most ``max_chunks`` of them."""
        by_slot = {r.slot: r for r in self.slots
                   if r is not None and r.state == "prefilling"}
        order = prefill_schedule(
            [(r.t_admit, s) for s, r in by_slot.items()], max_chunks)
        return [(slot, by_slot[slot]) for slot in order]

    def evict(self, slot: int) -> Request:
        """Finished request out of its slot; blocks back to the pool."""
        req = self.slots[slot]
        assert req is not None, f"evict of empty slot {slot}"
        self.unpin_adapter(req)
        self.allocator.free(req.blocks)
        req.blocks = []
        req.cached_blocks = req.cached_tokens = 0
        req.slot = None
        req.state = "done"
        req.t_done = self.clock()
        self.slots[slot] = None
        self.n_finished += 1
        return req

    def preempt_youngest(self) -> Request | None:
        """Free the most-recently-admitted slot's blocks and requeue it
        in FIFO submission order (it regenerates from scratch).  Returns
        the victim, or None when no slot is occupied."""
        slot = preemption_victim(
            [(r.t_admit, r.slot) for r in self.slots if r is not None])
        if slot is None:
            return None
        victim = self.slots[slot]
        assert victim is not None
        self.unpin_adapter(victim)
        self.allocator.free(victim.blocks)
        victim.blocks = []
        victim.cached_blocks = victim.cached_tokens = 0
        victim.slot = None
        victim.state = "queued"
        victim.out_tokens = []
        victim.token_walls = []
        if victim.t_admit is not None:
            victim.lost_s += max(0.0, self.clock() - victim.t_admit)
        victim.preempted += 1
        self.n_preemptions += 1
        self.slots[slot] = None
        self._requeue_fifo(victim)
        return victim

    def grow_for_step(self) -> list[Any]:
        """Optimistic mode: before a decode step, every running request
        about to write tokens through ``ctx + spec_lookahead`` must own
        block ``(ctx + spec_lookahead) // bs``.  Grows tables one block
        at a time; on allocation failure, preempts the youngest slot and
        retries.  Returns the requests that were preempted."""
        preempted: list[Request] = []
        if self.admission != "optimistic":
            return preempted
        for slot in range(self.n_slots):
            while True:
                req = self.slots[slot]
                if req is None or req.state != "running":
                    break
                if not decode_needs_block(
                        req.n_prompt, req.n_generated, len(req.blocks),
                        block_size=self.block_size,
                        spec_lookahead=self.spec_lookahead):
                    break
                got = self.allocator.alloc(1)
                if got is None and self.prefix_cache is not None:
                    # drop cold reusable KV before touching live work
                    if self.prefix_cache.evict(1):
                        got = self.allocator.alloc(1)
                if got is not None:
                    req.blocks.extend(got)
                    continue  # lookahead may span a second block
                victim = self.preempt_youngest()
                if victim is None:
                    raise RuntimeError(
                        "cannot grow KV blocks with no slot to preempt")
                preempted.append(victim)
                # if we preempted OURSELVES the slot is now empty and
                # the outer loop moves on
        return preempted
