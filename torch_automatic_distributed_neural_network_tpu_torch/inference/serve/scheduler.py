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

A framework-free copy of the JAX package's scheduler, without the parts
whose features the port does not have yet (prefix-cache matching,
adapter pinning, disaggregated KV shipping).  The scheduler owns no
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
    # LoRA tenant by name (serving adapters is a later slice of the
    # port: the engine refuses a named adapter), and its pool slot
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
    # prefix-cache accounting (always 0 until the port has a prefix cache)
    cached_blocks: int = 0
    cached_tokens: int = 0

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
                 spec_lookahead: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.n_slots = n_slots
        self.allocator = allocator
        self.block_size = block_size
        self.admission = admission
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
        the number of tables holding it; no live request holds the null
        block; the live set is exactly the tables' blocks; free + live
        == num_blocks - 1; queued requests hold no blocks."""
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
        live = set(table_count)
        assert live == self.allocator._live, (
            f"allocator live set {sorted(self.allocator._live)} != "
            f"tables {sorted(live)}")
        assert (self.allocator.n_free + len(live)
                == self.allocator.num_blocks - 1), "block leak"
        for b in live:
            assert self.allocator.refcount(b) == table_count[b], (
                f"block {b}: refcount {self.allocator.refcount(b)} != "
                f"{table_count[b]} table holders")
        for r in self.queue:
            assert not r.blocks, (
                f"queued request {r.rid} still holds blocks")

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

    def admit(self) -> list[tuple[int, Request]]:
        """Move queued requests into free slots (FIFO) while the fit
        check passes; returns the (slot, request) pairs admitted this
        step — the engine prefills exactly these."""
        free_slots = [s for s in range(self.n_slots)
                      if self.slots[s] is None]
        if not free_slots or not self.queue:
            return []
        n_admit = admission_plan(
            [(r.n_prompt, r.max_new_tokens) for r in self.queue],
            len(free_slots), self.allocator.n_free,
            block_size=self.block_size, admission=self.admission,
            spec_lookahead=self.spec_lookahead)
        admitted: list[tuple[int, Request]] = []
        for slot in free_slots[:n_admit]:
            req = self.queue.popleft()
            got = self.allocator.acquire(self._blocks_at_admission(req))
            if got is None:
                self.queue.appendleft(req)
                break
            req.blocks = got
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
        self.allocator.free(req.blocks)
        req.blocks = []
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
        self.allocator.free(victim.blocks)
        victim.blocks = []
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
