"""Prefix cache: the PyTorch port's radix index, scheduler admission and
engine against the JAX package's, on the same operation sequences.

Host side: every case of ``tests/test_prefix_cache.py`` that needs no
device, written once as a scenario over a namespace of classes and run
twice, on the JAX package's ``PrefixCache`` / ``BlockAllocator`` /
``Scheduler`` and on the port's.  Each scenario keeps the JAX test's own
assertions and returns a trace of what it observed (matches, evictions,
expiries, hit counts, refcounts); the two traces must be equal.  A seeded
random sequence of insert / match / release / evict / clock steps with
leases is compared the same way.

Engine: ``ServeEngine(prefix_cache=True)`` on a shared-prefix request set
(fp and int8 KV, optimistic admission with preemption, a manufactured
shared write block), the port's tokens and ``prefix_*`` / ``cow_forks``
counters equal to the JAX engine's with the same options, and cache-on
tokens equal to cache-off.  Tolerance: none (token ids and integer
counters, compared exactly).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    BlockAllocator as JaxAllocator,
    PrefixCache as JaxPrefixCache,
    Request as JaxRequest,
    Scheduler as JaxScheduler,
    ServeEngine as JaxEngine,
    block_hashes as jax_block_hashes,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2
from torch_automatic_distributed_neural_network_tpu.obs.journal import (
    Journal as JaxJournal,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    BlockAllocator,
    PrefixCache,
    Request,
    Scheduler,
    ServeEngine,
    block_hashes,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
)

JAX = types.SimpleNamespace(
    BlockAllocator=JaxAllocator, PrefixCache=JaxPrefixCache,
    Request=JaxRequest, Scheduler=JaxScheduler,
    block_hashes=jax_block_hashes, Journal=JaxJournal)
PORT = types.SimpleNamespace(
    BlockAllocator=BlockAllocator, PrefixCache=PrefixCache,
    Request=Request, Scheduler=Scheduler, block_hashes=block_hashes,
    Journal=Journal)
VOCAB = 128


# -- host-side scenarios: the cases of tests/test_prefix_cache.py ------------


def _mk_index(ns, num_blocks=16, block_size=8):
    alloc = ns.BlockAllocator(num_blocks)
    clock = [0.0]
    pc = ns.PrefixCache(block_size=block_size, allocator=alloc,
                        clock=lambda: clock[0])
    return pc, alloc, clock


def block_hashes_full_blocks_only(ns):
    bh = ns.block_hashes
    assert bh([], 8) == [] and bh([1] * 7, 8) == []
    assert len(bh([1] * 8, 8)) == 1 and len(bh([1] * 17, 8)) == 2
    return [bh(list(range(40)), 8), bh([3] * 17, 8)]


def block_hashes_chain_commits_to_whole_prefix(ns):
    a = ns.block_hashes([1] * 8 + [9] * 8, 8)
    b = ns.block_hashes([2] * 8 + [9] * 8, 8)
    assert a[0] != b[0] and a[1] != b[1]
    assert a == ns.block_hashes([1] * 8 + [9] * 8, 8)
    return [a, b]


def insert_then_match_and_chain_break(ns):
    pc, alloc, _ = _mk_index(ns)
    owner = alloc.acquire(2)
    trace = [owner, pc.insert([1] * 8 + [9] * 8, owner), pc.n_blocks]
    trace += [pc.match([1] * 8 + [9] * 8), pc.match([1] * 8 + [7] * 8),
              pc.match([2] * 8 + [9] * 8),
              pc.match([1] * 8 + [9] * 8, max_tokens=15)]
    assert trace[3] == (owner, 16) and trace[4] == (owner[:1], 8)
    assert trace[5] == ([], 0) and trace[6] == (owner[:1], 8)
    assert all(alloc.refcount(b) == 2 for b in owner)
    return trace + [[alloc.refcount(b) for b in owner]]


def insert_first_publisher_wins(ns):
    pc, alloc, _ = _mk_index(ns)
    first, dup = alloc.acquire(1), alloc.acquire(1)
    trace = [pc.insert([5] * 8, first), pc.insert([5] * 8, dup),
             pc.match([5] * 8), alloc.refcount(first[0]),
             alloc.refcount(dup[0])]
    assert trace[:2] == [1, 0] and trace[2][0] == first
    assert trace[3:] == [2, 1]
    return trace


def evict_lru_leaves_only_and_exposes_parents(ns):
    pc, alloc, _ = _mk_index(ns)
    owner = alloc.acquire(3)
    pc.insert([1] * 24, owner)
    alloc.release(owner)
    trace = [pc.n_evictable(), pc.evict(1), pc.n_blocks,
             pc.match([1] * 24), pc.evict(5), pc.n_blocks, alloc.n_live]
    assert trace[:3] == [3, 1, 2] and trace[3] == (owner[:2], 16)
    assert trace[4:] == [2, 0, 0]
    return trace


def evict_skips_referenced_blocks_and_orders_by_last_hit(ns):
    pc, alloc, clock = _mk_index(ns)
    cold, hot, pinned = alloc.acquire(1), alloc.acquire(1), alloc.acquire(1)
    pc.insert([1] * 8, cold)
    clock[0] = 1.0
    pc.insert([2] * 8, hot)
    pc.insert([3] * 8, pinned)
    alloc.release(cold)
    alloc.release(hot)
    clock[0] = 2.0
    trace = [pc.match([2] * 8), pc.n_evictable(), pc.evict(1),
             pc.match([1] * 8), pc.match([2] * 8), pc.evict(5),
             pc.match([3] * 8)]
    assert trace[1:3] == [2, 1] and trace[3] == ([], 0)
    assert trace[4][1] == 8 and trace[5] == 1 and trace[6][1] == 8
    alloc.release(pinned)
    trace += [pc.clear(), alloc.n_live]
    assert trace[-2:] == [1, 0]
    return trace


def release_stays_loud_through_sharing(ns):
    a = ns.BlockAllocator(8)
    got = a.acquire(2)
    for b in got:
        a.ref(b)
    a.release(got)
    trace = [[a.refcount(b) for b in got]]
    a.release(got)
    trace.append(a.n_live)
    with pytest.raises(ValueError, match="double-free|not currently"):
        a.release(got)
    trace.append(a.n_free)
    assert trace == [[1, 1], 0, 7]
    return trace


def acquire_fork_release_churn_no_leaks(ns):
    rs = np.random.RandomState(11)
    a = ns.BlockAllocator(24)
    held, trace = [], []
    for _ in range(600):
        r = rs.rand()
        if held and r < 0.45:
            a.release([held.pop(rs.randint(len(held)))])
        elif held and r < 0.65:
            b = held[rs.randint(len(held))]
            a.ref(b)
            held.append(b)
        else:
            got = a.acquire(int(rs.randint(1, 4)))
            trace.append(got)
            if got is not None:
                held.extend(got)
        counts: dict[int, int] = {}
        for b in held:
            counts[b] = counts.get(b, 0) + 1
        assert counts == {b: a.refcount(b) for b in set(held)}
        assert a.n_free + len(set(held)) == 23
    for b in held:
        a.release([b])
    assert a.n_free == 23 and a.n_live == 0
    return trace


def _sched_with_cache(ns, num_blocks, n_slots=2, block_size=8):
    alloc = ns.BlockAllocator(num_blocks)
    pc = ns.PrefixCache(block_size=block_size, allocator=alloc)
    s = ns.Scheduler(n_slots=n_slots, allocator=alloc,
                     block_size=block_size, prefix_cache=pc)
    return s, pc, alloc


def admit_refs_matched_blocks_and_charges_suffix_only(ns):
    s, pc, alloc = _sched_with_cache(ns, num_blocks=8)
    seed = alloc.acquire(2)
    pc.insert([1] * 16, seed)
    alloc.release(seed)
    s.submit(ns.Request(prompt=[1] * 16 + [2] * 4, max_new_tokens=4))
    (slot, req), = s.admit()
    assert req.cached_tokens == 16 and req.cached_blocks == 2
    assert req.blocks[:2] == seed
    s.check_invariants()
    trace = [slot, list(req.blocks), req.cached_tokens,
             [alloc.refcount(b) for b in seed], alloc.n_free,
             pc.queries, pc.hit_requests, pc.hit_tokens]
    req.out_tokens = [5] * 4
    s.evict(slot)
    s.check_invariants()
    trace += [alloc.n_free, pc.n_blocks]
    assert trace[-2] == trace[4] + 1 and trace[-1] == 2
    return trace


def admission_evicts_cold_index_leaves_before_refusing(ns):
    s, pc, alloc = _sched_with_cache(ns, num_blocks=6)
    seed = alloc.acquire(4)
    pc.insert([9] * 32, seed)
    alloc.release(seed)
    s.submit(ns.Request(prompt=[1] * 10, max_new_tokens=4))
    admitted = s.admit()
    assert len(admitted) == 1 and pc.evicted_blocks > 0
    s.check_invariants()
    return [[list(r.blocks) for _, r in admitted], pc.evicted_blocks,
            pc.n_blocks, alloc.n_free]


def check_invariants_catches_index_refcount_drift(ns):
    s, pc, alloc = _sched_with_cache(ns, num_blocks=8)
    seed = alloc.acquire(1)
    pc.insert([4] * 8, seed)
    alloc.release(seed)
    s.check_invariants()
    alloc.release([seed[0]])  # drop the index's ref behind its back
    with pytest.raises(AssertionError):
        s.check_invariants()
    return [seed]


def ttl_expiry_is_lazy_and_journaled(ns):
    alloc = ns.BlockAllocator(16)
    clock = [0.0]
    jnl = ns.Journal(None, host0_only=False)
    pc = ns.PrefixCache(block_size=8, allocator=alloc,
                        clock=lambda: clock[0], journal=jnl)
    leased, forever = alloc.acquire(2), alloc.acquire(1)
    pc.insert([1] * 16, leased, ttl_s=5.0)
    pc.insert([2] * 8, forever)
    alloc.release(leased)
    alloc.release(forever)
    clock[0] = 4.9
    trace = [pc.match([1] * 16), pc.expired_blocks]
    clock[0] = 5.1
    trace += [pc.match([1] * 16), pc.expired_blocks, pc.match([2] * 8)]
    assert trace[0][1] == 16 and trace[1] == 0
    assert trace[2] == ([], 0) and trace[3] == 2 and trace[4][1] == 8
    expire = [(r["kind"], r["n_blocks"], r["index_blocks"])
              for r in jnl.records if r.get("name") == "serve.prefix"]
    assert expire == [("expire", 2, 1)]
    return trace + expire


def ttl_republish_refreshes_lease(ns):
    pc, alloc, clock = _mk_index(ns)
    owner = alloc.acquire(1)
    pc.insert([1] * 8, owner, ttl_s=5.0)
    clock[0] = 4.0
    dup = alloc.acquire(1)
    pc.insert([1] * 8, dup, ttl_s=5.0)
    alloc.release(owner)
    alloc.release(dup)
    clock[0] = 6.0
    trace = [pc.match([1] * 8)]
    clock[0] = 9.5
    trace += [pc.match([1] * 8), pc.expired_blocks]
    assert trace[0][1] == 8 and trace[1] == ([], 0) and trace[2] == 1
    return trace


def ttl_evict_counts_expired_toward_shortfall(ns):
    pc, alloc, clock = _mk_index(ns)
    leased = alloc.acquire(2)
    pc.insert([1] * 16, leased, ttl_s=1.0)
    alloc.release(leased)
    clock[0] = 2.0
    trace = [pc.evict(1), pc.n_blocks, alloc.n_live]
    assert trace == [2, 0, 0]
    return trace


def ttl_referenced_blocks_stop_serving_but_free_lazily(ns):
    pc, alloc, clock = _mk_index(ns)
    owner = alloc.acquire(1)
    pc.insert([1] * 8, owner, ttl_s=1.0)
    clock[0] = 5.0
    trace = [pc.match([1] * 8), pc.expire(), pc.n_blocks]
    alloc.release(owner)
    trace += [pc.expire(), pc.n_blocks, alloc.n_live]
    assert trace == [([], 0), 0, 1, 1, 0, 0]
    return trace


def random_operation_sequence(ns):
    """Seeded inserts of prompts over a few shared stems (with and
    without leases), matches, releases of owners, evictions and clock
    steps: every observable, step by step."""
    rs = np.random.RandomState(5)
    pc, alloc, clock = _mk_index(ns, num_blocks=40, block_size=4)
    stems = [[int(t) for t in rs.randint(1, 6, size=12)] for _ in range(3)]
    owners: list[list[int]] = []
    trace = []
    for _ in range(300):
        op = rs.randint(5)
        prompt = (stems[rs.randint(3)][:4 * rs.randint(1, 4)]
                  + [int(t) for t in rs.randint(1, 6, size=rs.randint(5))])
        if op == 0:
            got = alloc.acquire(len(prompt) // 4)
            if got:
                ttl = None if rs.rand() < 0.5 else float(rs.randint(1, 6))
                trace.append(("insert", pc.insert(prompt, got, ttl_s=ttl)))
                owners.append(got)
        elif op == 1:
            trace.append(("match", pc.match(prompt,
                                            max_tokens=rs.randint(0, 20))))
            pc.record_query(trace[-1][1][1])
        elif op == 2 and owners:
            alloc.release(owners.pop(rs.randint(len(owners))))
        elif op == 3:
            trace.append(("evict", pc.evict(int(rs.randint(1, 4)))))
        else:
            clock[0] += float(rs.rand() * 2)
            trace.append(("expire", pc.expire()))
        trace.append((pc.n_blocks, pc.n_evictable(), alloc.n_free))
    trace.append((pc.queries, pc.hit_requests, pc.hit_tokens,
                  pc.inserted_blocks, pc.evicted_blocks, pc.expired_blocks))
    return trace


SCENARIOS = [
    block_hashes_full_blocks_only,
    block_hashes_chain_commits_to_whole_prefix,
    insert_then_match_and_chain_break,
    insert_first_publisher_wins,
    evict_lru_leaves_only_and_exposes_parents,
    evict_skips_referenced_blocks_and_orders_by_last_hit,
    release_stays_loud_through_sharing,
    acquire_fork_release_churn_no_leaks,
    admit_refs_matched_blocks_and_charges_suffix_only,
    admission_evicts_cold_index_leaves_before_refusing,
    check_invariants_catches_index_refcount_drift,
    ttl_expiry_is_lazy_and_journaled,
    ttl_republish_refreshes_lease,
    ttl_evict_counts_expired_toward_shortfall,
    ttl_referenced_blocks_stop_serving_but_free_lazily,
    random_operation_sequence,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_prefix_index_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


# -- the engine ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def model_pair():
    jm = GPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32,
              remat=False)
    variables = jm.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))
    tm = decoder_from_jax_params(
        jax.tree.map(np.asarray, variables["params"]),
        gpt2_config("test", vocab_size=VOCAB, max_seq_len=64,
                    dtype=torch.float32), device="cpu")
    return jm, variables, tm


def _mix(seed, n, shared_len, unique_len):
    rs = np.random.RandomState(seed)
    shared = [int(t) for t in rs.randint(1, VOCAB, size=(shared_len,))]
    return [shared + [int(t) for t in rs.randint(1, VOCAB,
                                                 size=(unique_len,))]
            for _ in range(n)]


_COUNTERS = ("prefix_queries", "prefix_hits", "prefix_cached_tokens",
             "prefix_saved_chunks", "cow_forks")


def _serve(eng, prompts, max_new, eos_id=0):
    reqs = [eng.submit(p, max_new_tokens=max_new, eos_id=eos_id)
            for p in prompts]
    eng.run()
    eng.scheduler.check_invariants()
    counters = {c: getattr(eng, c) for c in _COUNTERS}
    if eng.prefix_cache is not None:
        # only the index's references outlive the requests
        n_index = eng.prefix_cache.n_blocks
        assert eng.pool.allocator.n_live == n_index
        counters["index_blocks"] = n_index
        assert eng.prefix_cache.clear() == n_index
    assert eng.pool.allocator.n_live == 0
    return [r.out_tokens for r in reqs], counters


ENGINE_CASES = {
    "fp": dict(kw={}, mix=(3, 6, 24, 9), max_new=6),
    "int8-kv": dict(kw=dict(quant_kv=True), mix=(4, 6, 24, 9), max_new=6),
    "optimistic-preemption": dict(
        kw=dict(num_blocks=14, admission="optimistic"), mix=(6, 5, 16, 5),
        max_new=8),
}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_prefix_cache_matches_jax(case):
    """Tokens and prefix counters equal to the JAX engine's with the same
    options (its dense decode path), for the port's paged and dense
    decode; and equal to the port's own cache-off run."""
    spec = ENGINE_CASES[case]
    jm, variables, tm = model_pair()
    prompts = _mix(*spec["mix"])
    geom = dict(n_slots=3, max_len=64, block_size=8, prefill_chunk=8,
                **spec["kw"])
    want, jcount = _serve(
        JaxEngine(jm, variables, attention_impl="dense", prefix_cache=True,
                  **geom), prompts, spec["max_new"])
    assert jcount["prefix_hits"] > 0
    for impl in ("paged", "dense"):
        eng = ServeEngine(tm, device="cpu", attention_impl=impl,
                          prefix_cache=True, **geom)
        got, count = _serve(eng, prompts, spec["max_new"])
        assert got == want, impl
        assert count == jcount, impl
    off, _ = _serve(ServeEngine(tm, device="cpu", **geom), prompts,
                    spec["max_new"])
    assert off == want


def test_cow_fork_on_manufactured_block_sharing_matches_jax():
    """Alias a running request's next write block into a second owner:
    both engines fork it before the write, and decode on."""
    jm, variables, tm = model_pair()
    geom = dict(n_slots=1, max_len=64, block_size=8, prefill_chunk=8,
                prefix_cache=True)
    outs = []
    for eng in (JaxEngine(jm, variables, attention_impl="dense", **geom),
                ServeEngine(tm, device="cpu", journal=Journal(
                    None, host0_only=False), **geom)):
        req = eng.submit([2] * 12, max_new_tokens=8, eos_id=None)
        while req.state != "running":
            eng.step()
        bi = (req.n_prompt + req.n_generated - 1) // 8
        b = req.blocks[bi]
        eng.pool.allocator.ref(b)  # a manufactured second owner
        eng.step()
        assert eng.cow_forks == 1 and req.blocks[bi] != b
        eng.pool.allocator.release([b])
        eng.run()
        assert req.n_generated == 8
        eng.scheduler.check_invariants()
        outs.append((req.out_tokens, eng.cow_forks))
    assert outs[1] == outs[0]
    cow = [r for r in eng.journal.records if r.get("name") == "serve.prefix"
           and r.get("kind") == "cow"]
    assert len(cow) == 1


def test_engine_prefix_cache_needs_chunked_prefill():
    _, _, tm = model_pair()
    with pytest.raises(ValueError, match="chunked prefill"):
        ServeEngine(tm, device="cpu", max_len=64, prefix_cache=True,
                    prefill_chunk=None)
