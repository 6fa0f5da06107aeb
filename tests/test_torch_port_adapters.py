"""Multi-tenant LoRA serving in the PyTorch port: the adapter allocator
and pool (``inference/serve/adapters.py``), adapter pins through the
scheduler, the engine's per-slot LoRA delta, and prefix-cache keys that
commit to the adapter — against the JAX package on the same weights and
the same tenants (carried across with ``interop.lora_from_jax``).

Exact agreement throughout: allocator decisions, pin accounting and
pool byte counts are integer bookkeeping; greedy fp32 serving gives the
JAX engine's tokens and, request by request, the tokens of the port's
``generate`` on the tenant's merged weights (``merge_lora``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    ServeEngine as JaxEngine,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    adapters as jadapters,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    kv_pool as jpool,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    scheduler as jsched,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2
from torch_automatic_distributed_neural_network_tpu.training import lora as jlora
from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
    generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    IDENTITY_ADAPTER,
    AdapterAllocator,
    AdapterPool,
    BlockAllocator,
    Request,
    Scheduler,
    ServeEngine,
    factor_rows,
    pool_adapter_bytes,
    random_adapter,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    lora_from_jax,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import Journal
from torch_automatic_distributed_neural_network_tpu_torch.training.lora import (
    LoraSpec,
    MLP_LIKE,
    merge_lora,
)

VOCAB = 128
JSPEC, SPEC = jlora.LoraSpec(rank=4), LoraSpec(rank=4)


@functools.lru_cache(maxsize=None)
def models():
    """A JAX GPT-2 ``test`` decoder (fp32) and the port's copy of it."""
    jm = GPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32,
              remat=False)
    variables = jm.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))
    cfg = gpt2_config("test", vocab_size=VOCAB, max_seq_len=64,
                      dtype=torch.float32)
    tm = decoder_from_jax_params(jax.tree.map(np.asarray, variables["params"]),
                                 cfg, device="cpu")
    return jm, variables, tm


@functools.lru_cache(maxsize=None)
def tenant(seed, scale=0.02):
    """JAX's seeded random tenant, and the same factors in the port."""
    _, variables, tm = models()
    jl = jadapters.random_adapter(variables["params"], JSPEC, seed=seed,
                                  scale=scale)
    return jl, lora_from_jax(jax.tree.map(np.asarray, jl), tm.cfg.n_layers)


def _merged_reference(tm, lora, prompt, max_new):
    """The port's ``generate`` on the tenant's merged weights (None: the
    base model)."""
    model = tm
    if lora is not None:
        model = DecoderLM(tm.cfg)
        model.load_state_dict(merge_lora(tm, lora, SPEC))
    out = generate(model, torch.tensor([prompt]), max_new_tokens=max_new)
    return out[0, len(prompt):].tolist()


# -- the allocator: JAX's cases, run on both packages --------------------------

ALLOCATORS = {"jax": jadapters.AdapterAllocator, "port": AdapterAllocator}


@pytest.mark.parametrize("side", sorted(ALLOCATORS))
def test_adapter_allocator_lru_pins_and_eviction(side):
    a = ALLOCATORS[side](4)  # slots 1..3 for tenants, 0 = identity
    s1, res1, ev1 = a.acquire("t1")
    s2, _, _ = a.acquire("t2")
    s3, _, _ = a.acquire("t3")
    assert {s1, s2, s3} == {1, 2, 3} and not res1 and ev1 is None
    assert a.acquire("t4") is None  # everything pinned: no eviction
    a.release("t1")
    s4, res4, ev4 = a.acquire("t4")  # evicts the LRU unpinned (t1)
    assert s4 == s1 and not res4 and ev4 == "t1"
    assert a.evictions == 1
    a.release("t2")
    s2b, res2b, _ = a.acquire("t2")  # a released resident stays warm
    assert s2b == s2 and res2b
    assert a.hits == 1 and a.faults == 4
    assert a.hit_rate == pytest.approx(1 / 5)


@pytest.mark.parametrize("side", sorted(ALLOCATORS))
def test_adapter_allocator_loud_release_and_invalidate(side):
    a = ALLOCATORS[side](3)
    a.acquire("x")
    with pytest.raises(ValueError, match="no pinned reference"):
        a.release("never-acquired")
    with pytest.raises(ValueError, match="pinned"):
        a.invalidate("x")  # live decode reads those factors
    a.release("x")
    with pytest.raises(ValueError, match="no pinned reference"):
        a.release("x")  # double release is loud
    a.invalidate("x")
    assert a.slot_of("x") is None and a.n_resident == 0
    a.invalidate("x")  # idempotent once gone
    with pytest.raises(ValueError, match="identity"):
        ALLOCATORS[side](1)


def test_adapter_allocator_churn_matches_jax():
    """500 random acquire/release/invalidate rounds on both allocators:
    the same decisions, refcounts and LRU order, and no leak."""
    rs = np.random.RandomState(11)
    cap = 5
    ja, ta = jadapters.AdapterAllocator(cap + 1), AdapterAllocator(cap + 1)
    pins: dict[str, int] = {}
    names = [f"t{i}" for i in range(9)]
    for _ in range(500):
        roll = rs.rand()
        name = names[rs.randint(len(names))]
        if roll < 0.5:
            got = ta.acquire(name)
            assert got == ja.acquire(name)
            if got is None:
                assert ta.n_pinned == cap
            else:
                pins[name] = pins.get(name, 0) + 1
        elif roll < 0.9:
            pinned = [n for n, c in pins.items() if c > 0]
            if pinned:
                victim = pinned[rs.randint(len(pinned))]
                ta.release(victim)
                ja.release(victim)
                pins[victim] -= 1
        else:
            idle = [n for n in names
                    if ta.slot_of(n) is not None and not pins.get(n)]
            if idle:
                victim = idle[rs.randint(len(idle))]
                ta.invalidate(victim)
                ja.invalidate(victim)
        assert ta.pinned_names() == {n: c for n, c in pins.items() if c}
        assert ta._order == ja._order and ta._free == ja._free
        assert ta.n_resident + len(ta._free) == cap
    assert (ta.hits, ta.faults, ta.evictions) == (ja.hits, ja.faults,
                                                  ja.evictions)


# -- the pool ------------------------------------------------------------------


def test_pool_register_validates_sites_and_shapes():
    _, _, tm = models()
    pool = AdapterPool(tm, SPEC, n_adapters=3, device="cpu")
    _, good = tenant(3)
    pool.register("ok", good)
    assert pool.has("ok") and pool.names == ("ok",)
    assert pool.sites == {"q": (2, 128, 128), "v": (2, 128, 128)}
    wrong_rank = random_adapter(tm, LoraSpec(rank=2), seed=3)
    with pytest.raises(ValueError, match="do not match the pool"):
        pool.register("bad-rank", wrong_rank)
    partial = {k: v for k, v in good.items() if "q_proj" in k}
    with pytest.raises(ValueError, match="do not match the pool"):
        pool.register("missing-v", partial)
    with pytest.raises(NotImplementedError, match="attention projections"):
        AdapterPool(tm, LoraSpec(targets=(MLP_LIKE,)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 2"):
        AdapterPool(tm, SPEC, mesh=object(), device="cpu")
    with pytest.raises(KeyError, match="unknown adapter"):
        pool.acquire("nobody")


def test_pool_register_while_pinned_refuses_then_reloads():
    _, _, tm = models()
    pool = AdapterPool(tm, SPEC, n_adapters=3, device="cpu")
    pool.register("t0", tenant(1)[1])
    slot, was_res, _ = pool.acquire("t0")
    assert slot != IDENTITY_ADAPTER and not was_res
    site = "layers.1.attn.v_proj.weight"
    assert torch.equal(pool.factors["v"]["b"][1, slot], tenant(1)[1][site]["b"])
    with pytest.raises(ValueError, match="pinned"):
        pool.register("t0", tenant(2)[1])
    pool.release("t0")
    pool.register("t0", tenant(2)[1])
    slot2, was_res2, _ = pool.acquire("t0")  # the stale copy re-faults
    assert not was_res2
    assert torch.equal(pool.factors["v"]["b"][1, slot2],
                       tenant(2)[1][site]["b"])
    pool.release("t0")


def test_pool_int8_identity_slot_is_exact_zero_and_matches_jax():
    _, variables, tm = models()
    pool = AdapterPool(tm, SPEC, n_adapters=3, quantize=True, device="cpu")
    jp = jadapters.AdapterPool(variables["params"], JSPEC, n_adapters=3,
                               quantize=True)
    ids = torch.tensor([IDENTITY_ADAPTER, IDENTITY_ADAPTER])
    for key, fac in pool.factors.items():
        for side in ("a", "b"):
            assert set(fac[side]) == {"q", "scale"}
            assert not fac[side]["q"][:, IDENTITY_ADAPTER].any()
            for layer in range(2):
                rows = factor_rows(pool.layer_factors(layer)[key][side], ids)
                assert torch.equal(rows, torch.zeros_like(rows))
    assert pool.total_bytes == jp.total_bytes
    jl, tl = tenant(5)
    pool.register("t", tl)
    jp.register("t", jl)
    want = lora_from_jax(jax.tree.map(np.asarray, jp.effective_lora("t")), 2)
    got = pool.effective_lora("t")
    for name in want:  # the same int8 round trip
        for side in ("a", "b"):
            np.testing.assert_allclose(got[name][side].numpy(),
                                       want[name][side].numpy(), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("tensor", [1, 2, 3])
def test_pool_adapter_bytes_matches_jax(quantize, tensor):
    jm, _, tm = models()
    for rank, n in ((8, 5), (16, 3)):
        got = pool_adapter_bytes(tm.cfg, rank=rank, n_adapters=n,
                                 quantize=quantize,
                                 degrees={"tensor": tensor})
        assert got == jadapters.pool_adapter_bytes(
            jm.cfg, rank=rank, n_adapters=n, quantize=quantize,
            degrees={"tensor": tensor})
    if tensor == 1:
        pool = AdapterPool(tm, LoraSpec(rank=8), n_adapters=5,
                           quantize=quantize, device="cpu")
        assert pool.total_bytes == pool_adapter_bytes(
            tm.cfg, rank=8, n_adapters=5, quantize=quantize)


# -- the scheduler's pins ------------------------------------------------------


def _sched(num_blocks, n_slots=2, block_size=8, **kw):
    return Scheduler(n_slots=n_slots, allocator=BlockAllocator(num_blocks),
                     block_size=block_size, **kw)


def test_requeue_restores_fifo_admission_order():
    for mod, pool_mod in ((jsched, jpool), (None, None)):
        make = (_sched if mod is None else lambda nb, **kw: mod.Scheduler(
            n_slots=2, allocator=pool_mod.BlockAllocator(nb), block_size=8))
        req_cls = Request if mod is None else mod.Request
        s = make(16)
        reqs = [req_cls(prompt=[1] * 8, max_new_tokens=8) for _ in range(4)]
        for i, r in enumerate(reqs):
            r.t_submit = float(i)
            s.submit(r)
        admitted = s.admit()
        assert [r.rid for _, r in admitted] == [reqs[0].rid, reqs[1].rid]
        victim = s.requeue(1)
        assert victim is reqs[1]
        assert [r.rid for r in s.queue] == [reqs[1].rid, reqs[2].rid,
                                            reqs[3].rid]
        assert victim.preempted == 1 and not victim.blocks
        s.check_invariants()


def test_scheduler_asserts_on_leaked_adapter_pin():
    _, _, tm = models()
    pool = AdapterPool(tm, SPEC, n_adapters=3, device="cpu")
    pool.register("t0", tenant(1)[1])
    s = _sched(16, adapter_pool=pool)
    req = Request(prompt=[1] * 8, max_new_tokens=8, adapter="t0")
    s.submit(req)
    s.admit()
    got = s.pin_adapter(req)
    assert got and got["idx"] != IDENTITY_ADAPTER and not got["hit"]
    s.check_invariants()
    req.state = "prefilling"  # a prefilling slot may not hold a pin
    with pytest.raises(AssertionError, match="pinned adapter"):
        s.check_invariants()
    req.state = "running"
    pool.allocator.acquire("t0")  # a pin no running slot accounts for
    with pytest.raises(AssertionError, match="pin leak"):
        s.check_invariants()
    pool.release("t0")
    s.requeue(0)  # requeue drops the pin
    assert req.adapter_idx == IDENTITY_ADAPTER
    assert pool.allocator.n_pinned == 0
    s.check_invariants()


def test_pin_adapter_returns_none_when_pool_exhausted():
    _, _, tm = models()
    pool = AdapterPool(tm, SPEC, n_adapters=2, device="cpu")  # 1 slot
    for n in ("t0", "t1"):
        pool.register(n, tenant(1)[1])
    s = _sched(16, adapter_pool=pool)
    r0 = Request(prompt=[1] * 8, max_new_tokens=8, adapter="t0")
    r1 = Request(prompt=[1] * 8, max_new_tokens=8, adapter="t1")
    for r in (r0, r1):
        s.submit(r)
    s.admit()
    assert s.pin_adapter(r0)
    assert s.pin_adapter(r1) is None
    assert r1.adapter_idx == IDENTITY_ADAPTER
    assert s.pin_adapter(Request(prompt=[1], max_new_tokens=1)) == {}
    s.check_invariants()
    s.evict(0)  # eviction unpins
    assert pool.allocator.n_pinned == 0


# -- the engine ----------------------------------------------------------------

PROMPT_LENS = (5, 9, 12, 7)
NAMES = [None, "t0", "t1", "t2"]


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(1, VOCAB, size=(p,))] for p in lens]


def test_multi_tenant_engine_matches_jax_and_merged_generate():
    """The base model and three tenants in three slots (greedy, fp32):
    the JAX engine's tokens, and each request's tokens from ``generate``
    on its merged weights; K4's plain version serves every one-token
    step; every pin is released and every record validates."""
    jm, variables, tm = models()
    prompts = _prompts(0, PROMPT_LENS)
    jeng = JaxEngine(jm, variables, n_slots=3, max_len=64, block_size=8,
                     lora_spec=JSPEC, n_adapters=4, attention_impl="dense")
    jnl = Journal(None, host0_only=False, validate=True)
    eng = ServeEngine(tm, device="cpu", n_slots=3, max_len=64, block_size=8,
                      lora_spec=SPEC, n_adapters=4, journal=jnl)
    for i in range(3):
        jl, tl = tenant(10 + i)
        jeng.register_adapter(f"t{i}", jl)
        eng.register_adapter(f"t{i}", tl)
    jreqs = [jeng.submit(p, max_new_tokens=10, adapter=n)
             for p, n in zip(prompts, NAMES)]
    reqs = [eng.submit(p, max_new_tokens=10, adapter=n)
            for p, n in zip(prompts, NAMES)]
    jeng.run()
    assert len(eng.run()) == 4
    eng.scheduler.check_invariants()
    assert eng.adapter_pool.allocator.n_pinned == 0
    assert eng.decode_routes["paged"] > 0 and eng.decode_routes["dense"] == 0
    for req, jreq, name in zip(reqs, jreqs, NAMES):
        assert req.out_tokens == jreq.out_tokens, name
        lora = None if name is None else tenant(10 + int(name[1]))[1]
        assert req.out_tokens == _merged_reference(tm, lora, req.prompt, 10)
    kinds = [r["kind"] for r in jnl.records if r["name"] == "serve.adapter"]
    assert sorted(kinds) == ["fault"] * 3
    steps = [r for r in jnl.records if r["name"] == "serve.step"]
    assert max(r["adapters_pinned"] for r in steps) == 3
    assert steps[-1]["adapters_resident"] == 3


def test_int8_adapters_eviction_refault_and_stalls():
    """Four tenants through a two-slot int8 pool (n_adapters=3) in two
    sequence slots: evictions, re-faults and adapter stalls (a finished
    prefill finds every pool slot pinned and the request requeues) leave
    no pin behind, and every request's tokens equal ``generate`` on the
    POOL's factors merged (the int8 round trip decode serves)."""
    _, _, tm = models()
    jnl = Journal(None, host0_only=False, validate=True)
    eng = ServeEngine(tm, device="cpu", n_slots=2, max_len=64, block_size=8,
                      lora_spec=SPEC, n_adapters=2, quant_adapters=True,
                      journal=jnl)
    for i in range(4):
        eng.register_adapter(f"t{i}", tenant(40 + i)[1])
    rs = np.random.RandomState(2)
    reqs = []
    for i, name in enumerate(["t0", "t1", "t2", "t3", "t0", None]):
        p = [int(t) for t in rs.randint(1, VOCAB, size=(6 + i,))]
        reqs.append((name, eng.submit(p, max_new_tokens=8, adapter=name)))
    assert len(eng.run()) == 6
    alloc = eng.adapter_pool.allocator
    assert alloc.evictions > 0 and alloc.n_pinned == 0
    kinds = [r["kind"] for r in jnl.records if r["name"] == "serve.adapter"]
    assert "stall" in kinds and "fault" in kinds
    assert eng.scheduler.n_preemptions == kinds.count("stall")
    eng.scheduler.check_invariants()
    for name, req in reqs:
        lora = (None if name is None
                else eng.adapter_pool.effective_lora(name))
        assert req.out_tokens == _merged_reference(tm, lora, req.prompt, 8)


def test_engine_adapter_checks():
    _, _, tm = models()
    plain = ServeEngine(tm, device="cpu", n_slots=2, max_len=64,
                        block_size=8)
    with pytest.raises(ValueError, match="without lora_spec"):
        plain.submit([1, 2], max_new_tokens=2, adapter="t0")
    with pytest.raises(ValueError, match="without lora_spec"):
        plain.register_adapter("t0", tenant(1)[1])
    eng = ServeEngine(tm, device="cpu", n_slots=2, max_len=64, block_size=8,
                      lora_spec=SPEC, n_adapters=3)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit([1, 2], max_new_tokens=2, adapter="nobody")


def test_prefix_cache_keys_commit_to_the_adapter():
    """The reference's fault, held off in the port: GPT-2 ``test`` (vocab
    128, fp32), block 8, prefill chunk 16, one slot; tenant ``t0`` is
    ``random_adapter(seed=10, scale=0.5)``; two 51-token prompts share a
    48-token prefix.  After a base-model request, ``t0``'s request hits
    nothing (the JAX package matched 48 tokens here and reused the base
    model's V rows) and gives the merged-weight tokens; a second ``t0``
    request with the same prefix hits ``t0``'s own blocks and still
    gives the merged-weight tokens."""
    _, _, tm = models()
    shared = [int(t) for t in np.random.RandomState(0).randint(1, VOCAB, 48)]
    tails = np.random.RandomState(1).randint(1, VOCAB, (3, 3)).tolist()
    prompts = [shared + tail for tail in tails]
    _, t0 = tenant(10, 0.5)
    eng = ServeEngine(tm, device="cpu", n_slots=1, max_len=64, block_size=8,
                      prefill_chunk=16, prefix_cache=True, lora_spec=SPEC,
                      n_adapters=2)
    eng.register_adapter("t0", t0)
    jm, variables, _ = models()
    jeng = JaxEngine(jm, variables, n_slots=1, max_len=64, block_size=8,
                     prefill_chunk=16, prefix_cache=True, lora_spec=JSPEC,
                     n_adapters=2, attention_impl="dense")
    jeng.register_adapter("t0", tenant(10, 0.5)[0])
    hits, jhits, jtokens, want = [], [], [], []
    for prompt, name in zip(prompts, [None, "t0", "t0"]):
        req = eng.submit(prompt, max_new_tokens=8, adapter=name)
        eng.run()
        hits.append(eng.prefix_cached_tokens)
        jreq = jeng.submit(prompt, max_new_tokens=8, adapter=name)
        jeng.run()
        jhits.append(jeng.prefix_cached_tokens)
        jtokens.append(jreq.out_tokens)
        want.append(_merged_reference(tm, None if name is None else t0,
                                      prompt, 8))
        assert req.out_tokens == want[-1], name
    # cumulative hit tokens: none across tenants, 48 within t0
    assert hits == [0, 0, 48]
    # the reference's fault on the same requests: t0 reuses the base
    # model's 48 tokens of KV, and its tokens leave the merged weights'
    assert jhits == [0, 48, 96]
    assert jtokens[0] == want[0] and jtokens[1] != want[1]
