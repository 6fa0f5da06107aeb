"""Serving across devices: the PyTorch port's tensor-parallel and
disaggregated ``ServeEngine`` against the JAX package's, on the same
weights and prompts (``tests/test_serve_disagg_tp.py``'s geometry: GPT-2
``test`` in fp32, 4 slots, max_len 64, block 8, chunk 8, 6 prompts of 4
to 19 tokens, 8 new tokens).

- ``tensor_degree`` and ``cache_partition_spec`` against JAX's on 2- and
  4-device meshes (the same ``PartitionSpec`` entries, as a tuple);
- the paged kernel's plain version on a rank's whole-head shard
  (``local_heads``, GQA 8/4, fp32 and int8 pools): the shards' outputs
  concatenated equal the full launch's bitwise, and JAX's
  ``paged_attention(mesh=)`` on a 2-device mesh within 1e-5 (fp32; the
  paged-attention tests' tolerance: two implementations, sums in
  another order);
- ``ServeEngine(mesh=)`` on 2 gloo ranks (one spawn of
  ``tests/torch_port_dist_worker.py``), the cases JAX's
  ``test_serve_disagg_tp.py`` pins: fp32 and int8 KV, and two LoRA
  tenants on q, v and o (rank 4, fp32 and int8 factors) with
  ``disaggregate=True`` on top, each rank's greedy tokens equal to the
  JAX engine's unsharded ones and to the other rank's; and two the port
  adds, Llama ``test`` (GQA 4/2) and MoE ``test`` (routed prefill; its
  banks whole on each rank) from seeded torch weights, against the
  port's unsharded engine run in the same spawn (that engine is held to
  JAX's by the engine and MoE decode tests).  Each rank holds half the
  kv heads and its share of the factors; every decode step all-reduces
  twice a layer (once for MoE), once more a layer for the o site's
  adapter partials;
- disaggregated against colocated in one process, including optimistic
  admission over a 10-block pool (preempt and recompute): identical
  tokens, JAX's colocated tokens, every prefill shipped (more than 4
  ships under preemption) and no block leaked;
- ``pool_adapter_bytes(degrees=)`` and the pool's byte counts against
  JAX's formulas (GPT-2 small, bf16, block 16: 589,824 B a block).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_automatic_distributed_neural_network_tpu.inference import decode as jdecode
from torch_automatic_distributed_neural_network_tpu.inference.quant import (
    quantize_kv as j_quantize_kv,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    ServeEngine as JaxEngine,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    adapters as jadapters,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve.kv_pool import (
    pool_kv_bytes as j_pool_kv_bytes,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu.models import MoE as JMoE
from torch_automatic_distributed_neural_network_tpu.ops import (
    paged_attention as jpaged,
)
from torch_automatic_distributed_neural_network_tpu.training import lora as jlora
from torch_automatic_distributed_neural_network_tpu_torch.inference import (
    decode as tdecode,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    quantize_kv,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    ServeEngine,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    adapters as tadapters,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve.kv_pool import (
    PagedKVPool,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    lora_from_jax,
    moe_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    MoELM,
    gpt2_config,
    llama_config,
    moe_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops.paged_attention import (
    local_heads,
    paged_attention,
    tensor_degree,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import lora as tlora

from torch_port_spawn import spawn

VOCAB = 128
GEOM = dict(n_slots=4, max_len=64, block_size=8, prefill_chunk=8)
MAX_NEW = 8
FAMILIES = {"gpt2": (GPT2, gpt2_config, decoder_from_jax_params),
            "llama": (Llama, llama_config, decoder_from_jax_params),
            "moe": (JMoE, moe_config, moe_from_jax_params)}
# q, v and o: the o site is the one whose factors split by input rows
JSPEC = jlora.LoraSpec(rank=4, targets=(
    jlora.LoraTarget(r"q_proj/kernel", 1, 2),
    jlora.LoraTarget(r"v_proj/kernel", 1, 2), jlora.O_LIKE))
TSPEC = tlora.LoraSpec(rank=4, targets=(
    tlora.LoraTarget(r"q_proj\.weight$", 1, 1, True),
    tlora.LoraTarget(r"v_proj\.weight$", 1, 1, True), tlora.O_LIKE))


@functools.lru_cache(maxsize=None)
def port_model(family):
    """A port model from seeded torch weights (the cases held to the
    port's unsharded engine)."""
    _, tcfg, _ = FAMILIES[family]
    cfg = tcfg("test", vocab_size=VOCAB, max_seq_len=64, dtype=torch.float32)
    model = (MoELM if family == "moe" else DecoderLM)(cfg)
    return model.init_weights(torch.Generator().manual_seed(1))


@functools.lru_cache(maxsize=None)
def model_pair(family="gpt2"):
    jcls, tcfg, load = FAMILIES[family]
    jm = jcls("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32,
              remat=False)
    tokens = jnp.asarray(
        np.random.RandomState(0).randint(1, VOCAB, size=(1, 12)), jnp.int32)
    variables = jm.init(jax.random.key(1), tokens)
    cfg = tcfg("test", vocab_size=VOCAB, max_seq_len=64, dtype=torch.float32)
    tm = load(jax.tree.map(np.asarray, variables["params"]), cfg,
              device="cpu")
    return jm, variables, tm


def _prompts(n=6, seed=7, lo=4, hi=20):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(1, VOCAB, size=rs.randint(lo, hi))]
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def jax_adapters():
    _, variables, _ = model_pair()
    return [(f"t{i}", jadapters.random_adapter(variables["params"], JSPEC,
                                                seed=10 + i))
            for i in range(2)]


def _assign(names, i):
    """Request i's tenant, as ``tests/test_serve_disagg_tp.py`` assigns
    them: every third request on the base model."""
    n = len(names) + 1
    return names[i % n - 1] if names and i % n else None


def jax_tokens(family, prompts, *, adapters=False, **kw):
    jm, variables, _ = model_pair(family)
    eng = JaxEngine(jm, variables, **{**GEOM, **kw},
                    lora_spec=JSPEC if adapters else None)
    names = []
    for name, lora in (jax_adapters() if adapters else ()):
        eng.register_adapter(name, lora)
        names.append(name)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, eos_id=None,
                       adapter=_assign(names, i))
            for i, p in enumerate(prompts)]
    eng.run()
    return [r.out_tokens for r in reqs]


# -- the placement helpers ------------------------------------------------------


def test_tensor_degree_matches_jax(devices8):
    mesh = Mesh(np.array(devices8[:2]), ("tensor",))
    assert tensor_degree(None) == jpaged.tensor_degree(None) == 1
    assert tensor_degree({"tensor": 2}) == jpaged.tensor_degree(mesh) == 2
    assert (tensor_degree({"tensor": 2}, axis="data")
            == jpaged.tensor_degree(mesh, axis="data") == 1)


MESHES = [({"tensor": 2}, 4), ({"data": 2, "tensor": 2}, 4),
          ({"fsdp": 2}, 4), ({"tensor": 2}, 3), ({"data": 2, "fsdp": 2}, 2)]


@pytest.mark.parametrize("degrees,kv_heads", MESHES,
                         ids=["tensor2", "data2xtensor2", "fsdp2",
                              "indivisible-heads", "data2xfsdp2"])
def test_cache_partition_spec_matches_jax(devices8, degrees, kv_heads):
    n = int(np.prod(list(degrees.values())))
    mesh = Mesh(np.array(devices8[:n]).reshape(tuple(degrees.values())),
                tuple(degrees))
    cfg = SimpleNamespace(kv_heads=kv_heads)
    want = tuple(jdecode.cache_partition_spec(cfg, mesh))
    assert tdecode.cache_partition_spec(cfg, degrees) == want
    want = tuple(jdecode.cache_partition_spec(cfg, mesh, batch_axes=()))
    assert tdecode.cache_partition_spec(cfg, degrees, batch_axes=()) == want


def _kernel_case(quantized):
    rs = np.random.RandomState(0)
    S, Hq, kvH, hd, bs, MB, NB = 4, 8, 4, 32, 8, 4, 24
    k = rs.randn(NB, bs, kvH, hd).astype(np.float32)
    v = rs.randn(NB, bs, kvH, hd).astype(np.float32)
    tables = rs.permutation(np.arange(1, NB))[:S * MB].reshape(
        S, MB).astype(np.int32)
    ctx = np.asarray([0, 5, 17, 31], np.int32)
    q = rs.randn(S, Hq, hd).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, ctx)]
    j = [jnp.asarray(a) for a in (q, k, v, tables, ctx)]
    if quantized:
        t[1], t[2] = quantize_kv(t[1]), quantize_kv(t[2])
        j[1], j[2] = j_quantize_kv(j[1]), j_quantize_kv(j[2])
    return t, j


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_attention_on_local_heads(devices8, quantized):
    """GQA 8/4 over a tensor degree of 2: each rank's whole-head shard
    through the plain version, the shards concatenated, equal the full
    launch bitwise (attention is head-parallel) and JAX's sharded kernel
    within 1e-5."""
    (q, k, v, tables, ctx), j = _kernel_case(quantized)
    full = paged_attention(q, k, v, tables, ctx)
    parts = []
    for r in range(2):
        ql, kl, vl = (local_heads(x, 2, r, dim)
                      for x, dim in ((q, 1), (k, 2), (v, 2)))
        parts.append(paged_attention(ql, kl, vl, tables, ctx,
                                     mesh={"tensor": 2}))
        assert parts[-1].shape == (4, 4, 32)
    got = torch.cat(parts, dim=1)
    assert torch.equal(got, full)
    mesh = Mesh(np.array(devices8[:2]), ("tensor",))
    want = np.asarray(jpaged.paged_attention(*j, mesh=mesh))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="whole-head"):
        local_heads(k, 3, 0, 2)
    with pytest.raises(ValueError, match="allocation of its own"):
        paged_attention(q[:, :4], _strided(k), _strided(v), tables, ctx,
                        mesh={"tensor": 2})


def _strided(pool):
    """Rank 0's kv heads as a view of the full pool (not contiguous)."""
    if isinstance(pool, dict):
        return {key: val[:, :, :2] for key, val in pool.items()}
    return pool[:, :, :2]


# -- the engine ------------------------------------------------------------------


CASES = [
    dict(name="gpt2-fp32"),
    dict(name="gpt2-int8-kv", kw=dict(quant_kv=True)),
    dict(name="llama-gqa", family="llama", ref="port"),
    dict(name="moe-routed", family="moe", ref="port",
         kw=dict(moe_decode="routed")),
    dict(name="lora-fp32-disagg", adapters=True,
         kw=dict(n_adapters=4, disaggregate=True)),
    dict(name="lora-int8-disagg", adapters=True,
         kw=dict(n_adapters=4, quant_adapters=True, disaggregate=True)),
]


@functools.lru_cache(maxsize=None)
def tp_results(tmp_root):
    from pathlib import Path

    cases = []
    for case in CASES:
        tm = _model(case)
        cfg = tm.cfg
        cases.append({**case, "cfg": {f: getattr(cfg, f)
                                      for f in cfg.__dataclass_fields__},
                      "state_dict": tm.state_dict()})
    _, _, tm = model_pair()
    job = {"serve_tp": {
        "cases": cases, "geometry": GEOM, "prompts": _prompts(),
        "max_new": MAX_NEW, "spec": TSPEC,
        "adapters": [(name, lora_from_jax(jax.tree.map(np.asarray, lo),
                                          tm.cfg.n_layers))
                     for name, lo in jax_adapters()]}}
    tmp = Path(tmp_root) / "world2"
    tmp.mkdir()
    return spawn(2, job, tmp)["serve_tp"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tp_results(str(tmp_path_factory.mktemp("serve_tp")))


def _model(case):
    family = case.get("family", "gpt2")
    return port_model(family) if case.get("ref") == "port" else (
        model_pair(family)[2])


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_tp_engine_matches_jax(results, case):
    family = case.get("family", "gpt2")
    kw = {k: v for k, v in case.get("kw", {}).items()
          if k != "disaggregate"}
    ranks = results[case["name"]]
    if case.get("ref") == "port":
        want = ranks[0]["unsharded_tokens"]
    else:
        want = jax_tokens(family, _prompts(),
                          adapters=case.get("adapters", False), **kw)
    assert ranks[0]["tokens"] == ranks[1]["tokens"]  # lockstep ranks
    assert ranks[0]["tokens"] == want
    cfg = _model(case).cfg
    L = cfg.n_layers
    for rec in ranks:
        assert rec["kv_heads"] == cfg.kv_heads // 2
        assert rec["spec"] == (None, None, None, "tensor", None)
        assert rec["pool_shape"][2] == cfg.kv_heads // 2
        # the byte counts stay global
        assert rec["bytes_per_block"] == j_pool_kv_bytes(
            cfg, 1, 8, jnp.bfloat16, case.get("kw", {}).get("quant_kv",
                                                             False))
        assert rec["comms"], "no decode step ran"
        # the row-split o and MLP-down (an MoE bank stays whole: o
        # only), and the o site's adapter partials
        per_layer = (1 if family == "moe" else 2) + bool(case.get("adapters"))
        for step in rec["comms"]:
            assert step == {"all_reduce": per_layer * L}
        assert rec["free_blocks"] == GEOM["n_slots"] * 8  # none leaked
        if case.get("adapters"):
            d, hd, H = cfg.d_model, cfg.head_dim, cfg.n_heads
            assert rec["factor_shapes"] == {
                "q": {"a": (L, 4, d, 4), "b": (L, 4, 4, H * hd // 2)},
                "v": {"a": (L, 4, d, 4), "b": (L, 4, 4, H * hd // 2)},
                "o": {"a": (L, 4, H * hd // 2, 4), "b": (L, 4, 4, d)}}
        if case.get("kw", {}).get("disaggregate"):
            assert rec["n_transfers"] == rec["n_kv_ships"] == len(_prompts())
            assert rec["transferred_bytes"] == (
                rec["transferred_blocks"] * rec["bytes_per_block"])
        else:
            assert rec["n_transfers"] == 0


def test_tp_engine_refuses_indivisible_heads_and_other_axes():
    """The port splits whole heads: a tensor degree that does not divide
    them is refused (the JAX engine falls back to the unsharded kernel),
    as is a mesh with another axis above 1."""
    tm = model_pair()[2]
    with pytest.raises(ValueError, match="does not divide the head"):
        ServeEngine(tm, device="cpu", max_len=64, mesh={"tensor": 3})
    with pytest.raises(ValueError, match="other than 'tensor'"):
        ServeEngine(tm, device="cpu", max_len=64,
                    mesh={"data": 2, "tensor": 2})


# -- disaggregated serving in one process ---------------------------------------


def _port_run(tm, prompts, **kw):
    eng = ServeEngine(tm, device="cpu", **kw)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, eos_id=None)
            for p in prompts]
    eng.run()
    eng.scheduler.check_invariants()
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("quant_kv", [False, True], ids=["fp32", "int8"])
def test_disaggregated_matches_colocated(quant_kv):
    tm = model_pair()[2]
    prompts = _prompts(seed=5)
    base, _ = _port_run(tm, prompts, quant_kv=quant_kv, **GEOM)
    dis, eng = _port_run(tm, prompts, quant_kv=quant_kv, disaggregate=True,
                         **GEOM)
    assert dis == base
    assert eng.pool.n_transfers == eng.scheduler.n_kv_ships == len(prompts)
    assert eng.scheduler.shipped_blocks == eng.pool.transferred_blocks > 0
    assert (eng.pool.transferred_bytes
            == eng.pool.transferred_blocks * eng.pool.bytes_per_block)
    # the time model: overlapped steps never cost more than the sum
    assert eng.overlapped_wall_s <= eng.prefill_busy_s + eng.decode_busy_s
    assert all(r.t_kv_shipped is not None for r in eng.finished)


def test_disaggregated_preempted_then_recomputed_matches_jax():
    """Optimistic admission over a 10-block pool forces preempt and
    recompute; the recomputed prefills ship again and every token is
    still JAX's colocated one."""
    jm, variables, tm = model_pair()
    geom = dict(n_slots=4, max_len=32, block_size=8, num_blocks=10,
                admission="optimistic", prefill_chunk=8)
    prompts = [[3] * 12] * 4
    jeng = JaxEngine(jm, variables, **geom)
    jreqs = [jeng.submit(p, max_new_tokens=12, eos_id=None) for p in prompts]
    jeng.run()
    want = [r.out_tokens for r in jreqs]
    outs = {}
    for dis in (False, True):
        eng = ServeEngine(tm, device="cpu", disaggregate=dis, **geom)
        reqs = [eng.submit(p, max_new_tokens=12, eos_id=None)
                for p in prompts]
        eng.run()
        eng.scheduler.check_invariants()
        outs[dis] = [r.out_tokens for r in reqs]
    assert outs[False] == outs[True] == want
    assert eng.scheduler.n_preemptions > 0
    assert eng.pool.n_transfers > 4  # a preempted request ships again
    assert eng.pool.allocator.n_free == 9  # zero leaked blocks


# -- byte counts ------------------------------------------------------------------


def test_pool_adapter_bytes_matches_jax():
    cfgs = [SimpleNamespace(n_layers=2, n_heads=16, kv_heads=4, head_dim=64,
                            d_model=64),
            SimpleNamespace(n_layers=2, n_heads=3, kv_heads=3, head_dim=5,
                            d_model=15)]
    for cfg in cfgs:
        for quantize in (False, True):
            for degrees in (None, {"tensor": 1}, {"tensor": 2},
                            {"tensor": 4}):
                kw = dict(rank=8, n_adapters=4, quantize=quantize,
                          degrees=degrees)
                assert (tadapters.pool_adapter_bytes(cfg, **kw)
                        == jadapters.pool_adapter_bytes(cfg, **kw))


def test_pool_bytes_stay_global_and_the_shard_holds_half():
    """GPT-2 small, bf16, block 16 under a tensor degree of 2: a block is
    589,824 B across all layers (the JAX count), the rank's pool holds
    half of it."""
    cfg = gpt2_config("small")
    pool = PagedKVPool(cfg, num_blocks=3, block_size=16, device="cpu",
                       mesh={"tensor": 2})
    assert pool.bytes_per_block == 2 * 12 * 16 * 12 * 64 * 2 == 589_824
    assert pool.bytes_per_block == j_pool_kv_bytes(cfg, 1, 16)
    assert pool.spec == (None, None, None, "tensor", None)
    held = sum(t.numel() * t.element_size() for t in pool._leaves())
    assert held * 2 == pool.total_bytes
