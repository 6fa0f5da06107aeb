"""MoE decoding in the PyTorch port: ``inference/decode.py``'s dense and
routed expert MLPs, ``forward_cached``, greedy ``generate``,
``ServeEngine`` (chunked prefill, paged decode, a speculative verify
step) and ``tadnn serve --family moe``, against the JAX package on the
same weights (drawn once with JAX and carried across by ``interop``) and
the same seeded numpy prompts.

The ``test`` preset (2 layers, d 128, 4 SwiGLU experts, top-2) in fp32,
one intra-op thread: routing decisions are exact only in fp32.
Tolerances: the decode MLPs 1e-5 (fp32 sums in another order); the
logits of ``forward_cached`` 1e-5; greedy token ids exactly, as JAX's
``tests/test_generate.py`` compares them.  A dropping configuration
(capacity factor 0.3) pins the routed prefill to the training forward
(2e-5, JAX's bound) and shows the dense combine leaving it.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference import (
    decode as jdec,
)
from torch_automatic_distributed_neural_network_tpu.inference.quant import (
    quantize_for_decode as jax_quantize,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    ServeEngine as JaxEngine,
)
from torch_automatic_distributed_neural_network_tpu.models import MoE as JMoE
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    interop,
    moe_next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference import (
    decode as tdec,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    QuantizedWeight,
    quantize_for_decode,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    ServeEngine,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import moe_config

VOCAB, MAX_LEN = 128, 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def moe_pair(capacity_factor=1.25, seed=1):
    """A JAX MoE ``test`` model with random weights and the port's copy."""
    kw = dict(vocab_size=VOCAB, max_seq_len=MAX_LEN,
              capacity_factor=capacity_factor)
    jm = JMoE("test", dtype=jnp.float32, remat=False, **kw)
    variables = jax.jit(jm.init)(jax.random.key(seed),
                                 jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    tm = interop.moe_from_jax_params(
        params, moe_config("test", dtype=torch.float32, **kw), device="cpu")
    return jm, {"params": jax.tree.map(jnp.asarray, params)}, tm


def _prompt(seed, B=2, P=8):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, P)).astype(
        np.int32)


def _layer0_mlp(params):
    return jax.tree.map(lambda a: a[0], params["layers"]["mlp"])


@pytest.mark.parametrize("mode,capacity", [("dense", None),
                                           ("routed", None), ("routed", 8),
                                           ("routed", 32)])
def test_moe_decode_mlps_match_jax(mode, capacity):
    """``_moe_mlp_cached`` and ``_moe_mlp_routed`` (with and without a
    pinned capacity; 8 drops choices on these 12-token rows) against
    JAX's on the same layer's weights and inputs, 1e-5."""
    jm, variables, tm = moe_pair()
    h = np.random.RandomState(2).randn(2, 12, 128).astype(np.float32)
    lp = _layer0_mlp(variables["params"])
    if mode == "dense":
        want = jdec._moe_mlp_cached(lp, jnp.asarray(h), jm.cfg)
        with torch.no_grad():
            got = tdec._moe_mlp_cached(tm.layers[0].mlp,
                                       torch.from_numpy(h), tm.cfg)
    else:
        want = jdec._moe_mlp_routed(lp, jnp.asarray(h), jm.cfg,
                                    capacity_override=capacity)
        with torch.no_grad():
            got = tdec._moe_mlp_routed(tm.layers[0].mlp,
                                       torch.from_numpy(h), tm.cfg, capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("mode,capacity", [("dense", None),
                                           ("routed", None), ("routed", 8)])
def test_forward_cached_matches_jax(mode, capacity):
    """A prefill chunk then a one-token step through the cache: every
    position's logits of the chunk, then the step's, 1e-5."""
    jm, variables, tm = moe_pair()
    toks = _prompt(3, P=10)
    jcache = jdec.KVCache.init(jm.cfg, 2, 16, dtype=jnp.float32)
    tcache = tdec.KVCache.init(tm.cfg, 2, 16, dtype=torch.float32)
    kw = dict(moe_decode=mode, moe_capacity=capacity)
    jl, jcache = jdec.forward_cached(variables["params"], jm.cfg,
                                     jnp.asarray(toks), jcache,
                                     all_logits=True, **kw)
    tl, tcache = tdec.forward_cached(tm, torch.from_numpy(toks).long(),
                                     tcache, all_logits=True, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    nxt = toks[:, -1:]
    jl, _ = jdec.forward_cached(variables["params"], jm.cfg,
                                jnp.asarray(nxt), jcache, moe_decode=mode)
    tl, tcache = tdec.forward_cached(tm, torch.from_numpy(nxt).long(),
                                     tcache, moe_decode=mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert tcache.length == 11


@pytest.mark.parametrize("mode", ["dense", "routed"])
def test_greedy_generate_matches_jax(mode):
    """Greedy tokens of both decode modes equal JAX's, and (capacity
    factor 8: nothing drops) routed equals dense, as JAX's
    ``test_routed_generate_matches_dense_when_no_drops`` asserts."""
    jm, variables, tm = moe_pair(capacity_factor=8.0, seed=3)
    prompt = _prompt(6)
    want = jdec.generate(jm, variables, jnp.asarray(prompt),
                         max_new_tokens=6, cache_dtype=jnp.float32,
                         moe_decode=mode)
    got = tdec.generate(tm, torch.from_numpy(prompt), max_new_tokens=6,
                        cache_dtype=torch.float32, moe_decode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = tdec.generate(tm, torch.from_numpy(prompt), max_new_tokens=6,
                          cache_dtype=torch.float32,
                          moe_decode={"dense": "routed",
                                      "routed": "dense"}[mode])
    np.testing.assert_array_equal(other.numpy(), got.numpy())


def test_greedy_generate_matches_a_naive_loop():
    """The cached decode against re-running the training forward on the
    whole prefix each step (JAX's ``test_moe_greedy_generate_matches_
    naive_loop``), and ``moe_capacity`` pinning the prefill."""
    _, _, tm = moe_pair(capacity_factor=8.0, seed=3)
    prompt = torch.from_numpy(_prompt(0)).long()
    out = tdec.generate(tm, prompt, max_new_tokens=5,
                        cache_dtype=torch.float32)
    cur = prompt
    with torch.no_grad():
        for _ in range(5):
            logits, _ = tm(cur)
            cur = torch.cat([cur, logits[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(out.numpy(), cur.numpy())
    pinned = tdec.generate(tm, prompt, max_new_tokens=5,
                           cache_dtype=torch.float32, moe_decode="routed",
                           moe_capacity=64)
    np.testing.assert_array_equal(pinned.numpy(), cur.numpy())


def test_routed_prefill_keeps_the_training_drops():
    """Capacity factor 0.3 on 64-token rows (16 slots for ~32 choices an
    expert): the routed prefill's last logits are the training forward's
    (2e-5) and the dense combine's are not, in the port as in JAX."""
    jm, variables, tm = moe_pair(capacity_factor=0.3, seed=2)
    toks = np.random.RandomState(5).randint(0, VOCAB, (2, 64)).astype(
        np.int32)
    with torch.no_grad():
        train, _ = tm(torch.from_numpy(toks).long())
    jtrain, _ = jm.apply(variables, jnp.asarray(toks))
    np.testing.assert_allclose(train[:, -1].numpy(),
                               np.asarray(jtrain[:, -1]), atol=2e-5, rtol=0)
    got = {}
    for mode in ("routed", "dense"):
        cache = tdec.KVCache.init(tm.cfg, 2, 80, dtype=torch.float32)
        got[mode], _ = tdec.forward_cached(
            tm, torch.from_numpy(toks).long(), cache, moe_decode=mode)
    np.testing.assert_allclose(got["routed"].numpy(), train[:, -1].numpy(),
                               atol=2e-5, rtol=0)
    assert not np.allclose(got["dense"].numpy(), train[:, -1].numpy(),
                           atol=2e-5, rtol=0)


def test_moe_decode_is_checked():
    _, _, tm = moe_pair()
    p = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="moe_decode"):
        tdec.generate(tm, p, max_new_tokens=2, moe_decode="sparse")
    with pytest.raises(ValueError, match="moe_decode"):
        ServeEngine(tm, device="cpu", moe_decode="sparse")
    from torch_automatic_distributed_neural_network_tpu_torch.topology import (
        single_device_mesh,
    )

    with pytest.raises(ValueError, match="moe_decode"):
        tdec.generate(tm, p, max_new_tokens=2, moe_decode="sparse",
                      mesh=single_device_mesh())


def _serve(engine_cls, model_args, prompts, **kw):
    eng = engine_cls(*model_args, **kw)
    reqs = [eng.submit(p, max_new_tokens=6, eos_id=None) for p in prompts]
    eng.run()
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("kw", [
    dict(moe_decode="dense"),
    dict(moe_decode="routed", prefill_chunk=8),
    dict(moe_decode="dense", quant_kv=True, prefill_chunk=None),
    dict(moe_decode="dense", speculative=2),
], ids=["dense-chunk32", "routed-chunk8", "int8kv-single-shot",
        "speculative"])
def test_engine_tokens_match_jax(kw):
    """``ServeEngine`` on MoE against JAX's on the same requests (5, 11
    and 13 tokens, 2 slots, block 8): the same greedy tokens; the port's
    paged decode and its dense one; the speculative run's verify steps
    (T = 3) combine densely, as JAX's."""
    jm, variables, tm = moe_pair(capacity_factor=8.0, seed=3)
    rs = np.random.RandomState(3)
    prompts = [[int(t) for t in rs.randint(1, VOCAB, size=(n,))]
               for n in (5, 11, 13)]
    geom = dict(n_slots=2, max_len=64, block_size=8)
    want, _ = _serve(JaxEngine, (jm, variables), prompts,
                     attention_impl="dense", **geom, **kw)
    for impl in ("paged", "dense"):
        got, eng = _serve(ServeEngine, (tm,), prompts, device="cpu",
                          attention_impl=impl, **geom, **kw)
        assert got == want, (impl, got, want)
        eng.scheduler.check_invariants()
        assert eng.moe_decode == kw["moe_decode"]
        if kw.get("speculative"):
            assert eng.decode_routes["dense"] > 0


@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_one_slot_engine_equals_generate_in_bf16(impl):
    """The engine's MoE decode against the port's own ``generate``, like
    with like (the gate of ``chip_smoke.py``'s phase ``moe``): bf16
    weights, each prompt alone (``generate`` at B 1) through an engine of
    one slot whose one prefill chunk is the prompt and whose cache is as
    long as ``generate``'s; the greedy tokens exactly equal."""
    _, _, tm = moe_pair(capacity_factor=8.0, seed=3)
    m16 = type(tm)(moe_config("test", dtype=torch.bfloat16,
                              vocab_size=VOCAB, max_seq_len=MAX_LEN,
                              capacity_factor=8.0))
    m16.load_state_dict(tm.state_dict())
    m16 = m16.to(torch.bfloat16)
    P, N = 16, 24
    rs = np.random.RandomState(5)
    prompts = [[int(t) for t in rs.randint(1, VOCAB, size=(P,))]
               for _ in range(3)]
    want = [tdec.generate(m16, torch.tensor([p]), max_new_tokens=N,
                          moe_decode="dense")[0, P:].tolist()
            for p in prompts]
    eng = ServeEngine(m16, device="cpu", n_slots=1, max_len=P + N,
                      block_size=8, prefill_chunk=P, attention_impl=impl)
    reqs = [eng.submit(p, max_new_tokens=N, eos_id=None) for p in prompts]
    eng.run()
    assert [r.out_tokens for r in reqs] == want


def test_cli_serve_moe_smoke_on_cpu(capsys):
    """``tadnn serve --family moe`` at the smoke's numbers given
    explicitly; ``--smoke`` itself keeps the JAX CLI's contract and
    serves GPT-2 whatever ``--family`` says."""
    from torch_automatic_distributed_neural_network_tpu_torch.cli import main

    assert main(["serve", "--family", "moe", "--size", "test",
                 "--streams", "8", "--slots", "4", "--max-len", "64",
                 "--block-size", "8", "--max-new", "12", "--prompt-len",
                 "10", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["family"] == "moe" and summary["size"] == "test"
    assert summary["n_requests"] == 8 and summary["device"] == "cpu"
    assert summary["new_tokens"] > 0
    assert main(["serve", "--family", "moe", "--smoke", "--device",
                 "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["family"] == "gpt2" and summary["n_requests"] == 8
    assert main(["serve", "--family", "mixtral", "--device", "cpu"]) == 2


def test_int8_decode_keeps_banks_and_router_whole():
    """``quantize_for_decode`` leaves the expert banks and the router in
    full precision (JAX's ``test_moe_expert_banks_stay_full_precision``)
    and quantizes the rest; int8 greedy tokens equal JAX's int8 decode of
    the same weights, directly and through ``AutoDistribute.generate``."""
    jm, variables, tm = moe_pair(capacity_factor=8.0, seed=3)
    q = quantize_for_decode(tm)
    mlp = q.layers[0].mlp
    for name in ("experts_up", "experts_gate", "experts_down"):
        w = getattr(mlp, name)
        assert isinstance(w, torch.nn.Parameter) and w.dtype == torch.float32
    assert not isinstance(mlp.router.weight, QuantizedWeight)
    assert mlp.router.weight.dtype == torch.float32
    assert isinstance(q.layers[0].attn.q_proj.weight, QuantizedWeight)
    jq = jax_quantize(variables)
    jmlp = jq["params"]["layers"]["mlp"]
    assert not isinstance(jmlp["experts_up"], dict)
    assert not isinstance(jmlp["router"]["kernel"], dict)
    prompt = _prompt(8)
    for mode in ("dense", "routed"):
        want = jdec.generate(jm, jq, jnp.asarray(prompt), max_new_tokens=5,
                             cache_dtype=jnp.float32, moe_decode=mode)
        got = tdec.generate(q, torch.from_numpy(prompt), max_new_tokens=5,
                            cache_dtype=torch.float32, moe_decode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ad = AutoDistribute(tm, loss_fn=moe_next_token_loss, device="cpu")
    ad.build_plan()
    via = ad.generate(dict(tm.named_parameters()), torch.from_numpy(prompt),
                      max_new_tokens=5, cache_dtype=torch.float32,
                      moe_decode="routed", moe_capacity=16, quant="int8")
    np.testing.assert_array_equal(via.numpy(), got.numpy())
