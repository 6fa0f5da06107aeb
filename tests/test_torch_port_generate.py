"""Generation and int8 decode weights: the PyTorch port's
``decode.generate``, ``quant.quantize_for_decode``, the int8 path through
``interop`` and ``AutoDistribute.generate`` against the JAX package's, on
the same weights (carried across by ``interop``) and the same seeded
numpy prompts.

Tolerances: greedy token ids and the ``return_lengths`` lengths are
compared exactly; int8 payloads exactly and scales to 1 ulp (fp32); the
int8 logits to 1e-4 relative to their largest magnitude (fp32 compute on
both sides).
"""

import functools

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
from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference import (
    decode as tdec,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    QuantizedWeight,
    quantize_for_decode,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
    llama_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.training.lora import (
    HEAD_LIKE,
    MLP_LIKE,
    O_LIKE,
    Q_LIKE,
    matrix_view,
)

VOCAB = 128
FAMILIES = {"gpt2": (GPT2, gpt2_config), "llama": (Llama, llama_config)}
CASES = {"gpt2": dict(), "llama-window": dict(sliding_window=4),
         "llama-untied": dict(tie_embeddings=False)}


@functools.lru_cache(maxsize=None)
def model_pair(case):
    """A JAX decoder with random weights and the port's copy (cached:
    nothing here changes either)."""
    family = case.split("-")[0]
    jcls, tcfg = FAMILIES[family]
    kw = dict(vocab_size=VOCAB, max_seq_len=64, **CASES[case])
    jm = jcls("test", dtype=jnp.float32, remat=False, **kw)
    variables = jm.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))
    tm = decoder_from_jax_params(
        jax.tree.map(np.asarray, variables["params"]),
        tcfg("test", dtype=torch.float32, **kw), device="cpu")
    return jm, variables, tm


def _prompt(seed=0, B=2, P=7):
    return np.random.RandomState(seed).randint(1, VOCAB, size=(B, P)).astype(
        np.int32)


@pytest.mark.parametrize("case", ["gpt2", "llama-window"])
def test_greedy_generate_matches_jax(case):
    jm, variables, tm = model_pair(case)
    prompt = _prompt()
    want = np.asarray(jdec.generate(jm, variables, jnp.asarray(prompt),
                                    max_new_tokens=12,
                                    cache_dtype=jnp.float32))
    got = tdec.generate(tm, torch.from_numpy(prompt), max_new_tokens=12,
                        cache_dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (2, 19)
    np.testing.assert_array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _eos_of_row0():
    """A token GPT-2's row 0 of the seed-2 prompt emits as its third new
    token (JAX greedy, computed once for both cases below)."""
    jm, variables, _ = model_pair("gpt2")
    plain = np.asarray(jdec.generate(jm, variables,
                                     jnp.asarray(_prompt(seed=2, B=3)),
                                     max_new_tokens=10,
                                     cache_dtype=jnp.float32))
    return int(plain[0, 7 + 2])


@pytest.mark.parametrize("early_stop", [False, True])
def test_eos_fill_and_lengths_match_jax(early_stop):
    """An ``eos_id`` one row emits early and the other later (or never):
    outputs, fill and lengths equal JAX's, with and without early stop."""
    jm, variables, tm = model_pair("gpt2")
    prompt = _prompt(seed=2, B=3)
    eos = _eos_of_row0()
    want, want_len = jdec.generate(
        jm, variables, jnp.asarray(prompt), max_new_tokens=10,
        cache_dtype=jnp.float32, eos_id=eos, early_stop=early_stop,
        return_lengths=True)
    got, got_len = tdec.generate(
        tm, torch.from_numpy(prompt), max_new_tokens=10,
        cache_dtype=torch.float32, eos_id=eos, early_stop=early_stop,
        return_lengths=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert int(got_len[0]) <= 7 + 3


def test_generate_checks_and_later_slices():
    _, _, tm = model_pair("gpt2")
    p = torch.from_numpy(_prompt())
    # sharded decode is ported (tests/test_torch_port_sharded_decode.py): a
    # mesh of one device decodes as no mesh
    from torch_automatic_distributed_neural_network_tpu_torch.topology import (
        single_device_mesh,
    )

    assert torch.equal(
        tdec.generate(tm, p, max_new_tokens=2, mesh=single_device_mesh()),
        tdec.generate(tm, p, max_new_tokens=2))
    # MoE decoding is ported (tests/test_torch_port_moe_decode.py): on a
    # dense model ``moe_decode`` changes nothing, as in JAX, and an unknown
    # mode is refused
    assert torch.equal(
        tdec.generate(tm, p, max_new_tokens=2, moe_decode="routed"),
        tdec.generate(tm, p, max_new_tokens=2))
    with pytest.raises(ValueError, match="moe_decode"):
        tdec.generate(tm, p, max_new_tokens=2, moe_decode="sparse")
    with pytest.raises(ValueError, match="eos_id"):
        tdec.generate(tm, p, max_new_tokens=2, early_stop=True)
    with pytest.raises(ValueError, match="learned positions"):
        tdec.generate(tm, p, max_new_tokens=60)
    out, lengths = tdec.generate(tm, p, max_new_tokens=0,
                                 return_lengths=True)
    assert out.tolist() == p.tolist() and lengths.tolist() == [7, 7]


def test_sampled_generate_is_reproducible_under_its_generator():
    _, _, tm = model_pair("llama-window")
    p = torch.from_numpy(_prompt())
    sc = tdec.SampleConfig(temperature=1.0, top_k=20, top_p=0.9)
    runs = [tdec.generate(tm, p, max_new_tokens=8, sample=sc,
                          generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_matrix_views_match_the_jax_table():
    """The port's table splits each family's weight into the same
    (d_in, d_out) as the JAX table does its kernel."""
    from torch_automatic_distributed_neural_network_tpu.training import (
        lora as jlora,
    )

    d, H, hd, f, V = 16, 4, 8, 40, 96
    pairs = [(Q_LIKE, (H * hd, d), jlora.Q_LIKE, (3, d, H, hd)),
             (O_LIKE, (d, H * hd), jlora.O_LIKE, (3, H, hd, d)),
             (MLP_LIKE, (f, d), jlora.MLP_LIKE, (3, d, f)),
             (HEAD_LIKE, (d, V), jlora.HEAD_LIKE, (d, V))]
    for target, shape, jtarget, jshape in pairs:
        assert matrix_view(shape, target)[1:] == jlora.matrix_view(
            jshape, jtarget)[1:]
    assert matrix_view((3, f, d), MLP_LIKE) == ((3,), d, f)
    with pytest.raises(ValueError, match="fewer dims"):
        matrix_view((d,), MLP_LIKE)


@pytest.mark.parametrize("case", ["gpt2", "llama-untied"])
def test_quantize_for_decode_matches_jax(case):
    """The same leaves quantized, payloads equal and scales within one
    fp32 ulp, whether the port quantizes its own weights or carries JAX's
    int8 tree across ``interop``."""
    jm, variables, tm = model_pair(case)
    qt = quantize_for_decode(tm)
    qj = jax.tree.map(np.asarray, jax_quantize(variables["params"]))
    carried = decoder_from_jax_params(qj, tm.cfg, device="cpu")

    def quantized(m):
        return {n: w for n, w in m.named_modules()
                if isinstance(w, QuantizedWeight)}

    mine, theirs = quantized(qt), quantized(carried)

    def n_int8(tree):
        return sum(isinstance(x, dict) for x in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, dict) and "q" in x))

    # a stacked JAX leaf is one port weight per layer
    n_layers = n_int8(qj["layers"])
    assert len(theirs) == (n_layers * tm.cfg.n_layers
                           + n_int8(qj) - n_layers)
    assert sorted(mine) == sorted(theirs)
    assert "embed" in mine and ("lm_head" in mine) == (
        not tm.cfg.tie_embeddings)
    assert not any("norm" in n or "pos_embed" in n for n in mine)
    for name, w in mine.items():
        assert w.q.dtype == torch.int8
        assert torch.equal(w.q, theirs[name].q), name
        ulp = torch.finfo(torch.float32).eps * w.scale.abs()
        assert torch.all((w.scale - theirs[name].scale).abs() <= ulp), name
    # the full-precision model is untouched; norms and biases stay fp32
    assert isinstance(tm.embed, torch.nn.Parameter)
    for name, p in qt.named_parameters():
        assert p.dtype == torch.float32 and p.dim() == 1 or (
            name == "pos_embed"), name


@pytest.mark.parametrize("case", ["gpt2", "llama-window"])
def test_int8_generate_matches_jax(case):
    jm, variables, tm = model_pair(case)
    qv = {"params": jax_quantize(variables["params"])}
    qt = quantize_for_decode(tm)
    prompt = _prompt(seed=4)
    want = np.asarray(jdec.generate(jm, qv, jnp.asarray(prompt),
                                    max_new_tokens=10,
                                    cache_dtype=jnp.float32))
    got = tdec.generate(qt, torch.from_numpy(prompt), max_new_tokens=10,
                        cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # logits of the prompt chunk, every position
    jc = jdec.KVCache.init(jm.cfg, 2, 16, dtype=jnp.float32)
    jl, _ = jdec.forward_cached(qv["params"], jm.cfg, jnp.asarray(prompt),
                                jc, all_logits=True)
    tc = tdec.KVCache.init(qt.cfg, 2, 16, dtype=torch.float32)
    tl, _ = tdec.forward_cached(qt, torch.from_numpy(prompt).long(), tc,
                                all_logits=True)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-4 * np.abs(jl).max())


@pytest.mark.parametrize("quant", [None, "int8"])
def test_autodistribute_generate_matches_jax_generate(quant):
    """``AutoDistribute.generate`` on trained-state weights, bf16-cache
    default, greedy: the JAX ``decode.generate`` of the same (quantized)
    weights — what the JAX ``AutoDistribute.generate`` runs."""
    jm, variables, tm = model_pair("gpt2")
    ad = AutoDistribute(tm, loss_fn=next_token_loss, device="cpu")
    state = ad.init(None)
    prompt = _prompt(seed=5)
    jv = variables if quant is None else {
        "params": jax_quantize(variables["params"])}
    want = np.asarray(jdec.generate(jm, jv, jnp.asarray(prompt),
                                    max_new_tokens=9))
    got = ad.generate(state, torch.from_numpy(prompt), max_new_tokens=9,
                      quant=quant)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="quant"):
        ad.generate(state, prompt, max_new_tokens=2, quant="int4")


def test_autodistribute_generate_reads_mixed_precision_masters():
    """Under ``mixed`` the module holds bf16 copies; ``generate`` decodes
    with the state's fp32 masters, as the JAX state's params are."""
    jm, variables, tm = model_pair("llama-window")
    ad = AutoDistribute(decoder_from_jax_params(
        jax.tree.map(np.asarray, variables["params"]), tm.cfg,
        device="cpu"), loss_fn=next_token_loss, precision="mixed",
        device="cpu")
    state = ad.init(None)
    assert ad.model.embed.dtype == torch.bfloat16
    prompt = torch.from_numpy(_prompt(seed=6))
    got = ad.generate(state, prompt, max_new_tokens=6)
    want = tdec.generate(tm, prompt, max_new_tokens=6)
    assert torch.equal(got, want)


def test_generate_text_example_on_cpu(capsys):
    """The example's int8 and speculative modes at the test size: the
    speculative output is the plain greedy output of its model."""
    from torch_automatic_distributed_neural_network_tpu_torch.examples import (
        generate_text,
    )

    base = ["model.size=test", "model.vocab_size=256", "run.device=cpu",
            "run.new_tokens=8", "run.prompt_len=6"]
    res = generate_text.main(base + ["run.quant=int8", "run.batch_size=2"])
    assert res["tokens"].shape == (2, 14)
    assert any(isinstance(m, QuantizedWeight)
               for m in res["model"].modules())
    res = generate_text.main(base + ["run.speculative=1"])
    want = tdec.generate(res["model"], res["prompt"], max_new_tokens=8)
    np.testing.assert_array_equal(res["tokens"], want.numpy())
    assert "tok/s" in capsys.readouterr().out
    # the plan-aware decode (one process here: the plan's one device)
    res = generate_text.main(base + ["run.strategy=tp", "run.batch_size=2"])
    want = tdec.generate(
        res["model"], res["prompt"], max_new_tokens=8,
        sample=tdec.SampleConfig(temperature=0.8, top_k=40),
        generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(res["tokens"], want.numpy())
