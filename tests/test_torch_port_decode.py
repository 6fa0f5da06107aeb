"""KV-cached forward pass and sampling: the PyTorch port against the JAX
package on the same weights (carried across by ``interop``) and the same
numpy tokens.

``forward_cached`` logits and cache rows agree to atol 1e-4 in fp32, for
a prompt chunk followed by single-token steps, on GPT-2 ``test`` and
Llama ``test`` (also with a sliding window).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference import decode as jdec
from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu_torch.inference import decode as tdec
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
    llama_config,
)

ATOL = 1e-4
FAMILIES = {"gpt2": (GPT2, gpt2_config), "llama": (Llama, llama_config)}


@functools.lru_cache(maxsize=None)
def model_pair(family, seed=1, sliding_window=None):
    """A JAX decoder with random weights and the port's copy of it
    (cached: the tests change neither)."""
    jcls, tcfg = FAMILIES[family]
    kw = dict(vocab_size=128, max_seq_len=64, sliding_window=sliding_window)
    jm = jcls("test", dtype=jnp.float32, remat=False, **kw)
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    tm = decoder_from_jax_params(
        params, tcfg("test", dtype=torch.float32, **kw), device="cpu")
    return jm, variables, tm


def test_interop_maps_every_parameter():
    _, variables, tm = model_pair("llama")
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree.leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in tm.parameters())
    assert n_jax == tm.cfg.num_params()


@pytest.mark.parametrize("family,window", [("gpt2", None), ("llama", None),
                                           ("llama", 4)])
def test_forward_cached_matches_jax(family, window):
    jm, variables, tm = model_pair(family, sliding_window=window)
    cfg = jm.cfg
    rs = np.random.RandomState(0)
    B, P, S_max = 2, 7, 16
    toks = rs.randint(1, 128, size=(B, P)).astype(np.int32)
    jc = jdec.KVCache.init(cfg, B, S_max, dtype=jnp.float32)
    tc = tdec.KVCache.init(tm.cfg, B, S_max, dtype=torch.float32)
    jl, jc = jdec.forward_cached(variables["params"], cfg, jnp.asarray(toks),
                                 jc, all_logits=True)
    tl, tc = tdec.forward_cached(tm, torch.from_numpy(toks).long(), tc,
                                 all_logits=True)
    assert tl.shape == (B, P, 128) and tc.length == P
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for _ in range(3):
        tok = rs.randint(1, 128, size=(B, 1)).astype(np.int32)
        jl, jc = jdec.forward_cached(variables["params"], cfg,
                                     jnp.asarray(tok), jc)
        tl, tc = tdec.forward_cached(tm, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc.length == int(jc.length) == P + 3
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL)


def test_forward_cached_bf16_cache_rounds_like_jax():
    """The serving prefill's bf16 temp cache: keys round to bf16 on write
    and the probabilities are cast to bf16 before PV, on both sides."""
    jm, variables, tm = model_pair("gpt2")
    toks = np.random.RandomState(1).randint(1, 128, (1, 9)).astype(np.int32)
    jc = jdec.KVCache.init(jm.cfg, 1, 32, dtype=jnp.bfloat16)
    tc = tdec.KVCache.init(tm.cfg, 1, 32, dtype=torch.bfloat16)
    jl, jc = jdec.forward_cached(variables["params"], jm.cfg,
                                 jnp.asarray(toks), jc)
    tl, tc = tdec.forward_cached(tm, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # rows agree to one bf16 rounding of an fp32 difference ~1e-6
    diff = np.abs(tc.k.float().numpy() - np.asarray(jc.k, np.float32))
    assert float(diff.max()) <= 2 ** -7 * float(tc.k.float().abs().max())


def test_greedy_sampling_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    got = tdec._sample(logits, None, tdec.SampleConfig(temperature=0.0))
    want = jdec._sample(jnp.asarray(logits.numpy()), None,
                        jdec.SampleConfig(temperature=0.0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 0])


def test_stochastic_sampling_is_seeded_and_filtered():
    logits = torch.from_numpy(
        np.random.RandomState(2).randn(64, 32).astype(np.float32))
    sc = tdec.SampleConfig(temperature=0.7, top_k=5, top_p=0.9)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tdec._sample(logits, gen, sc)

    a, b = draw(0), draw(0)
    assert torch.equal(a, b)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert bool((top5 == a[:, None].long()).any(-1).all())
    with pytest.raises(ValueError, match="top_p"):
        tdec.SampleConfig(top_p=0.0)
