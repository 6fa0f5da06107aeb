"""The full-sequence forward of ``DecoderLM``: the PyTorch port against
the JAX package on the same weights (carried by ``interop``) and the
same numpy tokens.

fp32 logits and features agree to atol 1e-4 (sums in another order
through two layers and the head).  In bf16 the tied head is flax's
``Embed.attend``: a bf16 product rounded to bf16, then fp32; the port's
logits are bf16 values and agree with JAX's to a few bf16 ulps of the
logits' scale.  Remat (either policy) changes no gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
    llama_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    next_token_loss,
)

ATOL = 1e-4
FAMILIES = {"gpt2": (GPT2, gpt2_config), "llama": (Llama, llama_config)}
# GPT-2 widths with the other residual order, an embedding norm and no
# final norm: the config fields the serving slice left out
VARIANTS = {
    "gpt2": ("gpt2", {}),
    "llama": ("llama", {}),
    "gpt2-post": ("gpt2", dict(norm_order="post", embed_norm=True,
                               final_norm=False)),
    "llama-window": ("llama", dict(sliding_window=5)),
}


@functools.lru_cache(maxsize=None)
def model_pair(variant, dtype="float32", attention_impl="auto",
               scan_layers=True):
    """A JAX decoder with random weights and the port's copy of it."""
    family, extra = VARIANTS[variant]
    jcls, tcfg = FAMILIES[family]
    kw = dict(vocab_size=128, max_seq_len=64, attention_impl=attention_impl,
              **extra)
    jm = jcls("test", dtype=getattr(jnp, dtype), remat=False,
              scan_layers=scan_layers, **kw)
    variables = jm.init(jax.random.key(3), jnp.zeros((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    tm = decoder_from_jax_params(
        params, tcfg("test", dtype=getattr(torch, dtype), remat=False, **kw),
        device="cpu")
    return jm, variables, tm


def _tokens(seed=0, B=2, S=24):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_features_match_jax(variant):
    jm, variables, tm = model_pair(variant)
    toks = _tokens()
    jl = jm.apply(variables, jnp.asarray(toks))
    jf = jm.apply(variables, jnp.asarray(toks), return_features=True)
    with torch.no_grad():
        tl = tm(torch.from_numpy(toks))
        tf = tm(torch.from_numpy(toks), return_features=True)
    assert tl.shape == (2, 24, 128) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)


def test_interop_takes_the_unscanned_layout():
    jm, variables, tm = model_pair("gpt2", scan_layers=False)
    assert "layers_0" in variables["params"]
    toks = _tokens(1)
    with torch.no_grad():
        tl = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(
        tl.numpy(), np.asarray(jm.apply(variables, jnp.asarray(toks))),
        atol=ATOL)


def test_flash_impl_matches_jax():
    """``attention_impl="flash"`` on both sides: JAX's Pallas kernels in
    interpret mode, the port's plain versions of K1-K3."""
    jm, variables, tm = model_pair("llama", attention_impl="flash")
    toks = _tokens(2, S=20)
    np.testing.assert_allclose(
        tm(torch.from_numpy(toks)).detach().numpy(),
        np.asarray(jm.apply(variables, jnp.asarray(toks))), atol=ATOL)


def test_tied_head_rounds_in_compute_dtype_like_embed_attend():
    """bf16 GPT-2: the tied head is a bf16 product (``Embed.attend``
    promotes both operands to the Embed dtype), not the fp32 product of
    ``DecoderLM.logits`` that the decode path uses."""
    jm, variables, tm = model_pair("gpt2", dtype="bfloat16")
    toks = _tokens(3)
    jl = np.asarray(jm.apply(variables, jnp.asarray(toks)))
    with torch.no_grad():
        tl = tm(torch.from_numpy(toks))
        feats = tm(torch.from_numpy(toks), return_features=True)
    assert feats.dtype == torch.bfloat16
    # every logit is a bf16 value, as Embed.attend's are
    assert torch.equal(tl.to(torch.bfloat16).float(), tl)
    assert np.array_equal(jl.astype(jnp.bfloat16).astype(np.float32), jl)
    fp32_head = tm.logits(feats.float())
    assert not torch.equal(fp32_head, tl)
    # bf16 through two layers on both sides: a few ulps of the logits'
    # scale (bf16 has 8 bits of mantissa)
    scale = float(np.abs(jl).max())
    np.testing.assert_allclose(tl.numpy(), jl, atol=4 * scale * 2 ** -8)


@pytest.mark.parametrize("policy,dropout", [("dots", 0.0), ("nothing", 0.0),
                                            ("dots", 0.1)])
def test_remat_changes_no_gradient(policy, dropout):
    """Per-layer recompute (with dropout drawn from the same generator
    seed) gives the same loss and gradients as no remat."""
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        GPT2 as TGPT2,
    )

    toks = torch.from_numpy(_tokens(4, S=17)).long()
    grads = {}
    for remat in (False, True):
        m = TGPT2("test", vocab_size=128, max_seq_len=64,
                  dtype=torch.float32, remat=remat, remat_policy=policy,
                  dropout_rate=dropout)
        m.init_weights(torch.Generator().manual_seed(5))
        loss, _ = next_token_loss(m, {"input_ids": toks},
                                  torch.Generator().manual_seed(6))
        g = torch.autograd.grad(loss, list(m.parameters()))
        grads[remat] = (loss.detach(), g)
    assert torch.equal(grads[False][0], grads[True][0])
    for a, b in zip(grads[False][1], grads[True][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_encoder_inputs_are_not_ported_yet():
    _, _, tm = model_pair("gpt2")
    toks = torch.zeros(1, 4, dtype=torch.long)
    for kw in (dict(segment_ids=toks), dict(inputs_embeds=torch.zeros(1, 4)),
               dict(head=lambda x, e: x)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            tm(toks, **kw)
