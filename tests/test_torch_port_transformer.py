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

import flax.linen as flax_nn

from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu.models import transformer_core as jcore
from torch_automatic_distributed_neural_network_tpu.models.gpt2 import (
    gpt2_config as jcfg_gpt2,
)
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


class _EncoderInputs(flax_nn.Module):
    """JAX's ``apply_decoder_backbone`` with the encoder families' three
    inputs: ``segment_ids``, ``inputs_embeds`` and ``head=``."""

    cfg: object

    @flax_nn.compact
    def __call__(self, tokens, segment_ids=None, inputs_embeds=None,
                 head=False, return_features=False):
        out, _ = jcore.apply_decoder_backbone(
            self, self.cfg, tokens, None, None, jcore.DecoderLayer,
            return_features=return_features, segment_ids=segment_ids,
            inputs_embeds=inputs_embeds,
            head=(lambda x, e: e.attend(x.astype(jnp.float32)) * 0.5)
            if head else None)
        return out


def test_encoder_inputs_match_jax():
    """The backbone's encoder inputs against JAX's on the same weights:
    segment embeddings (``type_vocab_size`` 2, token-type ids given and
    defaulted to zeros), given input embeddings in place of the token
    table, and a ``head(features, embed)`` in place of the tied head;
    fp32, atol 1e-4 as above."""
    kw = dict(vocab_size=128, max_seq_len=64, remat=False, type_vocab_size=2,
              dtype=jnp.float32)
    jm = _EncoderInputs(jcfg_gpt2("test", **kw))
    toks = _tokens(6)
    seg = (np.arange(24)[None] >= np.array([[5], [17]])).astype(np.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(7), jnp.asarray(toks), jnp.asarray(seg))["params"])
    tm = decoder_from_jax_params(params, gpt2_config(
        "test", **{**kw, "dtype": torch.float32}), device="cpu")
    assert tm.seg_embed.shape == (2, 128)
    embeds = np.random.RandomState(8).randn(2, 24, 128).astype(np.float32)
    cases = [
        (dict(segment_ids=seg), dict(segment_ids=seg)),
        ({}, {}),
        (dict(inputs_embeds=embeds, return_features=True),
         dict(inputs_embeds=embeds, return_features=True)),
        (dict(segment_ids=seg, head=True),
         dict(segment_ids=seg, head=lambda x, e: (x @ e.T) * 0.5)),
    ]
    for jkw, tkw in cases:
        jtoks = None if "inputs_embeds" in jkw else jnp.asarray(toks)
        arrays = {k: jnp.asarray(v) for k, v in jkw.items()
                  if isinstance(v, np.ndarray)}
        flags = {k: v for k, v in jkw.items() if k not in arrays}
        want = np.asarray(jax.jit(functools.partial(jm.apply, **flags))(
            {"params": params}, jtoks, **arrays))
        with torch.no_grad():
            got = tm(None if jtoks is None else torch.from_numpy(toks),
                     **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v for k, v in tkw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
