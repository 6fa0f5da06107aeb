"""Flash attention in bf16: the PyTorch port against the JAX package.

On the CPU the port's ``flash_attention`` runs the kernels' plain
versions inside its ``torch.autograd.Function``; the JAX side runs its
Pallas kernels in interpret mode with blocks of 16, so a ragged length
crosses block edges.  Both sides take the same bf16 inputs (made with
numpy) and round at the same points (scores in fp32, ``p`` to bf16 before
``p . v``, ``ds`` to bf16 before its products, the outputs to bf16), so o
and every gradient agree to one bf16 ulp at |x| in [2, 4): atol 1.6e-2
(1/64).  The sums run in another order on each side, which can move a
value across a rounding boundary.

The bf16 dK/dV kernel keeps ``p`` in fp32 for ``dv += p^T . do`` as JAX
does (it upcasts ``do``), by splitting ``p`` into two bf16 terms; the last
test holds that model of its arithmetic to the fp32 product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.ops import flash_attention as jflash
from torch_automatic_distributed_neural_network_tpu_torch.ops import (
    flash_attention as tflash,
)

ATOL = 1.6e-2

CASES = {
    "full": dict(B=1, S=48, H=2, kvH=2, D=32, causal=False, window=None),
    "causal": dict(B=1, S=48, H=2, kvH=2, D=32, causal=True, window=None),
    "window_gqa": dict(B=1, S=64, H=4, kvH=2, D=16, causal=True, window=9),
    "ragged": dict(B=2, S=37, H=2, kvH=1, D=32, causal=True, window=None),
}


def _inputs(seed, B, S, H, kvH, D):
    rs = np.random.RandomState(seed)
    shapes = ((B, S, H, D), (B, S, kvH, D), (B, S, kvH, D), (B, S, H, D))
    # round once to bf16 here, so both sides start from the same values
    return [torch.from_numpy(rs.randn(*s).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_bf16_matches_jax(name):
    c = dict(CASES[name])
    causal, window = c.pop("causal"), c.pop("window")
    q, k, v, do = _inputs(11, **c)

    def jfn(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, causal=causal,
                                      window=window, block_q=16, block_k=16)

    jo, vjp = jax.vjp(jfn, _to_jax(q), _to_jax(k), _to_jax(v))
    jgrads = vjp(_to_jax(do))
    assert jo.dtype == jnp.bfloat16

    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    to = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert to.dtype == torch.bfloat16
    _close(to, jo)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), do)
    for g, jg in zip(tgrads, jgrads):
        assert g.dtype == torch.bfloat16
        _close(g, jg)


def _dv_terms(seed=5, S=512, H=2, D=64):
    """p (fp32, from the plain version's backward terms) and do of a
    causal bf16 attention, as the dK/dV kernel sees them."""
    q, k, v, do = _inputs(seed, B=1, S=S, H=H, kvH=H, D=D)
    o, lse = tflash.flash_forward_reference(q, k, v, True)
    delta = tflash._delta(o, do)
    p, _ = tflash._backward_terms(q, k, v, do, lse, delta, True, None)
    return p, do, (q, k, v, do, lse, delta)


def test_dv_hi_lo_split_keeps_the_fp32_product():
    """The kernel's dv = (hi + lo)^T . do with hi = bf16(p), lo =
    bf16(p - hi) and fp32 sums stays within 1e-4 of JAX's fp32 p^T . do;
    rounding p to bf16 once (what a plain bf16 product would do) misses
    that bound.  In bf16 the split changes at most 2 % of dv's elements
    and the single rounding far more: the share bound the card holds K2
    to tells the two apart."""
    p, do, operands = _dv_terms()
    want = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    split = (torch.einsum("bhqk,bqhd->bkhd", hi, do.float())
             + torch.einsum("bhqk,bqhd->bkhd", lo, do.float()))
    single = torch.einsum("bhqk,bqhd->bkhd", hi, do.float())
    assert float((split - want).abs().max()) <= 1e-4
    assert float((single - want).abs().max()) > 1e-4
    want16 = want.to(torch.bfloat16)

    def share(x):
        return float((x.to(torch.bfloat16) != want16).float().mean())

    assert share(split) <= 0.02
    assert share(single) > 0.2
    # and the plain version, the kernel's oracle, keeps p in fp32
    _, dv = tflash.flash_dkv_reference(*operands, causal=True)
    assert torch.equal(dv, want.to(torch.bfloat16))
