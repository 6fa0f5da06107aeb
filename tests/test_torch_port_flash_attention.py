"""Flash attention and the attention dispatcher: the PyTorch port against
the JAX package on the same numpy inputs.

On the CPU the port's ``flash_attention`` runs the kernels' plain
versions (``flash_forward_reference`` and the backward terms) inside its
``torch.autograd.Function``; the JAX side runs its Pallas kernels in
interpret mode (its default on the CPU), with blocks of 16 or 32 so a
ragged length crosses block edges.  fp32 throughout: o, lse and every
gradient agree to atol 1e-5 (sums in another order; values are O(1)).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.ops import attention as jattn
from torch_automatic_distributed_neural_network_tpu.ops import flash_attention as jflash
from torch_automatic_distributed_neural_network_tpu_torch.ops import attention as tattn
from torch_automatic_distributed_neural_network_tpu_torch.ops import (
    flash_attention as tflash,
)

ATOL = 1e-5


def _inputs(seed, B, S, H, kvH, D, Sk=None):
    rs = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    q = rs.randn(B, S, H, D).astype(np.float32)
    k = rs.randn(B, Sk, kvH, D).astype(np.float32)
    v = rs.randn(B, Sk, kvH, D).astype(np.float32)
    do = rs.randn(B, S, H, D).astype(np.float32)
    return q, k, v, do


def _torch(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# causal and not, a window with GQA, ragged lengths (not a multiple of the
# JAX blocks), and cross-attention lengths (non-causal Sq != Sk)
CASES = {
    "full": dict(B=1, S=64, H=2, kvH=2, D=32, causal=False, window=None),
    "causal": dict(B=2, S=48, H=2, kvH=2, D=32, causal=True, window=None),
    "window_gqa": dict(B=1, S=64, H=4, kvH=2, D=16, causal=True, window=9),
    "ragged_causal": dict(B=1, S=37, H=2, kvH=1, D=32, causal=True,
                          window=None),
    "ragged_cross": dict(B=1, S=21, H=2, kvH=2, D=32, causal=False,
                         window=None, Sk=45),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    c = dict(CASES[name])
    causal, window = c.pop("causal"), c.pop("window")
    q, k, v, do = _inputs(0, **c)

    def jfn(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, causal=causal,
                                      window=window, block_q=16, block_k=16)

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = _torch(q, k, v)
    to = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(to, jo)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    for g, jg in zip(tgrads, jgrads):
        _close(g, jg)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_with_lse_matches_jax(causal):
    """o and lse forward; gradients with an lse cotangent (folded into
    delta by both sides)."""
    q, k, v, do = _inputs(1, B=1, S=40, H=2, kvH=1, D=32)
    dlse = np.random.RandomState(2).randn(1, 2, 40).astype(np.float32)

    def jfn(q_, k_, v_):
        return jflash.flash_attention_with_lse(q_, k_, v_, causal=causal,
                                               block_q=16, block_k=16)

    (jo, jlse), vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = _torch(q, k, v)
    to, tlse = tflash.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert tlse.shape == (1, 2, 40) and tlse.dtype == torch.float32
    _close(to, jo)
    _close(tlse, jlse)
    tgrads = torch.autograd.grad((to, tlse), (tq, tk, tv),
                                 (torch.from_numpy(do),
                                  torch.from_numpy(dlse)))
    for g, jg in zip(tgrads, jgrads):
        _close(g, jg)


def test_plain_versions_agree_with_autograd_of_the_dense_forward():
    """The hand-derived backward (the kernels' plain version) against
    autograd through ``flash_forward_reference`` itself, and the CPU
    wrappers against the plain versions they run."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(3, B=2, S=33, H=2, kvH=2, D=16))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = tflash.flash_forward_reference(q, k, v, True, 5)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tflash.flash_backward_reference(q, k, v, o.detach(), lse.detach(),
                                          do, causal=True, window=5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    delta = tflash._delta(o.detach(), do)
    o2, lse2 = tflash.flash_forward(q, k, v, causal=True, window=5)
    dk, dv = tflash.flash_dkv(q, k, v, do, lse2, delta, causal=True, window=5)
    dq = tflash.flash_dq(q, k, v, do, lse2, delta, causal=True, window=5)
    for g, w in zip((o2, lse2, dq, dk, dv), (o, lse, *got)):
        assert torch.equal(g, w)


def test_causal_needs_equal_lengths_and_window_needs_causal():
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(4, B=1, S=8, H=2, kvH=2, D=16, Sk=12))
    with pytest.raises(NotImplementedError, match="seq_q == seq_k"):
        tflash.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_attention(q, k, v, window=4)


@pytest.mark.parametrize("causal,window,with_mask", [
    (False, None, False), (True, None, False), (True, 7, False),
    (False, None, True), (True, None, True)])
def test_chunked_attention_matches_jax(causal, window, with_mask):
    """Ragged query blocks (S 50, block 16), GQA, an explicit padding mask."""
    q, k, v, do = _inputs(5, B=2, S=50, H=4, kvH=2, D=16)
    mask = None
    if with_mask:
        keep = np.random.RandomState(6).rand(2, 1, 1, 50) > 0.2
        keep[..., 0] = True
        mask = keep

    def jfn(q_, k_, v_):
        return jattn.chunked_attention(
            q_, k_, v_, causal=causal, window=window,
            mask=None if mask is None else jnp.asarray(mask), block_q=16)

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = _torch(q, k, v)
    to = tattn.chunked_attention(
        tq, tk, tv, causal=causal, window=window,
        mask=None if mask is None else torch.from_numpy(mask), block_q=16)
    _close(to, jo)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    for g, jg in zip(tgrads, jgrads):
        _close(g, jg)


@pytest.mark.parametrize("S,with_mask,impl", [
    (16, False, "auto"), (512, False, "auto"), (1024, False, "auto"),
    (1024, True, "auto"), (16, False, "ring"), (16, False, "ulysses"),
    (16, False, "chunked")])
def test_dispatcher_choice_on_cpu_matches_jax(monkeypatch, S, with_mask,
                                              impl):
    """Off the TPU, JAX's auto dispatch never takes flash (no TPU) and
    the port's never does on a CPU tensor: xla below 1024, chunked from
    1024; ring/ulysses without a sequence axis are plain attention."""
    chosen = {}
    for side, mod in (("jax", jattn), ("torch", tattn)):
        for name in ("xla_attention", "chunked_attention"):
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, _side=side, **kw):
                chosen[_side] = _name
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, spy)
    q = np.random.RandomState(7).randn(1, S, 2, 8).astype(np.float32)
    mask = np.ones((1, 1, 1, S), bool) if with_mask else None
    jattn.attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                    causal=True,
                    mask=None if mask is None else jnp.asarray(mask),
                    impl=impl)
    t = torch.from_numpy(q)
    tattn.attention(t, t, t, causal=True,
                    mask=None if mask is None else torch.from_numpy(mask),
                    impl=impl)
    assert chosen["torch"] == chosen["jax"], chosen
    want = {"auto": "chunked_attention" if S >= 1024 else "xla_attention",
            "chunked": "chunked_attention"}.get(impl, "xla_attention")
    assert chosen["torch"] == want


def test_flash_gate_is_mask_shape_and_device():
    """``_flash_ok``: no mask, Sq == Sk >= 512, a CUDA tensor; flash
    forced with a mask raises."""
    t = torch.zeros(1, 512, 2, 32)
    with pytest.raises(NotImplementedError, match="mask"):
        tattn.attention(t, t, t, mask=torch.ones(1, 1, 1, 512, dtype=bool),
                        impl="flash")
    assert not tattn._flash_ok(t, t, None)  # a CPU tensor

    def fake(S):  # the gate reads only the shape and the device
        return types.SimpleNamespace(shape=(1, S, 2, 32), is_cuda=True)

    assert tattn._flash_ok(fake(512), fake(512), None)
    assert tattn._flash_ok(fake(1024), fake(1024), None)
    assert not tattn._flash_ok(fake(511), fake(511), None)
    assert not tattn._flash_ok(fake(512), fake(600), None)
    assert not tattn._flash_ok(fake(512), fake(512), mask=object())
