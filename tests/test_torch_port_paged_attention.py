"""Paged decode attention: the PyTorch port's ``paged_attention`` (on the
CPU, its plain version) and ``paged_attention_reference`` against the
JAX package's Pallas kernel (interpret mode, as its own tests run it)
and its reference, on the same numpy inputs.

Sweep as in ``tests/test_paged_attention.py``: block sizes {8, 16} x
{fp32, int8} pools x window {None, 5}, GQA 8q/4kv, ragged ctx
[0, 5, 17, 41], plus a null-table (inactive) slot.  Tolerance: atol
1e-5 in fp32.  The CUDA kernel itself is held against the same plain
version on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference.quant import (
    quantize_kv as j_quantize_kv,
)
from torch_automatic_distributed_neural_network_tpu.ops import attention as jatt
from torch_automatic_distributed_neural_network_tpu.ops.paged_attention import (
    paged_attention as j_paged,
    paged_attention_reference as j_reference,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    quantize_kv,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops import attention as tatt
from torch_automatic_distributed_neural_network_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

ATOL = 1e-5


def _case(rs, *, S, Hq, kvH, hd, bs, max_blocks, NB, ctx_lens, quantized,
          null_slot=None):
    k = rs.randn(NB, bs, kvH, hd).astype(np.float32)
    v = rs.randn(NB, bs, kvH, hd).astype(np.float32)
    tables = np.zeros((S, max_blocks), np.int32)
    nxt = 1
    for s, ctx in enumerate(ctx_lens):
        if s == null_slot:
            continue
        n = ctx // bs + 1
        tables[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    assert nxt <= NB
    q = rs.randn(S, Hq, hd).astype(np.float32)
    ctx = np.asarray(ctx_lens, np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, ctx)]
    j = [jnp.asarray(a) for a in (q, k, v, tables, ctx)]
    if quantized:
        t[1], t[2] = quantize_kv(t[1]), quantize_kv(t[2])
        j[1], j[2] = j_quantize_kv(j[1]), j_quantize_kv(j[2])
    return t, j


@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_attention_matches_jax(block_size, quantized, window):
    rs = np.random.RandomState(0)
    t, j = _case(rs, S=5, Hq=8, kvH=4, hd=32, bs=block_size,
                 max_blocks=48 // block_size, NB=32,
                 ctx_lens=[0, 5, 17, 41, 0], quantized=quantized,
                 null_slot=4)
    got = paged_attention(*t, window=window)
    got_ref = paged_attention_reference(*t, window=window)
    want_kernel = np.asarray(j_paged(*j, window=window))
    want_ref = np.asarray(j_reference(*j, window=window))
    assert got.shape == (5, 8, 32) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    for name, arr in (("jax kernel", want_kernel), ("jax reference", want_ref)):
        err = float(np.abs(got.numpy() - arr).max())
        assert err < ATOL, f"{name}: {err}"
    np.testing.assert_array_equal(got.numpy(), got_ref.numpy())


def test_bf16_pool_and_query():
    """bf16 pool and bf16 q: the reference's bf16 rounding points match
    JAX's (atol 2e-2, about two bf16 ulps at |x| ~ 2)."""
    rs = np.random.RandomState(1)
    t, j = _case(rs, S=3, Hq=4, kvH=4, hd=32, bs=8, max_blocks=4, NB=16,
                 ctx_lens=[3, 12, 30], quantized=False)
    t = [t[0].to(torch.bfloat16), t[1].to(torch.bfloat16),
         t[2].to(torch.bfloat16)] + t[3:]
    j = [j[0].astype(jnp.bfloat16), j[1].astype(jnp.bfloat16),
         j[2].astype(jnp.bfloat16)] + j[3:]
    got = paged_attention(*t)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_reference(*j).astype(jnp.float32))
    assert float(np.abs(got.float().numpy() - want).max()) < 2e-2


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("gqa", [False, True])
def test_xla_attention_matches_jax(window, gqa):
    """The reference attention: causal band + explicit mask, GQA, fp32
    softmax and the bf16 cast of the probabilities before PV."""
    rs = np.random.RandomState(2)
    B, S, Hq, hd = 2, 9, 4, 16
    kvH = 2 if gqa else Hq
    q = rs.randn(B, S, Hq, hd).astype(np.float32)
    k = rs.randn(B, S, kvH, hd).astype(np.float32)
    v = rs.randn(B, S, kvH, hd).astype(np.float32)
    mask = rs.rand(B, 1, 1, S) > 0.2
    got = tatt.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, mask=torch.from_numpy(mask))
    want = jatt.xla_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, window=window,
                              mask=jnp.asarray(mask))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < ATOL
    got = tatt.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
        torch.from_numpy(v).to(torch.bfloat16), causal=True, window=window)
    want = jatt.xla_attention(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                              jnp.asarray(v, jnp.bfloat16), causal=True,
                              window=window)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max()) < 2e-2


def test_window_checks():
    x = torch.zeros(1, 2, 1, 4)
    with pytest.raises(ValueError, match="causal"):
        tatt.xla_attention(x, x, x, window=2)
    with pytest.raises(ValueError, match=">= 1"):
        tatt.xla_attention(x, x, x, causal=True, window=0)
