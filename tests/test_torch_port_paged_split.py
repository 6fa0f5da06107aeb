"""K4's split context, modelled on the CPU: ``paged_attention_split_reference``
(the kernel's partition of a slot's pages into chunks, a partial softmax
state per chunk, the merge in split order) against the JAX package's
Pallas ``paged_attention`` in interpret mode, as its own tests run it, on
the same numpy inputs.

Split counts 1, 2, 3 and 7 over ragged contexts: ctx 0 (one key), a
context ending on a page boundary, splits past the attended pages, a
window that leaves whole splits empty, GQA 8q/4kv, fp32 and int8 pools.
Tolerance: atol 1e-5 in fp32 (sums in another order).  A slot with no
attended key (ctx -1) gives zeros in both.  The CUDA kernel itself is
held against the dense plain version on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference.quant import (
    quantize_kv as j_quantize_kv,
)
from torch_automatic_distributed_neural_network_tpu.ops.paged_attention import (
    paged_attention as j_paged,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    quantize_kv,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_attention_split_reference,
    split_chunks,
    split_count,
)

ATOL = 1e-5
CTX = [0, 5, 15, 16, 17, 41, -1]  # -1: no attended key


def _case(*, bs, quantized, seed):
    rs = np.random.RandomState(seed)
    S, Hq, kvH, hd, MB = len(CTX), 8, 4, 32, 48 // bs
    NB = 1 + S * MB
    k = rs.randn(NB, bs, kvH, hd).astype(np.float32)
    v = rs.randn(NB, bs, kvH, hd).astype(np.float32)
    tables = np.zeros((S, MB), np.int32)
    nxt = 1
    for s, ctx in enumerate(CTX):
        n = max(ctx, 0) // bs + 1
        tables[s, :n] = rs.permutation(np.arange(nxt, nxt + n))
        nxt += n
    q = rs.randn(S, Hq, hd).astype(np.float32)
    ctx = np.asarray(CTX, np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, ctx)]
    j = [jnp.asarray(a) for a in (q, k, v, tables, ctx)]
    if quantized:
        t[1], t[2] = quantize_kv(t[1]), quantize_kv(t[2])
        j[1], j[2] = j_quantize_kv(j[1]), j_quantize_kv(j[2])
    return t, j


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("window", [None, 5, 20])
@pytest.mark.parametrize("bs,quantized", [(8, False), (16, False), (8, True)])
def test_split_merge_matches_jax_kernel(n_split, window, bs, quantized):
    t, j = _case(bs=bs, quantized=quantized, seed=n_split + bs)
    got = paged_attention_split_reference(*t, window=window, n_split=n_split)
    want = np.asarray(j_paged(*j, window=window))
    assert got.shape == (len(CTX), 8, 32) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    err = float(np.abs(got.numpy() - want).max())
    assert err < ATOL, err
    # the slot with no attended key: zeros, in the model and in JAX
    assert not got[-1].any() and not want[-1].any()
    # and the dense plain version agrees wherever a key is attended
    dense = paged_attention_reference(*t, window=window)
    assert float((got[:-1] - dense[:-1]).abs().max()) < ATOL


def test_split_chunks_cover_the_attended_pages_once():
    """Every attended page lands in exactly one split, in order; splits
    past the attended pages are empty, and a window leaves the pages
    before it out."""
    bs, MB = 8, 6
    for ctx in (-1, 0, 7, 8, 41, 47):
        for window in (None, 1, 5, 20):
            for n_split in (1, 2, 3, 7):
                lo, chunks = split_chunks(ctx, window, bs, MB, n_split)
                pages = [p for pb, pe in chunks for p in range(pb, pe)]
                want = list(range(lo // bs, ctx // bs + 1)) if ctx >= 0 else []
                assert pages == want, (ctx, window, n_split, chunks)
                assert len(chunks) == n_split
    # a 5-key window at ctx 41 holds 2 pages: the third of 3 splits is empty
    _, chunks = split_chunks(41, 5, bs, MB, 3)
    assert chunks == [(4, 5), (5, 6), (6, 6)]


def test_split_count_depends_on_shapes_only():
    # GPT-2 small decode: 8 slots x 12 kv heads on 132 SMs -> 4 splits
    # (3 give two blocks an SM; the next power of two)
    assert split_count(96, 64, 16, 132) == 4
    # few groups: capped at 16, and at a full context's 64-key chunks
    assert split_count(4, 1024, 16, 132) == 16
    assert split_count(32, 8, 16, 132) == 2
    assert split_count(1, 2, 8, 132) == 1
    # already two blocks an SM
    assert split_count(600, 64, 16, 132) == 1
