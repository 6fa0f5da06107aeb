"""Paged decode attention: block tables read in-kernel.

The serving decode step attends one query token per slot against the
slot's cached keys, which live in a block-paged pool.  The kernel
(``csrc/paged_attention.cu``, CUDA C++ for Hopper) reads each slot's
block table itself and streams the pages it needs into shared memory by
TMA, so the dense ``[S, max_len, kvH, hd]`` view of the pool is never
materialized, and int8 pages are dequantized as they are read.  Each
slot's context is split over several thread blocks (:func:`split_count`,
from the shapes alone), whose partial softmax states the last of them
merges in split order within the same launch.  It replaces the JAX
package's Pallas kernel ``ops/paged_attention.py::_decode_kernel``.

Shape of the problem (one decode token per slot):

    q:      [S, Hq, hd]          one query per slot, fp32 or bf16
    k/v:    [NB, bs, kvH, hd]    ONE layer of the paged pool, fp32 or
                                 bf16, or ``{"q": int8, "scale": fp32}``
    tables: [S, MB] int32        block ids, null-padded (kv_pool)
    ctx:    [S] int32            keys 0..ctx inclusive are valid

:func:`paged_attention_reference` is the plain version beside it: the
dense ``gather_blocks`` + ``xla_attention`` path the engine's
``attention_impl="dense"`` runs.  :func:`paged_attention` uses it only
for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises.  :func:`paged_attention_split_reference` is a plain model of the
kernel's split-and-merge arithmetic, for the tests.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..inference.quant import kv_leaf_parts
from .attention import xla_attention
from .build import load

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (32, 64, 96, 128)  # the kernel's template instances
_MAX_SMEM_BYTES = 232448  # what one Hopper thread block may use
_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
_MAX_SPLITS = 16
_MIN_CHUNK_TOKENS = 64  # a full context's chunk: keeps the merge small

_lib = None
# per device: int32 counters of the in-launch merge, zero between launches
_counters: dict[torch.device, torch.Tensor] = {}


def _library():
    """The built kernel library, its C signatures declared once."""
    global _lib
    if _lib is None:
        lib = load("paged_attention")
        ptr, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.tadnn_paged_attention_decode.argtypes = (
            [ptr] * 10 + [i32] * 11 + [ctypes.c_float, ptr])
        lib.tadnn_paged_attention_decode.restype = i32
        lib.tadnn_paged_attention_sizes.argtypes = (
            [i32] * 7 + [ctypes.POINTER(size)] * 3)
        lib.tadnn_paged_attention_sizes.restype = None
        lib.tadnn_cuda_error_string.argtypes = [i32]
        lib.tadnn_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch_sizes(kv_dtype, S, kvH, G, hd, MB, n_split):
    """(shared-memory bytes, workspace floats, counters) of one launch."""
    out = [ctypes.c_size_t() for _ in range(3)]
    _library().tadnn_paged_attention_sizes(
        kv_dtype, S, kvH, G, hd, MB, n_split, *(ctypes.byref(x) for x in out))
    return tuple(x.value for x in out)


def split_count(blocks: int, MB: int, bs: int, n_sm: int) -> int:
    """How many blocks share one (slot, kv head, query-row group): the
    power of two that gives ``blocks`` such groups at least two blocks an
    SM, no more than a full context's ``MB * bs`` keys in chunks of 64,
    and at most 16.  Shapes alone decide it, never the context lengths,
    so a launch is reproducible."""
    want = 1 << max(0, (-(-2 * n_sm // blocks) - 1).bit_length())
    return max(1, min(want, MB * bs // _MIN_CHUNK_TOKENS, _MAX_SPLITS))


def _counter_buffer(device, n):
    """At least ``n`` zeroed int32 counters on ``device``, kept for the
    next launch (each launch leaves them zero).  Launches that share a
    device must share a stream."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def kernel_takes(head_dim: int, q_dtype: torch.dtype,
                 pool_dtype: torch.dtype) -> bool:
    """Whether the kernel takes this geometry: a head dim in
    ``_HEAD_DIMS``, a query dtype in ``_Q_DTYPES`` and a pool dtype in
    ``_KV_DTYPES`` (int8 for a quantized pool).  The serving engine asks
    once, at construction, and on a CUDA device raises for any other
    geometry under ``attention_impl="paged"``."""
    return (head_dim in _HEAD_DIMS and q_dtype in _Q_DTYPES
            and pool_dtype in _KV_DTYPES)


def paged_attention(q: torch.Tensor, k_pool, v_pool, tables: torch.Tensor,
                    ctx_lens: torch.Tensor, *,
                    window: int | None = None) -> torch.Tensor:
    """Paged decode attention over one layer of the KV pool.

    Returns [S, Hq, hd] in ``q.dtype``.  On the CPU this is the plain
    version; on a CUDA tensor it launches the kernel (and counts the
    launch in ``paged_attention.launches``)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables,
                                         ctx_lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _paged_attention_cuda(q, k_pool, v_pool, tables, ctx_lens,
                                 window=window)


paged_attention.launches = 0


def _paged_attention_cuda(q, k_pool, v_pool, tables, ctx_lens, *, window,
                          splits=None):
    """The kernel launch; ``splits`` overrides :func:`split_count` (a
    sweep of the split count)."""
    k_arr, k_scale = kv_leaf_parts(k_pool)
    v_arr, v_scale = kv_leaf_parts(v_pool)
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k and v pools must both be int8 or both dense")
    S, Hq, hd = q.shape
    NB, bs, kvH, _ = k_arr.shape
    MB = tables.shape[1]
    if Hq % kvH:
        raise ValueError(f"{Hq} query heads not a multiple of {kvH} kv heads")
    G = Hq // kvH
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_DTYPES)}")
    if k_arr.dtype not in _KV_DTYPES or v_arr.dtype != k_arr.dtype:
        raise TypeError(f"pool dtypes {k_arr.dtype}/{v_arr.dtype} not one "
                        f"of {list(_KV_DTYPES)}")
    if quantized != (k_arr.dtype == torch.int8):
        raise TypeError("an int8 pool needs its scales, and only it")
    if tuple(v_arr.shape) != (NB, bs, kvH, hd) or k_arr.shape[3] != hd:
        raise ValueError(f"pool shapes {tuple(k_arr.shape)}/"
                         f"{tuple(v_arr.shape)} do not match q {tuple(q.shape)}")
    if quantized:
        for sc in (k_scale, v_scale):
            if tuple(sc.shape) != (NB, bs, kvH, 1) or sc.dtype != torch.float32:
                raise ValueError(f"int8 scales must be fp32 [NB, bs, kvH, 1], "
                                 f"got {sc.dtype} {tuple(sc.shape)}")
    if tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("tables and ctx_lens must be int32")
    if tuple(tables.shape) != (S, MB) or tuple(ctx_lens.shape) != (S,):
        raise ValueError(f"tables {tuple(tables.shape)} / ctx "
                         f"{tuple(ctx_lens.shape)} do not match {S} slots")
    operands = [q, k_arr, v_arr, tables, ctx_lens]
    if quantized:
        operands += [k_scale, v_scale]
    for t in operands:
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention needs contiguous operands")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not one of {_HEAD_DIMS}")
    if (k_arr.data_ptr() | v_arr.data_ptr()) % 16:
        raise ValueError("the kernel reads pool rows 16 bytes at a time: "
                         "pools must be 16-byte aligned")
    lib = _library()
    kv_dtype = _KV_DTYPES[k_arr.dtype]
    if splits is None:
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        groups = _launch_sizes(kv_dtype, S, kvH, G, hd, MB, 1)[2]
        splits = split_count(groups, MB, bs, n_sm)
    smem, n_partial, n_counters = _launch_sizes(kv_dtype, S, kvH, G, hd, MB,
                                                splits)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"G={G}, hd={hd}, {MB} blocks a table need {smem} "
                         f"bytes of shared memory, over the "
                         f"{_MAX_SMEM_BYTES} a block has")
    out = torch.empty_like(q)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(n_partial, dtype=torch.float32, device=q.device)
        counters = _counter_buffer(q.device, n_counters)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tadnn_paged_attention_decode(
            q.data_ptr(), k_arr.data_ptr(), v_arr.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _Q_DTYPES[q.dtype], kv_dtype, S, NB, kvH, G, hd, bs, MB,
            window or 0, splits, 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(
            f"paged_attention kernel launch failed: "
            f"{lib.tadnn_cuda_error_string(err).decode()} (cudaError {err})")
    paged_attention.launches += 1
    return out


def paged_attention_reference(q: torch.Tensor, k_pool, v_pool,
                              tables: torch.Tensor, ctx_lens: torch.Tensor,
                              *, window: int | None = None,
                              dtype=None) -> torch.Tensor:
    """The plain version: the dense decode path, verbatim.

    Gathers the block table into the dense view with
    ``kv_pool.gather_blocks`` and runs ``xla_attention`` under the same
    ctx/window mask the engine builds, so kernel-vs-reference parity IS
    paged-vs-dense parity."""
    from ..inference.serve.kv_pool import gather_blocks

    if dtype is None:
        dtype = q.dtype
    kd = gather_blocks(k_pool, tables, dtype)
    vd = gather_blocks(v_pool, tables, dtype)
    key_idx = torch.arange(kd.shape[1], device=q.device)[None, :]
    ctx = ctx_lens.to(torch.int64)[:, None]
    mask = key_idx <= ctx
    if window is not None:
        mask &= key_idx > ctx - window
    o = xla_attention(q[:, None], kd, vd, causal=False,
                      mask=mask[:, None, None, :])
    return o[:, 0]


# -- a plain model of the kernel's split-and-merge ------------------------------


def split_chunks(ctx: int, window: int | None, bs: int, MB: int,
                 n_split: int):
    """The kernel's partition of one slot's keys: ``(lo, chunks)``, keys
    ``lo .. ctx`` attended, and split ``c`` taking table pages
    ``chunks[c] = (pb, pe)`` (empty when ``pe <= pb``): the pages from the
    first one a window reaches to the one holding ``ctx``, in
    ``ceil(pages / n_split)``-page chunks."""
    lo = max(0, ctx - window + 1) if window else 0
    p_lo = lo // bs
    p_end = p_lo if ctx < 0 else min(ctx // bs + 1, MB)
    n_pages = max(p_end - p_lo, 0)
    per = -(-n_pages // n_split)
    return lo, [(p_lo + c * per, min(p_lo + (c + 1) * per, p_lo + n_pages))
                for c in range(n_split)]


def _merge(state, part):
    """Online-softmax merge of two (m, l, acc) states; an empty one (m =
    -0.7 FLT_MAX, l = 0, acc = 0) leaves the other as it is."""
    (m, l, acc), (m_o, l_o, acc_o) = state, part
    m_new = torch.maximum(m, m_o)
    a, b = torch.exp(m - m_new), torch.exp(m_o - m_new)
    return m_new, l * a + l_o * b, acc * a[..., None] + acc_o * b[..., None]


def paged_attention_split_reference(q, k_pool, v_pool, tables, ctx_lens, *,
                                    window=None, n_split):
    """A plain model of K4's arithmetic with ``n_split`` blocks a slot:
    each split's pages give a partial (m, l, acc) in fp32, the running
    max clamped at half the mask value and a split with no attended key
    empty (m = -0.7 FLT_MAX, l = 0, acc = 0); the partials merge in split
    order and the output is acc / max(l, 1e-30), so a slot with no
    attended key gives zeros.  [S, Hq, hd] in q's type."""
    k_arr, k_scale = kv_leaf_parts(k_pool)
    v_arr, v_scale = kv_leaf_parts(v_pool)
    k, v = k_arr.float(), v_arr.float()
    if k_scale is not None:
        k, v = k * k_scale, v * v_scale
    S, Hq, hd = q.shape
    _, bs, kvH, _ = k.shape
    MB = tables.shape[1]
    G = Hq // kvH
    scale = 1.0 / math.sqrt(hd)
    neg = torch.tensor(_NEG_BIG)
    out = torch.zeros(S, kvH, G, hd)
    for s in range(S):
        ctx = int(ctx_lens[s])
        lo, chunks = split_chunks(ctx, window, bs, MB, n_split)
        qs = q[s].float().reshape(kvH, G, hd)
        state = (neg.expand(kvH, G), torch.zeros(kvH, G),
                 torch.zeros(kvH, G, hd))
        for pb, pe in chunks:
            part = (neg.expand(kvH, G), torch.zeros(kvH, G),
                    torch.zeros(kvH, G, hd))
            if pe > pb:
                pages = tables[s, pb:pe].long()
                kc = k[pages].reshape(-1, kvH, hd)
                vc = v[pages].reshape(-1, kvH, hd)
                pos = torch.arange(pb * bs, pe * bs)
                valid = (pos >= lo) & (pos <= ctx)
                sc = torch.einsum("hgd,thd->hgt", qs, kc) * scale
                sc = torch.where(valid, sc, neg)
                if bool(valid.any()):
                    m = torch.clamp(sc.amax(-1), min=_NEG_BIG / 2)
                    p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
                    part = (m, p.sum(-1), torch.einsum("hgt,thd->hgd", p, vc))
            state = _merge(state, part)
        _, l, acc = state
        out[s] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(S, Hq, hd).to(q.dtype)
