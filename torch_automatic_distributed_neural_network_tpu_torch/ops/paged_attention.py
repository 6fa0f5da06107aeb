"""Paged decode attention: block tables read in-kernel.

The serving decode step attends one query token per slot against the
slot's cached keys, which live in a block-paged pool.  The kernel
(``csrc/paged_attention.cu``, CUDA C++ for Hopper) reads each slot's
block table itself and gathers the pages it needs, so the dense
``[S, max_len, kvH, hd]`` view of the pool is never materialized, and
int8 pages are dequantized as they are loaded.  It replaces the JAX
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
raises.
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
_MAX_SMEM_BYTES = 232448  # what one Hopper thread block may use


_lib = None


def _library():
    """The built kernel library, its C signatures declared once."""
    global _lib
    if _lib is None:
        lib = load("paged_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tadnn_paged_attention_decode.argtypes = (
            [ptr] * 8 + [i32] * 9 + [ctypes.c_float, ptr])
        lib.tadnn_paged_attention_decode.restype = i32
        lib.tadnn_paged_attention_smem_bytes.argtypes = [i32, i32]
        lib.tadnn_paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.tadnn_cuda_error_string.argtypes = [i32]
        lib.tadnn_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def _paged_attention_cuda(q, k_pool, v_pool, tables, ctx_lens, *, window):
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
    if hd not in (32, 64, 128):
        raise ValueError(f"head_dim {hd} not one of 32, 64, 128")
    if (k_arr.data_ptr() | v_arr.data_ptr()) % 16:
        raise ValueError("the kernel reads pool rows 16 bytes at a time: "
                         "pools must be 16-byte aligned")
    lib = _library()
    smem = lib.tadnn_paged_attention_smem_bytes(G, hd)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"G={G}, hd={hd} needs {smem} bytes of shared "
                         f"memory, over the {_MAX_SMEM_BYTES} a block has")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tadnn_paged_attention_decode(
            q.data_ptr(), k_arr.data_ptr(), v_arr.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_arr.dtype],
            S, kvH, G, hd, bs, MB, window or 0, 1.0 / math.sqrt(hd), stream)
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
