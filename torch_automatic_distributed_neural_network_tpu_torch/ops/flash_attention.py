"""Flash attention: forward (K1) and backward (K2: dK/dV, K3: dQ) kernels.

Block-streaming attention that never materializes the [S, S] score
matrix in either direction: an online softmax over key tiles in the
forward, and in the backward a recompute of ``p = exp(s - lse)`` from the
saved per-row logsumexp.  The kernels, CUDA C++ for Hopper, replace the
JAX package's Pallas kernels ``ops/flash_attention.py::_fwd_kernel``,
``::_dkv_kernel`` and ``::_dq_kernel``: bf16 K1-K3 run on the tensor
cores (``csrc/flash_attention_sm90.cu``: TMA loads, ``wgmma``), fp32
K1-K3 on the CUDA cores (``csrc/flash_attention.cu``: TF32 would break
their 1e-4 bound).  Two ``torch.autograd.Function``\\ s take the place
of its ``_flash_core`` / ``_flash_core_stats`` ``custom_vjp``\\ s.

Layout is BSHD ``[batch, seq, heads, head_dim]``; the kernels read it in
place (no fold to ``[B*H, S, D]``) and keep the row statistics ``lse``
and ``delta`` as ``[B, H, S]`` fp32.  K/V with fewer heads (GQA) are
repeated to the query heads before the kernels, and autograd sums their
gradients back.

Beside the kernels, in this module, are their plain versions:
:func:`flash_forward_reference`, :func:`flash_dkv_reference` and
:func:`flash_dq_reference` (both at once: :func:`flash_backward_reference`),
dense PyTorch with the same rounding points (fp32 scores masked to
``-0.7 * FLT_MAX``, the running max clamped at half that, ``l >= 1e-30``,
``p`` cast to v's type before ``p . v``, ``ds`` cast to q's / k's type
before ``ds^T . q`` / ``ds . k``).  The wrappers :func:`flash_forward`,
:func:`flash_dkv` and :func:`flash_dq` run the plain version only for a
tensor on the CPU; on a CUDA tensor they launch the kernel (and count
the launch on the wrapper) or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils.device import is_dtensor
from .attention import _check_window
from .build import load

_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)
_TILE = 64  # the smallest tile of any kernel: bounds the grid's rows

_libs = None


class _Libraries(NamedTuple):
    simt: ctypes.CDLL  # csrc/flash_attention.cu: fp32 K1-K3
    sm90: ctypes.CDLL  # csrc/flash_attention_sm90.cu: bf16 K1-K3


def _library() -> _Libraries:
    """The two built kernel libraries, their C signatures declared once."""
    global _libs
    if _libs is None:
        lib, lib90 = load("flash_attention"), load("flash_attention_sm90")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # each kernel's pointers, then (B, H, Sq, Sk, hd, causal, window),
        # scale and the stream, in both libraries
        for name, n_ptrs in (("forward", 5), ("dkv", 8), ("dq", 7)):
            for fn in (getattr(lib, f"tadnn_flash_{name}"),
                       getattr(lib90, f"tadnn_flash_{name}_sm90")):
                fn.argtypes = [ptr] * n_ptrs + [i32] * 7 + [f32, ptr]
                fn.restype = i32
        lib90.tadnn_flash_sm90_tile_check.argtypes = (
            [ptr] * 5 + [i32] * 7 + [ptr])
        lib90.tadnn_flash_sm90_tile_check.restype = i32
        lib.tadnn_flash_error_string.argtypes = [i32]
        lib.tadnn_flash_error_string.restype = ctypes.c_char_p
        _libs = _Libraries(lib, lib90)
    return _libs


# -- the plain versions -------------------------------------------------------


def _scale_of(q, scale):
    """The score scale: ``1 / sqrt(head_dim)`` unless given (a padded
    head dim keeps its own, see :func:`_prep_bshd`)."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _masked_scores(q, k, causal, window, scale=None):
    """fp32 scores [B, H, Sq, Sk], ``-0.7 * FLT_MAX`` where the pair may
    not attend (``_pair_mask``: causality and the window band)."""
    sq, sk = q.shape[1], k.shape[1]
    scale = _scale_of(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if not causal:
        return s
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    return torch.where(mask, s, _NEG_BIG)


def flash_forward_reference(q, k, v, causal=False, window=None,
                            scale=None):
    """The plain version of K1: ``(o, lse)`` for BSHD q, k, v (equal head
    counts), o in q's type, lse [B, H, Sq] fp32."""
    s = _masked_scores(q, k, causal, window, scale)
    m = torch.clamp(s.amax(-1, keepdim=True), min=_NEG_BIG / 2)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (pv / l_safe.transpose(1, 2)).to(q.dtype)
    return o, (m + torch.log(l_safe))[..., 0]


def _delta(o, do, dlse=None):
    """rowsum(do * o) as [B, H, S] fp32, minus the lse cotangent when
    there is one (``_bwd_stats`` folds it into delta)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return delta if dlse is None else delta - dlse


def _backward_terms(q, k, v, do, lse, delta, causal, window, scale=None):
    """``p = exp(s - lse)`` and ``ds = p * (dp - delta) * scale`` with
    ``dp = do . v^T`` in fp32, both [B, H, Sq, Sk]."""
    scale = _scale_of(q, scale)
    p = torch.exp(_masked_scores(q, k, causal, window, scale)
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _dkv_from_terms(q, k, v, do, p, ds):
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq_from_terms(q, k, ds):
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                        k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal=False, window=None,
                        scale=None):
    """The plain version of K2: ``(dk, dv)`` in k's and v's type."""
    p, ds = _backward_terms(q, k, v, do, lse, delta, causal, window, scale)
    return _dkv_from_terms(q, k, v, do, p, ds)


def flash_dq_reference(q, k, v, do, lse, delta, causal=False, window=None,
                       scale=None):
    """The plain version of K3: dq in q's type."""
    _, ds = _backward_terms(q, k, v, do, lse, delta, causal, window, scale)
    return _dq_from_terms(q, k, ds)


def flash_backward_reference(q, k, v, o, lse, do, delta=None, causal=False,
                             window=None, scale=None):
    """The plain version of K2 and K3: ``(dq, dk, dv)``.  ``delta`` is
    rowsum(do * o) [B, H, Sq] (computed from ``o`` when None)."""
    if delta is None:
        delta = _delta(o, do)
    p, ds = _backward_terms(q, k, v, do, lse, delta, causal, window, scale)
    dk, dv = _dkv_from_terms(q, k, v, do, p, ds)
    return _dq_from_terms(q, k, ds), dk, dv


# -- the kernel wrappers -------------------------------------------------------


def _check_operands(q, k, v, *rest, stats=(), causal, window):
    """Raise on what the kernels do not take; returns (B, H, Sq, Sk, hd)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes {list(_DTYPES)}, got {q.dtype}")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    for t in (k, v, *rest):
        if t.dtype != q.dtype:
            raise TypeError(f"operand dtype {t.dtype} differs from q's "
                            f"{q.dtype}")
    if tuple(k.shape) != (B, Sk, H, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (repeat GQA heads first)")
    for t in rest:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"do {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq):
            raise ValueError(f"lse / delta must be fp32 [B, H, Sq] = "
                             f"{(B, H, Sq)}, got {t.dtype} {tuple(t.shape)}")
    for t in (q, k, v, *rest, *stats):
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention needs contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("the kernels read rows 16 bytes at a time: "
                             "operands must be 16-byte aligned")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not one of {_HEAD_DIMS}")
    if min(B, H, Sq, Sk) < 1:
        raise ValueError(f"empty attention {tuple(q.shape)} x {Sk} keys")
    if causal and Sq != Sk:
        raise NotImplementedError(
            "causal flash attention requires seq_q == seq_k")
    if max(Sq, Sk) > 65535 * _TILE:
        raise ValueError(f"sequence {max(Sq, Sk)} over the grid's "
                         f"{65535 * _TILE} rows")
    _check_window(window, causal)
    return B, H, Sq, Sk, hd


def _raise_on(err, name):
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_library().simt.tadnn_flash_error_string(err).decode()} "
            f"(cudaError {err})")


def _kernel(q, name):
    """The C entry point of kernel ``name`` for q's type: bf16 on the
    tensor cores, fp32 on the CUDA cores."""
    if q.dtype == torch.bfloat16:
        return getattr(_library().sm90, f"tadnn_flash_{name}_sm90")
    return getattr(_library().simt, f"tadnn_flash_{name}")


def _device_kind(q, name, *rest):
    """``cpu`` (the plain version) or ``cuda`` (the kernel).  The kernels
    take raw pointers, so a ``DTensor`` (a sharded plan's global view)
    is refused, never launched on its local shape or sent to the plain
    version: a plan hands them local tensors."""
    if any(is_dtensor(t) for t in (q, *rest)):
        raise TypeError(f"{name}: got a DTensor; the flash kernels take "
                        f"the local tensors of a sharded plan")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


def flash_forward(q, k, v, *, causal=False, window=None, scale=None):
    """K1: ``(o, lse)`` of BSHD q, k, v with equal head counts; o in q's
    type, lse [B, H, Sq] fp32.  ``scale`` (default ``1 / sqrt(hd)``)
    multiplies the scores.  The plain version on the CPU; on a CUDA
    tensor the kernel (counted in ``flash_forward.launches``)."""
    if _device_kind(q, "flash_forward", k, v) == "cpu":
        return flash_forward_reference(q, k, v, causal, window, scale)
    B, H, Sq, Sk, hd = _check_operands(q, k, v, causal=causal, window=window)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    shape = (B, H, Sq, Sk, hd, int(causal), window or 0,
             _scale_of(q, scale))
    with torch.cuda.device(q.device):
        err = _kernel(q, "forward")(*ptrs, *shape, stream)
    _raise_on(err, "flash_forward")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_dkv(q, k, v, do, lse, delta, *, causal=False, window=None,
              scale=None):
    """K2: ``(dk, dv)`` in k's and v's type.  The plain version on the
    CPU; on a CUDA tensor the kernel (``flash_dkv.launches``)."""
    if _device_kind(q, "flash_dkv", k, v, do) == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, window,
                                   scale)
    B, H, Sq, Sk, hd = _check_operands(q, k, v, do, stats=(lse, delta),
                                       causal=causal, window=window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (B, H, Sq, Sk, hd, int(causal), window or 0,
             _scale_of(q, scale))
    with torch.cuda.device(q.device):
        err = _kernel(q, "dkv")(*ptrs, *shape, stream)
    _raise_on(err, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


def flash_dq(q, k, v, do, lse, delta, *, causal=False, window=None,
             scale=None):
    """K3: dq in q's type.  The plain version on the CPU; on a CUDA
    tensor the kernel (``flash_dq.launches``)."""
    if _device_kind(q, "flash_dq", k, v, do) == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal, window,
                                  scale)
    B, H, Sq, Sk, hd = _check_operands(q, k, v, do, stats=(lse, delta),
                                       causal=causal, window=window)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    shape = (B, H, Sq, Sk, hd, int(causal), window or 0,
             _scale_of(q, scale))
    with torch.cuda.device(q.device):
        err = _kernel(q, "dq")(*ptrs, *shape, stream)
    _raise_on(err, "flash_dq")
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def sm90_tile_check(q, k, v, *, s0=0, h=0, b=0):
    """One 64-row tile through the bf16 kernels' loads, descriptors and
    fragment maps, on the card: ``(s, o)`` with ``s = q_t . k_t^T`` fp32
    [64, 64] and ``o = bf16(s) . v_t`` fp32 [64, hd], where ``x_t`` is
    rows ``s0 .. s0 + 63`` of head ``h``, batch ``b`` of a BSHD bf16
    tensor (rows past the end read as zeros).  A diagnostic: held against
    ``torch.matmul``, a fault in the swizzle, the descriptors or the
    register layouts shows as a wrong product."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("sm90_tile_check takes bf16 CUDA tensors")
    B, S, H, hd = q.shape
    _check_operands(q, k, v, causal=False, window=None)
    s = torch.empty(64, 64, dtype=torch.float32, device=q.device)
    o = torch.empty(64, hd, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _library().sm90.tadnn_flash_sm90_tile_check(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), B, S, H, hd, s0, h, b, stream)
    _raise_on(err, "sm90_tile_check")
    return s, o


# -- autograd ------------------------------------------------------------------


def _backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = _delta(o, do, dlse)
    kw = dict(causal=ctx.causal, window=ctx.window, scale=ctx.scale)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
    return flash_dq(q, k, v, do, lse, delta, **kw), dk, dv


def _save(ctx, q, k, v, o, lse, causal, window, scale):
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.window, ctx.scale = causal, window, scale


class _FlashCore(torch.autograd.Function):
    """o = attention(q, k, v); the backward runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_forward(q, k, v, causal=causal, window=window,
                               scale=scale)
        _save(ctx, q, k, v, o, lse, causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        return (*_backward(ctx, do, None), None, None, None)


class _FlashCoreStats(torch.autograd.Function):
    """(o, lse); the lse cotangent folds into delta:
    dL/ds = p * (dp - delta) + p * dlse = p * (dp - (delta - dlse))."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_forward(q, k, v, causal=causal, window=window,
                               scale=scale)
        _save(ctx, q, k, v, o, lse, causal, window, scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_backward(ctx, do, dlse.float()), None, None, None)


# -- the public BSHD entry points ------------------------------------------------


def kernel_head_dim(hd: int) -> int:
    """The kernels' head dim that holds ``hd``: the smallest of
    ``_HEAD_DIMS`` not below it."""
    for d in _HEAD_DIMS:
        if hd <= d:
            return d
    raise ValueError(f"head_dim {hd} over the kernels' largest, "
                     f"{_HEAD_DIMS[-1]}")


def _prep_bshd(q, k, v, causal, window):
    """GQA broadcast, the causal shape rule, contiguous operands, and a
    head dim the kernels have no instance for zero-padded to the next
    one: the padded lanes add 0 to every score and give 0 in o, dq, dk
    and dv, and the scores keep the scale of the head dim they came
    with.  Returns ``(q, k, v, hd, scale)``, ``hd`` the head dim before
    padding."""
    _check_window(window, causal)
    _device_kind(q, "flash_attention", k, v)
    hq, hk = q.shape[2], k.shape[2]
    if hk != hq:
        if hq % hk:
            raise ValueError(f"{hq} query heads not a multiple of {hk}")
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    if causal and q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "causal flash attention requires seq_q == seq_k")
    hd = q.shape[-1]
    pad = kernel_head_dim(hd) - hd
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    return (q.contiguous(), k.contiguous(), v.contiguous(), hd,
            1.0 / math.sqrt(hd))


def flash_attention(q, k, v, *, causal=False, window=None):
    """Flash attention over BSHD tensors [batch, seq, heads, head_dim].

    Matches the ``xla_attention`` arithmetic up to the order of fp32 sums
    (scores are fp32 here before any rounding), never materializing the
    [S, S] scores.  K/V may have fewer heads (GQA).  ``window`` (requires
    ``causal=True``): position q attends keys in ``(q - window, q]``;
    tiles outside the band are skipped in the forward and both backward
    kernels.  Any head dim up to 128 (:func:`_prep_bshd`)."""
    q, k, v, hd, scale = _prep_bshd(q, k, v, causal, window)
    return _FlashCore.apply(q, k, v, causal, window, scale)[..., :hd]


def flash_attention_with_lse(q, k, v, *, causal=False):
    """``(o, lse)``: o BSHD, lse [batch, heads, seq] fp32, the logsumexp
    of each row's scores, which makes per-block results mergeable (ring
    attention).  Gradients flow through both outputs."""
    q, k, v, hd, scale = _prep_bshd(q, k, v, causal, None)
    o, lse = _FlashCoreStats.apply(q, k, v, causal, None, scale)
    return o[..., :hd], lse
