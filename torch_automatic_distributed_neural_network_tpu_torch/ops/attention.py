"""Attention with a single dispatch surface, on [B, S, H, D] tensors.

Implementations, as in the JAX package's ``ops/attention.py``:

- ``xla``: plain einsum attention, the reference every other path and
  the dense decode path are held against;
- ``chunked``: the same arithmetic over query blocks, each block
  recomputed in the backward (``torch.utils.checkpoint``), so the score
  memory is O(block_q * S) instead of O(S^2);
- ``flash``: the hand-written CUDA kernels (``ops/flash_attention.py``);
- ``ring`` / ``ulysses``: context parallelism, which needs a sequence
  axis; without one (this port has no parallel context yet) they are
  plain attention, as the JAX package's degenerate case is.

The ``xla`` numerics are kept exactly:

- masks are an additive bias of ``finfo(fp32).min * 0.5``, not -inf, so
  a row with no admitted key stays finite;
- GQA repeats each kv head over its query group (kv-major: query head
  ``i`` reads kv head ``i // G``);
- scores and softmax are fp32, and the probabilities are cast to
  ``v``'s type before the PV product.  A half-precision product is
  accumulated in fp32 and rounded once, as XLA does.
"""

from __future__ import annotations

import math
from typing import Literal

import torch
from torch.utils.checkpoint import checkpoint

Impl = Literal["xla", "chunked", "flash", "ring", "ulysses", "auto"]

# auto-dispatch floor for the chunked path: below this the full S^2 score
# tensor is small enough that the plain einsum is the better choice
CHUNKED_MIN_SEQ = 1024
# auto-dispatch floor for the flash kernels (see _flash_ok)
FLASH_MIN_SEQ = 512


def _check_window(window, causal):
    """A window only makes sense as a causal band, and window < 1 would
    mask every key (with the finite mask bias that is a uniform softmax
    over all positions, an acausality leak), so reject it up front."""
    if window is None:
        return
    if not causal:
        raise ValueError("window= requires causal=True (the sliding "
                         "window is a causal band)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _mask_bias(scores_dtype, mask: torch.Tensor) -> torch.Tensor:
    big_neg = torch.finfo(scores_dtype).min * 0.5
    return torch.where(mask, 0.0, big_neg).to(scores_dtype)


def _repeat_kv(q, k, v):
    hq, hk = q.shape[2], k.shape[2]
    if hk != hq:
        if hq % hk:
            raise ValueError(f"{hq} query heads not a multiple of {hk}")
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    return k, v


def _scores(q, k, softmax_dtype):
    """[B, H, Q, K] scores in ``softmax_dtype``, scaled by 1/sqrt(D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qk_dtype = torch.promote_types(q.dtype, k.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", q.to(qk_dtype),
                        k.to(qk_dtype)).to(softmax_dtype) * scale


def _probs_v(scores, v):
    """softmax(scores) . v, probabilities cast to v's type first."""
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if v.dtype in (torch.bfloat16, torch.float16):
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        return out.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: int | None = None,
                  mask: torch.Tensor | None = None,
                  softmax_dtype=torch.float32) -> torch.Tensor:
    """Reference einsum attention.  q, k, v: [B, S, H, D] (k, v may have
    fewer heads for GQA).  ``mask``: [B, 1|H, Q|1, K] boolean, True =
    attend."""
    _check_window(window, causal)
    sq, sk = q.shape[1], k.shape[1]
    k, v = _repeat_kv(q, k, v)
    scores = _scores(q, k, softmax_dtype)
    if causal:
        ones = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        causal_mask = torch.tril(ones, diagonal=sk - sq)
        if window is not None:
            # sliding band: q attends keys in (q - window, q]
            causal_mask &= torch.triu(ones, diagonal=sk - sq - window + 1)
        scores = scores + _mask_bias(scores.dtype, causal_mask[None, None])
    if mask is not None:
        scores = scores + _mask_bias(scores.dtype, mask)
    return _probs_v(scores, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, window: int | None = None,
                      mask: torch.Tensor | None = None, block_q: int = 256,
                      softmax_dtype=torch.float32) -> torch.Tensor:
    """Memory-efficient einsum attention over query blocks.

    The :func:`xla_attention` arithmetic (same fp32 softmax, GQA
    broadcast and mask conventions), but only a [B, H, block_q, S] score
    block exists at a time, and each block is recomputed in the backward
    (``torch.utils.checkpoint``) instead of kept.  Takes explicit masks,
    which the flash kernels do not."""
    _check_window(window, causal)
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(q, k, v)
    block_q = min(block_q, sq)
    n_blocks = -(-sq // block_q)
    pad = n_blocks * block_q - sq
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        if mask is not None and mask.shape[2] > 1:
            # keep mask rows aligned with padded q rows (a fully-False row
            # gives a uniform softmax through the finite mask bias; the
            # row's output is sliced off below)
            mask = torch.nn.functional.pad(mask, (0, 0, 0, pad))
    k_pos = torch.arange(sk, device=q.device)

    def block(q_i, start):
        scores = _scores(q_i, k, softmax_dtype)
        if causal:
            # global q position p attends key positions <= p + (sk - sq)
            q_pos = start + torch.arange(block_q, device=q.device)
            allow = k_pos[None, :] <= q_pos[:, None] + (sk - sq)
            if window is not None:
                allow &= k_pos[None, :] > q_pos[:, None] + (sk - sq) - window
            scores = scores + _mask_bias(scores.dtype, allow[None, None])
        if mask is not None:
            m = mask
            if m.shape[2] > 1:  # [B, 1|H, Q, K]: this block's rows
                m = m[:, :, start:start + block_q]
            scores = scores + _mask_bias(scores.dtype, m)
        return _probs_v(scores, v)

    outs = []
    for i in range(n_blocks):
        q_i = q[:, i * block_q:(i + 1) * block_q]
        if torch.is_grad_enabled():
            outs.append(checkpoint(block, q_i, i * block_q,
                                   use_reentrant=False))
        else:
            outs.append(block(q_i, i * block_q))
    return torch.cat(outs, dim=1)[:, :sq]


def _flash_ok(q: torch.Tensor, k: torch.Tensor, mask) -> bool:
    """Auto-dispatch gate for the flash kernels: no explicit mask, a
    self-attention sequence of at least ``FLASH_MIN_SEQ``, and tensors on
    a CUDA device.  The 512 floor is the JAX package's, set on a TPU
    (v5e) by that kernel's block size; ``chip_smoke.py`` times flash
    against ``xla`` from 128 to 1024 on the H100 (PERF.md), and moving
    the floor is later work."""
    return (mask is None and q.shape[1] == k.shape[1]
            and q.shape[1] >= FLASH_MIN_SEQ and q.is_cuda)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, window: int | None = None,
              mask: torch.Tensor | None = None,
              impl: Impl = "auto") -> torch.Tensor:
    """Dispatching attention entry point used by the models.

    ``impl="auto"`` takes flash where :func:`_flash_ok` holds (decided
    by the shape and the device alone: a kernel that fails to build or
    launch raises), ``chunked`` for other self-attention of at least
    ``CHUNKED_MIN_SEQ``, else ``xla``.  ``ring`` / ``ulysses`` need a
    sequence-parallel axis, which this port does not have yet (ROADMAP
    Queue 1 item 5): with none they are plain attention, as in the JAX
    package."""
    _check_window(window, causal)
    if impl == "auto":
        if _flash_ok(q, k, mask):
            impl = "flash"
        elif q.shape[1] >= CHUNKED_MIN_SEQ and q.shape[1] == k.shape[1]:
            impl = "chunked"
        else:
            impl = "xla"
    if impl in ("xla", "ring", "ulysses"):
        return xla_attention(q, k, v, causal=causal, window=window,
                             mask=mask)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 mask=mask)
    if impl == "flash":
        from .flash_attention import flash_attention

        if mask is not None:
            raise NotImplementedError(
                "flash attention does not take explicit masks (causal only)")
        return flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"Unknown attention impl {impl!r}")
