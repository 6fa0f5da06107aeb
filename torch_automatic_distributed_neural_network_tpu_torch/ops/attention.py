"""Reference attention: plain einsum attention on [B, S, H, D] tensors.

The ``xla`` implementation of the JAX package's ``ops/attention.py``,
with its numerics kept exactly, because the dense decode path, prefill
and the paged-attention kernel's plain version all run it:

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

import torch


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


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: int | None = None,
                  mask: torch.Tensor | None = None,
                  softmax_dtype=torch.float32) -> torch.Tensor:
    """Reference einsum attention.  q, k, v: [B, S, H, D] (k, v may have
    fewer heads for GQA).  ``mask``: [B, 1|H, Q|1, K] boolean, True =
    attend."""
    _check_window(window, causal)
    _, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if hk != hq:
        if hq % hk:
            raise ValueError(f"{hq} query heads not a multiple of {hk}")
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    scale = 1.0 / math.sqrt(d)
    qk_dtype = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(qk_dtype),
                          k.to(qk_dtype)).to(softmax_dtype) * scale
    if causal:
        ones = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        causal_mask = torch.tril(ones, diagonal=sk - sq)
        if window is not None:
            # sliding band: q attends keys in (q - window, q]
            causal_mask &= torch.triu(ones, diagonal=sk - sq - window + 1)
        scores = scores + _mask_bias(scores.dtype, causal_mask[None, None])
    if mask is not None:
        scores = scores + _mask_bias(scores.dtype, mask)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if v.dtype in (torch.bfloat16, torch.float16):
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        return out.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
