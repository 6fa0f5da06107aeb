"""Ring attention over the ``seq`` axis: the JAX package's
``parallel/ring.py``.

Each rank of the ``seq`` group holds one sequence block of Q and one of
K/V.  The K/V blocks rotate around the group (``collectives.ring_step``)
while every rank folds each visiting block into its accumulator: the
flash forward kernel (K1, ``ops.flash_attention.flash_forward``) gives
each block's output and row logsumexp, and the blocks merge by their
logsumexp weights in fp32, so the [S, S] scores never exist.

Causal block dispatch, by the block's origin on the ring:

- the rank's own block: the causal kernel;
- a block from an earlier rank: the unmasked kernel;
- a block from a later rank: skipped (zero weight: lse
  ``-0.7 * FLT_MAX``), no kernel launched.

K and V rotate at their own head count under GQA and are repeated to
the query heads per block (a head dim the kernels lack is zero-padded,
as ``flash_attention._prep_bshd`` does).

The backward is written out rather than left to autograd, so that every
rank of the group runs the same rotations in the same order (a skipped
block would otherwise leave its rotation's backward unrun on one rank
and hang the others).  Differentiating the merge gives each block's
gradient as the flash backward of that block against the *final* row
statistics: ``p = exp(s - lse)`` with the merged lse, and
``delta = rowsum(do * o)`` with the merged o (the lse cotangent of
JAX's per-block ``_flash_core_stats`` folded into delta).  So each
visited block runs K2 (dK, dV) and K3 (dQ) once; its dK/dV travel with
it around the ring and one more step takes them home.  JAX's last
forward rotation, which only restores the placement, is skipped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.flash_attention import (
    flash_dkv,
    flash_dq,
    flash_forward,
    kernel_head_dim,
)
from .collectives import ring_step

_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def _merge_norm(o, lse, o2, lse2):
    """Two normalized partial attentions merged by logsumexp weight.
    o, o2: [B, S, H, D] fp32; lse, lse2: [B, H, S] fp32."""
    lse_new = torch.logaddexp(lse, lse2)
    w = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - lse_new).transpose(1, 2)[..., None]
    return o * w + o2 * w2, lse_new


def _block(t: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """A K or V block as the kernels take it: repeated to ``heads``
    (kv-major, as ``_repeat_kv``) and zero-padded to ``width``."""
    if t.shape[2] != heads:
        t = t.repeat_interleave(heads // t.shape[2], dim=2)
    return F.pad(t, (0, width - t.shape[-1])).contiguous()


def _modes(cp: int, my: int, causal: bool) -> list[str | None]:
    """Per ring step, how the visiting block is attended: 'diag'
    (causal), 'full', or None (skipped)."""
    out = []
    for step in range(cp):
        origin = (my - step) % cp
        out.append("full" if not causal or origin < my
                   else "diag" if origin == my else None)
    return out


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, group):
        cp, my = group.size(), torch.distributed.get_rank(group)
        b, sl, hq, dh = q.shape
        width = kernel_head_dim(dh)
        scale = 1.0 / math.sqrt(dh)
        qp = F.pad(q, (0, width - dh)).contiguous()
        o = torch.zeros((b, sl, hq, width), dtype=torch.float32,
                        device=q.device)
        lse = torch.full((b, hq, sl), _NEG_BIG, dtype=torch.float32,
                         device=q.device)
        kb, vb = k, v
        modes = _modes(cp, my, causal)
        for step, mode in enumerate(modes):
            if mode is not None:
                o2, lse2 = flash_forward(
                    qp, _block(kb, hq, width), _block(vb, hq, width),
                    causal=mode == "diag", scale=scale)
                o, lse = _merge_norm(o, lse, o2.float(), lse2)
            if step < cp - 1:
                kb, vb = ring_step(kb, group), ring_step(vb, group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.modes, ctx.scale = group, modes, scale
        return o[..., :dh].to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, modes = ctx.group, ctx.modes
        cp = len(modes)
        b, sl, hq, dh = q.shape
        width = o.shape[-1]
        qp = F.pad(q, (0, width - dh)).contiguous()
        dop = F.pad(do, (0, width - dh)).to(q.dtype).contiguous()
        delta = (dop.float() * o).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros_like(o)
        kb, vb = k, v
        # the visiting block's dK / dV, travelling with it in k's and v's
        # type (each rank adds its part in fp32)
        dkb, dvb = torch.zeros_like(k), torch.zeros_like(v)
        hk = k.shape[2]
        for step, mode in enumerate(modes):
            if mode is not None:
                kp, vp = _block(kb, hq, width), _block(vb, hq, width)
                kw = dict(causal=mode == "diag", scale=ctx.scale)
                dk, dv = flash_dkv(qp, kp, vp, dop, lse, delta, **kw)
                dq = dq + flash_dq(qp, kp, vp, dop, lse, delta, **kw).float()
                # back to the kv heads: sum each query group
                dkb = (dkb.float() + dk[..., :dh].float().reshape(
                    b, sl, hk, hq // hk, dh).sum(3)).to(k.dtype)
                dvb = (dvb.float() + dv[..., :dh].float().reshape(
                    b, sl, hk, hq // hk, dh).sum(3)).to(v.dtype)
            if step < cp - 1:
                kb, vb = ring_step(kb, group), ring_step(vb, group)
            # the last step takes each block's gradient home
            dkb, dvb = ring_step(dkb, group), ring_step(dvb, group)
        return dq[..., :dh].to(q.dtype), dkb, dvb, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, group) -> torch.Tensor:
    """Block-ring attention over ``group`` (the ``seq`` axis's): q
    [B, S_local, H, D], k and v [B, S_local, Hkv, D], this rank's blocks
    of the sequence in rank order; returns this rank's output block."""
    return _RingAttention.apply(q, k, v, causal, group)
