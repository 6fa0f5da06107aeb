"""Ulysses sequence parallelism over the ``seq`` axis: the JAX package's
``parallel/ulysses.py``.

Activations arrive split on the sequence; one ``all_to_all`` each puts
q, k and v split on the heads instead, every rank runs attention over
the whole sequence for its heads, and one more ``all_to_all`` puts the
output back on sequence slices.  The exchange is the expert exchange
(``parallel/expert.py``), differentiated by the inverse exchange.  The
inner attention is ``xla_attention``, as in JAX (which computes it
outside Pallas): plain PyTorch, no flash kernel.
"""

from __future__ import annotations

import torch

from ..ops.attention import xla_attention
from .expert import _AllToAll


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, group) -> torch.Tensor:
    """All-to-all sequence parallelism over ``group``: local q, k, v
    [B, S/cp, H|Hkv, D] in (k and v repeated to the query heads first),
    [B, S/cp, H, D] out; inside, attention on [B, S, H/cp, D]."""
    cp, hq = group.size(), q.shape[2]
    if hq % cp:
        raise ValueError(f"Ulysses needs heads ({hq}) divisible by cp ({cp})")
    if k.shape[2] != hq:
        rep = hq // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    q, k, v = (_AllToAll.apply(t, group, 2, 1) for t in (q, k, v))
    out = xla_attention(q, k, v, causal=causal)
    return _AllToAll.apply(out, group, 1, 2)
