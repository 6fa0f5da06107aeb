"""The matrix view of the decoder's kernels: which dims of a weight are
its input features and which its output features.

The part of the JAX package's ``training/lora.py`` that the int8 decode
weights need (``inference/quant.py::quantize_for_decode`` scales each
kernel per output channel over its input dims): :class:`LoraTarget`,
the kernel families ``Q_LIKE`` / ``O_LIKE`` / ``MLP_LIKE`` /
``HEAD_LIKE``, their table ``KERNEL_MATRIX_VIEWS`` and
:func:`matrix_view`.  The LoRA factors themselves, their optimizer and
the merge are a later slice of the port (ROADMAP Queue 1 item 2).

The patterns name the port's parameters (``DecoderLM.named_parameters``)
rather than the flax tree's paths, and a target says in which order its
dims come: the projections and the MLP are ``nn.Linear`` weights,
``[out, in]`` (``out_first``), where the JAX kernels are
``DenseGeneral``'s ``[in.., out..]``; the untied head keeps JAX's
``[d, V]``.  Each family covers the same weights as in the JAX table,
so both packages scale the same channels.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LoraTarget:
    """One kernel pattern: ``in_dims`` input dims and ``out_dims`` output
    dims at the end of the shape, inputs first (or outputs first with
    ``out_first``, the ``nn.Linear`` layout); anything earlier
    broadcasts."""

    pattern: str
    in_dims: int = 1
    out_dims: int = 1
    out_first: bool = False


# the core's kernel families in the port's layouts — one table for every
# consumer that needs the matrix view
Q_LIKE = LoraTarget(r"(q_proj|k_proj|v_proj)\.weight$", 1, 1, out_first=True)
O_LIKE = LoraTarget(r"o_proj\.weight$", 1, 1, out_first=True)
MLP_LIKE = LoraTarget(r"(up_proj|gate_proj|down_proj)\.weight$", 1, 1,
                      out_first=True)
HEAD_LIKE = LoraTarget(r"^lm_head$", 1, 1)
KERNEL_MATRIX_VIEWS = (Q_LIKE, O_LIKE, MLP_LIKE, HEAD_LIKE)


def _trailing(shape, target: LoraTarget):
    n = target.in_dims + target.out_dims
    if len(shape) < n:
        raise ValueError(
            f"kernel shape {tuple(shape)} has fewer dims than the target's "
            f"in_dims+out_dims={n} ({target})")
    return len(shape) - n


def matrix_view(shape, target: LoraTarget):
    """(lead dims, d_in, d_out) of a kernel under ``target``'s split.
    Lead dims derive from the shape (``len(shape) - in_dims -
    out_dims``), so stacked and single kernels both resolve."""
    n_lead = _trailing(shape, target)
    lead = tuple(shape[:n_lead])
    first, second = ((target.out_dims, target.in_dims) if target.out_first
                     else (target.in_dims, target.out_dims))
    a = math.prod(shape[n_lead:n_lead + first])
    b = math.prod(shape[n_lead + first:n_lead + first + second])
    d_in, d_out = (b, a) if target.out_first else (a, b)
    return lead, int(d_in), int(d_out)


def input_dims(shape, target: LoraTarget) -> tuple[int, ...]:
    """The axes of a kernel of ``shape`` that hold its input features:
    the dims a per-output-channel scale reduces over."""
    n_lead = _trailing(shape, target)
    start = n_lead + (target.out_dims if target.out_first else 0)
    return tuple(range(start, start + target.in_dims))
