"""Train-state dtype policies: the JAX package's ``training/precision.py``.

Presets:

- ``fp32``   params fp32, grads fp32, moments fp32 (16 B/param incl. grads)
- ``mixed``  params fp32 (master), compute+grads bf16, moments bf16
             (10 B/param): update math stays fp32
- ``bf16``   everything stored bf16 (8 B/param); update math is still
             fp32 (moments are cast up, updated, cast back)

The optimizer wrapper stores moments in ``moment_dtype`` but always runs
the inner transform in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .optim import GradientTransformation, tree_map


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype policy for the train state.

    ``param_dtype``   storage dtype of trained parameters.
    ``compute_dtype`` dtype params are cast to at the loss boundary; the
                      gradients come back in this dtype.
    ``moment_dtype``  storage dtype of optimizer-state tensors (Adam mu/nu)
                      — anything param-shaped in the state.
    """

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    moment_dtype: torch.dtype

    @property
    def bytes_per_param(self) -> float:
        """params + grads + two moments, per parameter (the planner's
        memory model)."""
        return (self.param_dtype.itemsize + self.compute_dtype.itemsize
                + 2 * self.moment_dtype.itemsize)


PRESETS: dict[str, Precision] = {
    "fp32": Precision("fp32", torch.float32, torch.float32, torch.float32),
    "mixed": Precision("mixed", torch.float32, torch.bfloat16,
                       torch.bfloat16),
    "bf16": Precision("bf16", torch.bfloat16, torch.bfloat16, torch.bfloat16),
}


def resolve(precision: str | Precision) -> Precision:
    if isinstance(precision, Precision):
        return precision
    try:
        return PRESETS[precision]
    except KeyError:
        raise ValueError(
            f"Unknown precision {precision!r}; expected one of "
            f"{sorted(PRESETS)} or a Precision instance") from None


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Floating-point tensor leaves of ``tree`` cast to ``dtype``; other
    leaves (integer tensors, step counts) pass through."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def _cast_state_tensors(state: Any, dtype: torch.dtype) -> Any:
    """Float tensor leaves with ndim >= 1 of an optimizer state cast to
    ``dtype``; scalars keep theirs."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() and x.ndim >= 1 else x, state)


def wrap_optimizer(inner: GradientTransformation,
                   precision: Precision) -> GradientTransformation:
    """Store optimizer state in ``moment_dtype``; run update math in fp32.

    Gradients and params are cast up to fp32 before the inner transform,
    so Adam's moments and the weight-decay term never accumulate in
    bf16; the updates come back fp32."""
    if (precision.moment_dtype == torch.float32
            and precision.param_dtype == torch.float32):
        return inner

    def init_fn(params):
        state = inner.init(cast_floats(params, torch.float32))
        return _cast_state_tensors(state, precision.moment_dtype)

    def update_fn(updates, state, params=None):
        state32 = _cast_state_tensors(state, torch.float32)
        grads32 = cast_floats(updates, torch.float32)
        params32 = (cast_floats(params, torch.float32)
                    if params is not None else None)
        out, new_state = inner.update(grads32, state32, params32)
        return out, _cast_state_tensors(new_state, precision.moment_dtype)

    return GradientTransformation(init_fn, update_fn)
