"""The active parallel plan, as the model code sees it: the JAX package's
``parallel/context.py``.

``AutoDistribute`` publishes the plan's mesh here around the forward
and backward of a step, and ``ops.attention`` reads it to pick ring,
Ulysses or plain attention; ``models.transformer_core`` reads the
rank's offset on the ``seq`` axis for its positions.  Under context
parallelism each rank of the ``seq`` group holds only its own
``S / cp`` slice of the sequence (``core.AutoDistribute`` slices the
batch), so JAX's ``shard_activations``, a sharding constraint, has no
counterpart here.

Megatron-SP (``megatron_sp``, on by default as in JAX): under a
``tensor`` axis of degree t > 1, outside a pipeline, the residual stream
between the attention and MLP blocks carries ``[B, S/t, d]`` on each
rank: the norms, the residual adds and dropout run on the rank's slice
of the sequence, the attention and MLP blocks all-gather it at their
entry and the o and MLP-down projections reduce-scatter their partial
sums back to it (``executor``'s sequence-parallel styles, which read
:func:`sequence_parallel` on each call).  Attention sees the whole
sequence.  It changes memory and collectives, not numbers.  The plan
marks the dense decoder backbones it splits and their layers
(``seq_parallel``): the backbone scatters the stream after the
embeddings and gathers it before the final norm, a layer's dropout
takes its slice of the whole sequence's mask; an MoE stack stays whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from ..topology import mesh_degrees


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """``mesh``: the plan's ``DeviceMesh``; ``seq_impl``: 'auto', 'ring'
    or 'ulysses' (``AutoDistribute(seq_impl=)``); ``megatron_sp``:
    Megatron-SP (module docstring)."""

    mesh: Any
    seq_impl: str = "auto"
    megatron_sp: bool = True

    @property
    def sp_degree(self) -> int:
        """How many ways Megatron-SP splits the residual stream's
        sequence: the tensor degree, or 1 when it is off or under a pipe
        axis (as JAX sets no constraint inside pipeline stages)."""
        degrees = mesh_degrees(self.mesh)
        if not self.megatron_sp or degrees.get("pipe", 1) > 1:
            return 1
        return degrees.get("tensor", 1)

    @property
    def tensor_group(self):
        return self.mesh.get_group("tensor")

    @property
    def seq_degree(self) -> int:
        return mesh_degrees(self.mesh).get("seq", 1)

    @property
    def seq_group(self):
        """The process group of this rank's ``seq`` axis."""
        return self.mesh.get_group("seq")

    @property
    def seq_rank(self) -> int:
        """This rank's index on the ``seq`` axis: its slice of the
        sequence."""
        if self.seq_degree <= 1:
            return 0
        return self.mesh.get_local_rank("seq")


# one process drives one device and one step at a time; a process-wide
# value (not a context variable) because the autograd engine runs a CUDA
# backward, and the layers' recompute inside it, on threads of its own
_active: list[ParallelContext | None] = [None]


def current() -> ParallelContext | None:
    return _active[-1]


@contextlib.contextmanager
def use(ctx: ParallelContext | None):
    _active.append(ctx)
    try:
        yield ctx
    finally:
        _active.pop()


def sequence_parallel(module=None) -> ParallelContext | None:
    """The active context when Megatron-SP splits the residual stream
    (its tensor degree above 1) and, given ``module``, the plan marked it
    for the split (``module.seq_parallel``); else None."""
    ctx = current()
    if ctx is None or ctx.sp_degree <= 1 or (
            module is not None and not getattr(module, "seq_parallel", False)):
        return None
    return ctx


def seq_offset(local_len: int) -> int:
    """The global position of this rank's first token: its ``seq`` index
    times the local length (0 without context parallelism)."""
    ctx = current()
    return 0 if ctx is None else ctx.seq_rank * local_len

