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

Megatron-SP (the JAX context's ``megatron_sp``: the residual stream's
sequence dim also split over ``tensor``) changes memory and not numbers
and is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from ..topology import mesh_degrees


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """``mesh``: the plan's ``DeviceMesh``; ``seq_impl``: 'auto', 'ring'
    or 'ulysses' (``AutoDistribute(seq_impl=)``)."""

    mesh: Any
    seq_impl: str = "auto"

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


def seq_offset(local_len: int) -> int:
    """The global position of this rank's first token: its ``seq`` index
    times the local length (0 without context parallelism)."""
    ctx = current()
    return 0 if ctx is None else ctx.seq_rank * local_len

