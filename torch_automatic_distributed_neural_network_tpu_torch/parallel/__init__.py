"""Parallel execution over ``torch.distributed``: the named-axis
collectives (``collectives``).  Sequence, pipeline and expert
parallelism are later slices of the port (ROADMAP Queue 1 item 5)."""

from . import collectives

__all__ = ["collectives"]
