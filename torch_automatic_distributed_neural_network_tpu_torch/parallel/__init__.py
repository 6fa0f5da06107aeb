"""Parallel execution over ``torch.distributed``: the named-axis
collectives (``collectives``) and MoE routing at expert degree 1
(``expert``).  Sequence, pipeline and expert parallelism are later
slices of the port (ROADMAP Queue 1 items 5 and 6)."""

from . import collectives, expert

__all__ = ["collectives", "expert"]
