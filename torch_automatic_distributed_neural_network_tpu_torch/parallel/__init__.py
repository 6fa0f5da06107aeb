"""Parallel execution over ``torch.distributed``: the named-axis
collectives (``collectives``) and MoE routing with expert parallelism
(``expert``).  Sequence and pipeline parallelism are a later slice of
the port (ROADMAP Queue 1 item 5)."""

from . import collectives, expert

__all__ = ["collectives", "expert"]
