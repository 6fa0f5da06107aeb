"""Parallel execution over ``torch.distributed``: the named-axis
collectives (``collectives``), MoE routing with expert parallelism
(``expert``), pipeline parallelism (``pipeline``), and context
parallelism: the active plan's axes (``context``), ring attention
(``ring``) and Ulysses attention (``ulysses``)."""

from . import collectives, context, expert, pipeline, ring, ulysses

__all__ = ["collectives", "context", "expert", "pipeline", "ring",
           "ulysses"]
