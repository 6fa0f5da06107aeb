"""Device resolution for the port's entry points, and the process's
place in a ``torch.distributed`` group.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of None means ``cuda`` (``cuda:LOCAL_RANK`` when a process
group is up: one card a process), and asking for CUDA on a machine
without it is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import os

import torch


def group_up() -> bool:
    """Whether a ``torch.distributed`` process group is initialized."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` (``torchrun``),
    else the group rank modulo the visible cards, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if group_up() and torch.cuda.is_available():
        return torch.distributed.get_rank() % torch.cuda.device_count()
    return 0


def resolve_device(device=None) -> torch.device:
    """``device`` (None -> ``cuda``, or ``cuda:LOCAL_RANK`` when a process
    group is up) as a ``torch.device``; raises when CUDA is asked for
    and ``torch.cuda.is_available()`` is False."""
    if device is None:
        device = f"cuda:{local_rank()}" if group_up() else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


def process_index() -> int:
    """This process's ``torch.distributed`` rank when a process group is
    initialized, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The process group's size when one is initialized, else 1 (the
    port runs one device per process)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a sharded or replicated tensor of
    a ``torch.distributed`` plan)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)
