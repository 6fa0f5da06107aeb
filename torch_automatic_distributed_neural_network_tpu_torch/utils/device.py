"""Device resolution for the port's entry points, and the process's
place in a ``torch.distributed`` group.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of None means ``cuda``, and asking for CUDA on a machine
without it is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None -> ``cuda``) as a ``torch.device``; raises when
    CUDA is asked for and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
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
