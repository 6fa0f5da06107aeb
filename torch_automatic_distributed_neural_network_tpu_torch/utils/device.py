"""Device resolution for the port's entry points, the process's place in
a ``torch.distributed`` group, a tensor's local shard, and the gloo
group for small host-side agreements.

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


def local_shard(t: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...],
                                          bool]:
    """``(local tensor, its global offsets, replica 0?)`` of a tensor: a
    ``DTensor``'s local shard where its placements put it (its
    coordinate 0 on every mesh dim that does not shard it makes it
    replica 0); a plain tensor is whole, replica 0 everywhere (the
    caller picks one process)."""
    if not is_dtensor(t):
        return t, (0,) * t.dim(), True
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    _, offsets = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    coord = t.device_mesh.get_coordinate()
    replica0 = all(c == 0 for c, pl in zip(coord, t.placements)
                   if not pl.is_shard())
    return t.to_local(), tuple(int(o) for o in offsets), replica0


_HOST_GROUPS: dict = {}


def host_group():
    """The process group for small host-side agreements (a drain flag, a
    parameter checksum), as CPU tensors: the default group under gloo,
    and a gloo group over the same ranks, made once, under NCCL (a CPU
    tensor never goes over an NCCL group).  ``new_group`` is itself a
    collective: ``topology.initialize_distributed`` makes it as the group
    comes up, so the first agreement inside a step loop makes none."""
    dist = torch.distributed
    if dist.get_backend() == "gloo":
        return None
    default = dist.distributed_c10d._get_default_group()
    if default not in _HOST_GROUPS:
        _HOST_GROUPS[default] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[default]


def host_allgather(obj) -> list:
    """``obj`` (picklable) from every rank, in rank order, over
    :func:`host_group`; ``[obj]`` when no process group is up."""
    if not group_up():
        return [obj]
    dist = torch.distributed
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=host_group())
    return out
