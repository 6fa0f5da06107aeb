"""Collectives over a named mesh axis: the JAX package's
``parallel/collectives.py`` on ``torch.distributed``.

Each function runs on every rank of the axis's group
(``mesh.get_group(axis)`` of a ``topology.build_mesh`` mesh) with
PyTorch's functional collectives (NCCL on the card, gloo on the CPU),
and gives what the JAX function gives inside ``shard_map`` on the same
local shards.  ``allreduce`` and ``allmean`` also take a tuple of axes.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol

Axes = str | tuple[str, ...]


def _axes(axis: Axes) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _done(x: torch.Tensor) -> torch.Tensor:
    return funcol.wait_tensor(x)


def allreduce(x: torch.Tensor, axis: Axes, *, mesh) -> torch.Tensor:
    """Sum over a mesh axis (or axes)."""
    for ax in _axes(axis):
        x = _done(funcol.all_reduce(x, "sum", mesh.get_group(ax)))
    return x


def allmean(x: torch.Tensor, axis: Axes, *, mesh) -> torch.Tensor:
    """Mean over a mesh axis (or axes)."""
    n = 1
    for ax in _axes(axis):
        n *= mesh.size(mesh.mesh_dim_names.index(ax))
    return allreduce(x, axis, mesh=mesh) / n


def allgather(x: torch.Tensor, axis: str, *, mesh, tiled: bool = True,
              gather_dim: int = 0) -> torch.Tensor:
    """The axis's shards concatenated along ``gather_dim`` (``tiled``),
    or stacked on a new dim there."""
    if not tiled:
        x = x.unsqueeze(gather_dim)
    return _done(funcol.all_gather_tensor(x.contiguous(), gather_dim,
                                          mesh.get_group(axis)))


def reduce_scatter(x: torch.Tensor, axis: str, *, mesh,
                   scatter_dim: int = 0) -> torch.Tensor:
    """Sum over the axis, then this rank's slice along ``scatter_dim``."""
    return _done(funcol.reduce_scatter_tensor(
        x.contiguous(), "sum", scatter_dim, mesh.get_group(axis)))


def broadcast(x: torch.Tensor, axis: str, *, mesh,
              root: int = 0) -> torch.Tensor:
    """Every rank of the axis receives the value of the rank at index
    ``root`` on it (an all-gather and the root's slice, as in JAX)."""
    return allgather(x, axis, mesh=mesh, tiled=False)[root]


def all_to_all(x: torch.Tensor, axis: str, *, mesh, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Chunk ``j`` of ``x`` along ``split_dim`` goes to the axis's rank
    ``j``; the received chunks are concatenated along ``concat_dim`` in
    the senders' order."""
    group = mesh.get_group(axis)
    n = group.size()
    chunks = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    got = _done(funcol.all_to_all_single(chunks, None, None, group))
    return torch.cat(got.unbind(0), dim=concat_dim)


def ppermute_ring(x: torch.Tensor, axis: str, *, mesh,
                  shift: int = 1) -> torch.Tensor:
    """Rotate shards around the axis: index ``i`` sends to
    ``(i + shift) % n``."""
    group = mesh.get_group(axis)
    n = group.size()
    flat = _done(funcol.permute_tensor(   # moves 1-D tensors
        x.reshape(-1).contiguous(), [(i + shift) % n for i in range(n)],
        group))
    return flat.reshape(x.shape)


def axis_index(axis: str, *, mesh) -> int:
    """This rank's index on the axis."""
    return mesh.get_local_rank(axis)
