"""Collectives over a named mesh axis: the JAX package's
``parallel/collectives.py`` on ``torch.distributed``.

Each function runs on every rank of the axis's group
(``mesh.get_group(axis)`` of a ``topology.build_mesh`` mesh) with
PyTorch's functional collectives (NCCL on the card, gloo on the CPU),
and gives what the JAX function gives inside ``shard_map`` on the same
local shards.  ``allreduce`` and ``allmean`` also take a tuple of axes.

Beside them, the moves that pipeline and context parallelism make
between ranks: the stage-to-stage sends and receives of the pipeline
schedules (:func:`hops`), the ring's step (:func:`ring_step`;
``ppermute_ring`` is its differentiable form, the gradient rotated back
as JAX differentiates ``ppermute``), the gather of a sequence's slices
(:func:`gather_slices`) and a broadcast from one rank of a group
(:func:`broadcast_from`).

gloo moves CUDA tensors only for ``all_reduce`` and ``broadcast``:
for ``send``/``recv``, ``all_to_all`` and the permutation it takes CPU
tensors.  On a gloo group a CUDA tensor is therefore copied to
a host buffer, moved, and copied back (two processes sharing one card
have no NCCL group: NCCL refuses two ranks on one device); the copies'
bytes are counted in ``traffic["staged"]``.  That is transport, never a
computation moved off the card.  Under NCCL tensors move directly.
``traffic`` also counts the payload bytes this rank sends: the
pipeline's stage boundaries (``"pipe"``), the broadcasts it is the
source of (``"broadcast"``: the pipeline's trunk output and input
cotangent), the ring's K/V rotations (``"ring"``) and the all-to-all
exchanges (``"all_to_all"``).

:class:`CollectiveCounter` counts the collectives dispatched while it is
active, by kind, whoever issues them (a tensor-parallel wrapper's
``DTensor`` redistribution, FSDP2, or a direct ``torch.distributed``
call): the count a decode step or a training step makes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
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
    ``(i + shift) % n``.  Differentiable, as JAX's ``ppermute``: the
    gradient rotates back the other way."""
    return _Rotate.apply(x, mesh.get_group(axis), shift)


def axis_index(axis: str, *, mesh) -> int:
    """This rank's index on the axis."""
    return mesh.get_local_rank(axis)


# -- pipeline and context parallelism -------------------------------------------

traffic = {"pipe": 0, "broadcast": 0, "ring": 0, "all_to_all": 0,
           "staged": 0}


# the kinds, by the words their dispatched ops' names hold (the
# functional and the in-place ops, coalesced and padded variants too)
_KINDS = (("reduce_scatter", "reduce_scatter"), ("all_reduce", "all_reduce"),
          ("allreduce", "all_reduce"), ("all_gather", "all_gather"),
          ("allgather", "all_gather"), ("all_to_all", "all_to_all"),
          ("alltoall", "all_to_all"), ("broadcast", "broadcast"))


class CollectiveCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """``with CollectiveCounter() as c: ...``: ``c.counts`` maps a kind
    (``all_reduce``, ``reduce_scatter``, ``all_gather``, ``all_to_all``,
    ``broadcast``) to the collectives of that kind dispatched inside."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = next((k for word, k in _KINDS if word in func._opname),
                        None)
            if kind is not None:
                self.counts[kind] = self.counts.get(kind, 0) + 1
        return func(*args, **(kwargs or {}))


def reset_traffic() -> None:
    for key in traffic:
        traffic[key] = 0


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` must cross ``group`` through a host buffer: a CUDA
    tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    traffic["staged"] += x.numel() * x.element_size()
    return x.to("cpu")


def _from_host(x: torch.Tensor, device) -> torch.Tensor:
    traffic["staged"] += x.numel() * x.element_size()
    return x.to(device)


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Group rank ``i`` sends ``x`` to ``(i + shift) % n``."""
    n = group.size()
    staged = _staged(x, group)
    src = _to_host(x) if staged else x
    flat = _done(funcol.permute_tensor(   # moves 1-D tensors
        src.reshape(-1).contiguous(), [(i + shift) % n for i in range(n)],
        group))
    out = flat.reshape(x.shape)
    return _from_host(out, x.device) if staged else out


def all_to_all_single(chunks: torch.Tensor, group) -> torch.Tensor:
    """``chunks[j]`` to the group's rank ``j``; returns the received
    chunks stacked in the senders' order (a host buffer in between on a
    gloo group)."""
    staged = _staged(chunks, group)
    traffic["all_to_all"] += chunks.numel() * chunks.element_size()
    src = _to_host(chunks) if staged else chunks
    got = _done(funcol.all_to_all_single(src, None, None, group))
    return _from_host(got, chunks.device) if staged else got


def ring_step(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """One step of a ring (:func:`rotate` without autograd), its bytes
    counted in ``traffic["ring"]``."""
    traffic["ring"] += x.numel() * x.element_size()
    return _permute(x.contiguous(), group, shift)


class _Rotate(torch.autograd.Function):
    """One step of the ring: rank ``i`` sends to ``i + shift``; the
    cotangent rides the reverse step."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_step(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_step(g, ctx.group, -ctx.shift), None, None


def global_rank(group, group_rank: int) -> int:
    return dist.get_global_rank(group, group_rank)


def broadcast_from(x: torch.Tensor | None, src: int, group, *, shape=None,
                   dtype=None, device=None) -> torch.Tensor:
    """The tensor of group rank ``src`` on every rank of ``group``: the
    source passes ``x``, the others ``None`` with its ``shape``,
    ``dtype`` and ``device``."""
    if x is None:
        x = torch.empty(shape, dtype=dtype, device=device)
    else:
        x = x.contiguous()
        traffic["broadcast"] += x.numel() * x.element_size()
    # gloo broadcasts CUDA tensors itself
    dist.broadcast(x, src=global_rank(group, src), group=group)
    return x


def hops(moves, *, like: torch.Tensor, group, kind: str = "pipe") -> list:
    """The exchanges of one pipeline tick, posted together
    (``batch_isend_irecv``: no order between them can deadlock).  Each
    move ``(send, to, expect, frm)`` sends ``send`` (or nothing) to group
    rank ``to`` and, when ``expect``, receives a tensor shaped like
    ``like`` from group rank ``frm``; returns the received tensors (None
    where none was expected).  Every rank of the group derives the same
    ``expect`` from the schedule, so each send meets its receive."""
    staged = _staged(like, group)
    ops, bufs, out = [], [], []
    for send, to, expect, frm in moves:
        if send is not None:
            traffic[kind] += send.numel() * send.element_size()
            t = _to_host(send) if staged else send.contiguous()
            ops.append(dist.P2POp(dist.isend, t, global_rank(group, to),
                                  group))
            bufs.append(t)  # alive until the send completes
        if expect:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if staged else like.device)
            ops.append(dist.P2POp(dist.irecv, buf, global_rank(group, frm),
                                  group))
            out.append(buf)
        else:
            out.append(None)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        out = [None if b is None else _from_host(b, like.device)
               for b in out]
    return out


class _GatherSeq(torch.autograd.Function):
    """Every rank's slice concatenated along ``dim`` in rank order; the
    gradient of this rank's slice is the sum over the ranks of their
    gradients for it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def gather_slices(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The whole tensor from each rank's slice along ``dim`` (a sequence
    split over the ``seq`` axis), differentiable."""
    return _GatherSeq.apply(x, group, dim)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    host buffer in between for a CUDA tensor on a gloo group)."""
    staged = _staged(x, group)
    src = _to_host(x) if staged else x
    out = _done(funcol.all_gather_tensor(
        src.movedim(dim, 0).contiguous(), 0, group)).movedim(0, dim)
    return _from_host(out, x.device) if staged else out


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x`` summed over the group."""
    staged = _staged(x, group)
    src = _to_host(x) if staged else x
    out = _done(funcol.reduce_scatter_tensor(
        src.movedim(dim, 0).contiguous(), "sum", 0, group)).movedim(0, dim)
    return _from_host(out, x.device) if staged else out


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group.size()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    width = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * width, width).contiguous()


class _Scatter(torch.autograd.Function):
    """This rank's slice; the gradient gathered back (Megatron-SP's
    entry: every rank holds the same whole tensor before it)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    """The slices gathered; the gradient this rank's slice of it (every
    rank computes the same loss from the whole tensor)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Partial sums reduce-scattered along ``dim``; the gradient
    all-gathered."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def scatter_slices(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor every rank holds
    whole; its gradient all-gathered (Megatron-SP's ``g`` operator)."""
    return _Scatter.apply(x, group, dim)


def gather_whole(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The whole tensor from each rank's slice along ``dim``, whose
    gradient is the same on every rank: the backward keeps this rank's
    slice of it, no collective."""
    return _GatherWhole.apply(x, group, dim)


def reduce_scatter_slices(x: torch.Tensor, group,
                          dim: int = 1) -> torch.Tensor:
    """Each rank's partial sums, reduce-scattered along ``dim``;
    differentiable (the gradient all-gathered)."""
    return _ReduceScatter.apply(x, group, dim)
