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

Beside them, the JAX package's microbenchmarks (its BASELINE metric is
the all-reduce bus bandwidth): :func:`bench_collective` and
:func:`bench_sweep` time one collective over a mesh axis's group and
report its algorithm and bus bandwidth (the NCCL-tests convention:
``bus = factor * bytes / time``, :func:`_bus_factor`);
:func:`bench_overlap` measures how much of a bucketed gradient
all-reduce hides behind a chain of matmuls.  Where JAX fences a chain of
``iters`` collectives inside one program with a host readback, these
time ``iters`` launches after ``warmup``: between CUDA events on the
card under NCCL, by the host clock on gloo (each call waits).  JAX's
``LATENCY_HIDING_XLA_FLAGS`` steer XLA's scheduler on a TPU and have no
counterpart: here the overlap is the bucket's all-reduce issued
asynchronously (``async_op=True``) on NCCL's stream while the next
layer's matmul runs on the compute stream.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

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


# -- microbenchmarks (the JAX package's BASELINE metric: all-reduce bus
# bandwidth) ------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveBenchResult:
    op: str
    n_devices: int
    size_bytes: int
    time_s: float
    alg_bw_gbps: float  # bytes / time
    bus_bw_gbps: float  # NCCL-tests bus-bandwidth convention

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _bus_factor(op: str, n: int) -> float:
    if op == "allreduce":
        return 2 * (n - 1) / n
    if op in ("allgather", "reduce_scatter"):
        return (n - 1) / n
    if op == "all_to_all":
        return (n - 1) / n
    return 1.0


def _default_mesh(mesh):
    if mesh is not None:
        return mesh
    from .. import topology

    return topology.build_mesh(data=-1)


def _group_device(group) -> torch.device:
    """Where a group's tensors live: this rank's card under NCCL, else
    the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _bench_op(op: str, mesh, axis: str) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """The collective ``bench_collective`` times, as a function of this
    rank's buffer: JAX's ``psum``, tiled ``all_gather`` and
    ``psum_scatter``, ``all_to_all`` (split and concat dim 0) and the
    ring's ``ppermute`` (shift 1)."""
    ops: dict[str, Callable] = {
        "allreduce": lambda x: allreduce(x, axis, mesh=mesh),
        "allgather": lambda x: allgather(x, axis, mesh=mesh),
        "reduce_scatter": lambda x: reduce_scatter(x, axis, mesh=mesh),
        "all_to_all": lambda x: all_to_all(x, axis, mesh=mesh, split_dim=0,
                                           concat_dim=0),
        "ppermute": lambda x: _permute(x, mesh.get_group(axis), 1),
    }
    if op not in ops:
        raise ValueError(f"unknown collective {op!r}; expected one of "
                         f"{sorted(ops)}")
    return ops[op]


def _timed_s(fn: Callable[[], object], iters: int, warmup: int,
             device: torch.device) -> float:
    """Seconds of one call of ``fn``: ``iters`` calls after ``warmup``,
    between CUDA events on a card, by the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        total = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        total = time.perf_counter() - t0
    return max(total, 1e-9) / iters


def bench_collective(
    op: str = "allreduce",
    size_bytes: int = 64 * 2**20,
    *,
    mesh=None,
    axis: str = "data",
    iters: int = 10,
    warmup: int = 3,
    dtype=torch.float32,
) -> CollectiveBenchResult:
    """Time one collective over one mesh axis (``mesh.get_group(axis)``;
    by default ``topology.build_mesh(data=-1)`` over the world); report
    its algorithm and bus bandwidth from the per-rank buffer's bytes.
    Every rank of the group calls it."""
    mesh = _default_mesh(mesh)
    group = mesh.get_group(axis)
    n = group.size()
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_dev = max(size_bytes // itemsize, n)
    per_dev -= per_dev % n  # divisible for scatter ops
    device = _group_device(group)
    x = torch.ones(per_dev, dtype=dtype, device=device)
    fn = _bench_op(op, mesh, axis)
    t = _timed_s(lambda: fn(x), iters, warmup, device)
    # NCCL-tests convention: bandwidth from the PER-RANK buffer size
    nbytes = per_dev * itemsize
    alg = nbytes / t / 1e9
    return CollectiveBenchResult(
        op=op, n_devices=n, size_bytes=nbytes, time_s=t, alg_bw_gbps=alg,
        bus_bw_gbps=alg * _bus_factor(op, n))


def bench_sweep(
    sizes: Sequence[int] = (2**20, 2**24, 2**27),
    ops: Sequence[str] = ("allreduce", "allgather", "reduce_scatter"),
    **kwargs,
) -> list[CollectiveBenchResult]:
    return [bench_collective(op, s, **kwargs) for op in ops for s in sizes]


# -- comm/compute overlap (the bucketed-DDP shape) ------------------------------
#
#   overlap_frac = (t_compute + t_comm - t_both) / min(t_compute, t_comm)
#
# 1.0 = the cheaper phase fully hidden; 0.0 = fully serialized.


@dataclasses.dataclass
class OverlapBenchResult:
    n_devices: int
    layers: int
    t_compute_s: float
    t_comm_s: float
    t_both_s: float
    overlap_frac: float
    bucket_bytes: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def bench_overlap(
    *,
    mesh=None,
    axis: str = "data",
    d: int = 512,
    layers: int = 8,
    bucket_bytes: int = 2**22,
    iters: int = 5,
    warmup: int = 2,
) -> OverlapBenchResult:
    """How much of a gradient bucket's all-reduce hides behind a chain of
    ``layers`` ``d x d`` matmuls (JAX's three programs: the matmuls
    alone, the bucket all-reduces alone, and both, bucket ``i``
    depending on layer ``i`` only).  The buckets' all-reduces are issued
    asynchronously and waited for at the end, so under NCCL bucket
    ``i``'s runs on NCCL's stream while layer ``i + 1``'s matmul runs."""
    mesh = _default_mesh(mesh)
    group = mesh.get_group(axis)
    n = group.size()
    device = _group_device(group)
    m = max(bucket_bytes // 4, 128)
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(d, d, generator=gen) / d ** 0.5).to(device)
    x0 = torch.randn(d, d, generator=gen).to(device)
    buf = torch.ones(m, device=device)

    def compute_only():
        y, acc = x0, torch.zeros((), device=device)
        for _ in range(layers):
            y = y @ w
            acc = acc + y[0, 0]
        return acc

    def reduce_buckets(buckets):
        works, outs = [], []
        for g in buckets():
            works.append(dist.all_reduce(g, group=group, async_op=True))
            outs.append(g)
        acc = torch.zeros((), device=device)
        for work, g in zip(works, outs):
            work.wait()
            acc = acc + g[0]
        return acc

    def comm_only():
        # each bucket's payload differs; no matmul feeds it
        return reduce_buckets(lambda: (buf + float(i) for i in range(layers)))

    def both():
        def buckets():
            y = x0
            for _ in range(layers):
                y = y @ w
                yield buf + y[0, 0]  # bucket i depends on layer i only
        return reduce_buckets(buckets)

    tc = _timed_s(compute_only, iters, warmup, device)
    tm = _timed_s(comm_only, iters, warmup, device)
    tb = _timed_s(both, iters, warmup, device)
    frac = (tc + tm - tb) / max(min(tc, tm), 1e-9)
    return OverlapBenchResult(
        n_devices=n, layers=layers, t_compute_s=tc, t_comm_s=tm,
        t_both_s=tb, overlap_frac=max(min(frac, 1.0), -1.0),
        bucket_bytes=m * 4)
