"""Mixture-of-Experts routing, the expert feed-forward and expert
parallelism: the port of the JAX package's ``parallel/expert.py``.

GShard-style capacity routing with static shapes: every group (a batch
row) sends at most ``capacity`` tokens to each expert and drops the
overflow (its residual path carries it); dispatch and combine are
products against one-hot masks.  The decisions follow JAX's step for
step, since they decide which tokens drop:

- capacity rounds up to a multiple of 8 (:func:`expert_capacity`, a
  TPU-lane choice kept because it moves the drop decisions);
- the k choices claim capacity choice-major (every first choice, then
  every second), a token's slot ``cumsum(onehot) - onehot + counts``;
- ``argmax`` takes the first of equal maxima, in torch as in JAX;
- the softmax, the load-balance loss and the z-loss are fp32, and the
  kept gates are renormalised over the kept choices with a 1e-9 floor.

The products (dispatch, the experts, combine) are ``torch.einsum``: JAX
computes them outside any Pallas kernel too.

Expert parallelism runs on one process a device.  ``moe_ffn`` with a
``DeviceMesh`` takes this rank's rows and this rank's experts: it routes
the rows (capacity per row, so the drop decisions do not depend on the
sharding), an ``all_to_all`` over the mesh's ``expert`` group regroups
the dispatched slots ``[B_l, E, C, d]`` by owning expert into
``[B_l * ep, E / ep, C, d]``, the local experts run, and the inverse
``all_to_all`` returns the slots for the combine.  The exchange is
differentiable (its backward is the inverse exchange) and runs at any
expert degree, 1 included, so one card runs the path a fleet runs.  With
a ``tensor_axis`` each expert is Megatron-split: the up/gate banks hold
a slice of the hidden dim, the down bank the matching rows, and the
partial outputs are summed over that axis's group.
``moe_ffn_sharded`` is JAX's explicit-collective twin: the global arrays
in, the global output and the metrics averaged over the ranks out.

Terminology: E experts, C capacity slots per group, B groups (batch
rows), S tokens per group, d model width, f expert hidden width.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F


def expert_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots each expert reserves per group, a multiple of 8 (at least 8),
    as in the JAX package."""
    c = int(tokens_per_group * top_k * capacity_factor / n_experts)
    return max(8, -(-c // 8) * 8)


def route_probs(probs: torch.Tensor, top_k: int, capacity: int, *,
                renormalize: bool = True):
    """:func:`top_k_routing` after the softmax: ``probs`` [B, S, E] fp32
    -> ``(combine, dispatch, first_choice)``, each [B, S, E, C] but the
    first choice's one-hot [B, S, E]."""
    B, S, E = probs.shape
    remaining = probs
    counts = torch.zeros((B, 1, E), dtype=torch.float32, device=probs.device)
    gates, masks, first_choice = [], [], None
    for _ in range(top_k):
        onehot = F.one_hot(torch.argmax(remaining, -1), E).to(torch.float32)
        if first_choice is None:
            first_choice = onehot
        gate = (remaining * onehot).sum(-1)  # [B, S]
        remaining = remaining * (1.0 - onehot)
        # position of each token inside its expert's capacity buffer
        pos = torch.cumsum(onehot, dim=1) - onehot + counts  # [B, S, E]
        counts = counts + onehot.sum(dim=1, keepdim=True)
        kept = ((pos < capacity) * onehot).sum(-1)  # [B, S]
        slot = (pos * onehot).sum(-1).to(torch.long)  # [B, S]
        # a dropped token's slot may lie past the buffer: JAX's one_hot
        # gives a zero row there, and ``kept`` zeroes it here the same way
        slot_hot = F.one_hot(slot.clamp(max=capacity - 1), capacity)
        disp = (onehot[..., None] * slot_hot.to(torch.float32)[:, :, None]
                * kept[..., None, None])  # [B, S, E, C]
        masks.append(disp)
        gates.append(gate * kept)
    dispatch = sum(masks)
    gate_stack = torch.stack(gates, -1)  # [B, S, k]
    if renormalize:
        gate_stack = gate_stack / torch.clamp(
            gate_stack.sum(-1, keepdim=True), min=1e-9)
    combine = sum(g[..., None, None] * m
                  for g, m in zip(gate_stack.unbind(-1), masks))
    return combine, dispatch, first_choice


def top_k_routing(router_logits: torch.Tensor, top_k: int, capacity: int,
                  *, renormalize: bool = True):
    """Capacity-based top-k token -> expert assignment.

    ``router_logits`` [B, S, E] (any float type; the softmax is fp32).
    Returns ``(combine, dispatch, metrics)``: ``combine`` [B, S, E, C]
    fp32 gate weights (0 where dropped), ``dispatch`` [B, S, E, C] the
    0/1 routing mask, and ``metrics`` with the Switch load-balance
    ``aux_loss`` (on the first choice), the router ``z_loss`` and the
    ``dropped_fraction``."""
    if router_logits.ndim != 3:
        raise ValueError(
            f"router_logits must be [B,S,E], got {tuple(router_logits.shape)}")
    E = router_logits.shape[-1]
    logits = router_logits.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    combine, dispatch, first_choice = route_probs(
        probs, top_k, capacity, renormalize=renormalize)
    # Switch-style load-balance loss on the first choice: E sum_e f_e p_e
    frac_dispatched = first_choice.mean(dim=1)  # [B, E]
    mean_prob = probs.mean(dim=1)  # [B, E]
    aux_loss = E * (frac_dispatched * mean_prob).sum(-1).mean()
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - dispatch.sum((-2, -1)).mean() / top_k
    return combine, dispatch, {"aux_loss": aux_loss, "z_loss": z_loss,
                               "dropped_fraction": dropped}


def expert_mlp(h_in: torch.Tensor, w_up: torch.Tensor,
               w_gate: torch.Tensor | None, w_down: torch.Tensor,
               act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Per-expert FFN on dispatched tokens: [..., E, C, d] -> [..., E, C, d]
    (SwiGLU when ``w_gate`` is given)."""
    h = torch.einsum("...ecd,edf->...ecf", h_in, w_up)
    if w_gate is not None:
        h = act(torch.einsum("...ecd,edf->...ecf", h_in, w_gate)) * h
    else:
        h = act(h)
    return torch.einsum("...ecf,efd->...ecd", h, w_down)


def exchange(x: torch.Tensor, group, split_dim: int,
             concat_dim: int) -> torch.Tensor:
    """The expert exchange, one ``all_to_all`` over ``group``: chunk ``j``
    of ``x`` along ``split_dim`` to the group's rank ``j``, the received
    chunks concatenated along ``concat_dim`` in the senders' order.
    Counts its launches in ``exchange.launches`` (forward, recompute and
    backward alike)."""
    n = group.size()
    chunks = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(chunks, None, None,
                                                      group))
    exchange.launches += 1
    return torch.cat(got.unbind(0), dim=concat_dim)


exchange.launches = 0


class _AllToAll(torch.autograd.Function):
    """The exchange, differentiated by the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return exchange(g, group, concat_dim, split_dim), None, None, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (the input of
    a hidden-dim split: each rank's slice contributes part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_reduce(
            g.contiguous(), "sum", ctx.group)), None


class _SumOverGroup(torch.autograd.Function):
    """Partial outputs summed over the group; the gradient passes
    through (every rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum",
                                                    group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _local_experts(h: torch.Tensor, w_up, w_gate, w_down, act, group,
                   tensor_group) -> torch.Tensor:
    """The dispatched slots ``[B_l, E, C, d]`` through this rank's
    experts: exchanged over ``group`` (when given), each expert's hidden
    dim split over ``tensor_group`` (when given), exchanged back."""
    if group is not None:
        h = _AllToAll.apply(h, group, 1, 0)  # [B_l * ep, E / ep, C, d]
    if tensor_group is not None:
        h = _CopyToGroup.apply(h, tensor_group)
    h = expert_mlp(h, w_up, w_gate, w_down, act)
    if tensor_group is not None:
        h = _SumOverGroup.apply(h, tensor_group)
    if group is not None:
        h = _AllToAll.apply(h, group, 0, 1)  # [B_l, E, C, d]
    return h


def _groups(mesh, expert_axis: str, tensor_axis: str | None):
    """(expert group, tensor group) of a ``DeviceMesh``; None for no
    mesh.  A degrees mapping has no groups: one of degree 1 is no mesh,
    one with an expert degree above 1 raises."""
    if mesh is None:
        return None, None
    if not hasattr(mesh, "get_group"):
        from ..topology import mesh_degrees

        if mesh_degrees(mesh).get(expert_axis, 1) > 1:
            raise ValueError(
                f"moe_ffn over an expert axis of degree "
                f"{mesh_degrees(mesh)[expert_axis]} needs a DeviceMesh "
                f"(topology.build_mesh): a degrees mapping names no "
                f"process groups")
        return None, None
    return (mesh.get_group(expert_axis),
            None if tensor_axis is None else mesh.get_group(tensor_axis))


def moe_ffn(x: torch.Tensor, router_logits: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *,
            w_gate: torch.Tensor | None = None, top_k: int = 2,
            capacity_factor: float = 1.25,
            act: Callable[[torch.Tensor], torch.Tensor] = (
                lambda t: F.gelu(t, approximate="tanh")),
            mesh=None, expert_axis: str = "expert",
            tensor_axis: str | None = None,
            capacity: int | None = None):
    """The MoE feed-forward: ``x`` [B, S, d], ``router_logits`` [B, S, E],
    expert banks ``w_up`` / ``w_gate`` [E_l, d, f_l] and ``w_down``
    [E_l, f_l, d] in ``x``'s dtype -> ``(y [B, S, d], metrics)``.
    ``capacity`` overrides the slot count derived from S.

    Without ``mesh`` the banks hold every expert.  With a ``DeviceMesh``
    ``x`` holds this rank's rows and the banks this rank's experts
    (E / the degree of ``expert_axis``), exchanged over that axis's group
    at any degree; with ``tensor_axis`` the banks hold this rank's slice
    of the hidden dim f.  The metrics are this rank's rows' (a training
    step averages what its loss reports over the batch axes)."""
    group, tensor_group = _groups(mesh, expert_axis, tensor_axis)
    B, S, d = x.shape
    E = router_logits.shape[-1]
    if E % w_up.shape[0]:
        raise ValueError(f"{E} experts do not divide over banks of "
                         f"{w_up.shape[0]}")
    if group is None and w_up.shape[0] != E:
        raise ValueError(f"{w_up.shape[0]} experts in the banks but {E} "
                         f"router logits, and no expert group to exchange "
                         f"over")
    if capacity is None:
        capacity = expert_capacity(S, E, top_k, capacity_factor)
    combine, dispatch, metrics = top_k_routing(router_logits, top_k, capacity)
    dt = x.dtype
    h = torch.einsum("bsec,bsd->becd", dispatch.to(dt), x)
    h = _local_experts(h, w_up, w_gate, w_down, act, group, tensor_group)
    y = torch.einsum("bsec,becd->bsd", combine.to(dt), h)
    return y.to(x.dtype), metrics


def moe_ffn_sharded(x: torch.Tensor, router_logits: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, *, mesh,
                    w_gate: torch.Tensor | None = None, top_k: int = 2,
                    capacity_factor: float = 1.25,
                    act: Callable[[torch.Tensor], torch.Tensor] = (
                        lambda t: F.gelu(t, approximate="tanh")),
                    expert_axis: str = "expert",
                    batch_axes: tuple[str, ...] = ("data",)):
    """JAX's explicit-collective twin of :func:`moe_ffn` on a
    ``DeviceMesh``: every rank passes the global arrays (``x`` [B, S, d],
    the logits, the whole banks), keeps its rows (its coordinate over
    the batch axes of degree > 1, then ``expert_axis``, major first) and
    its experts, runs :func:`moe_ffn` over the mesh, and returns the
    global output (the rows gathered back) and the metrics averaged over
    those axes, as ``shard_map`` does."""
    from ..topology import mesh_degrees

    degrees = mesh_degrees(mesh)
    ep = degrees.get(expert_axis, 1)
    E = w_up.shape[0]
    if E % ep:
        raise ValueError(f"{E} experts not divisible by ep={ep}")
    S = x.shape[1]
    capacity = expert_capacity(S, E, top_k, capacity_factor)
    axes = [a for a in batch_axes if degrees.get(a, 1) > 1] + [expert_axis]
    n = 1
    idx = 0
    for a in axes:
        n *= degrees.get(a, 1)
        idx = idx * degrees.get(a, 1) + mesh.get_local_rank(a)
    rows = x.shape[0] // n
    take = slice(idx * rows, (idx + 1) * rows)
    e = mesh.get_local_rank(expert_axis)
    mine = slice(e * (E // ep), (e + 1) * (E // ep))
    y, metrics = moe_ffn(
        x[take], router_logits[take], w_up[mine], w_down[mine],
        w_gate=None if w_gate is None else w_gate[mine], top_k=top_k,
        act=act, mesh=mesh, expert_axis=expert_axis, capacity=capacity)
    for a in reversed(axes):
        y = funcol.wait_tensor(funcol.all_gather_tensor(
            y.contiguous(), 0, mesh.get_group(a)))
    for a in axes:
        deg = degrees.get(a, 1)
        metrics = {k: funcol.wait_tensor(funcol.all_reduce(
            v.contiguous(), "sum", mesh.get_group(a))) / deg
            for k, v in metrics.items()}
    return y, metrics
