"""Mixture-of-Experts routing and the expert feed-forward, unsharded: the
port of the JAX package's ``parallel/expert.py`` at expert degree 1.

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
computes them outside any Pallas kernel too.  ``moe_ffn_sharded`` and
``moe_ffn(mesh=...)`` with an expert axis (expert parallelism) are not
ported yet.

Terminology: E experts, C capacity slots per group, B groups (batch
rows), S tokens per group, d model width, f expert hidden width.
"""

from __future__ import annotations

from typing import Callable

import torch
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


def moe_ffn(x: torch.Tensor, router_logits: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *,
            w_gate: torch.Tensor | None = None, top_k: int = 2,
            capacity_factor: float = 1.25,
            act: Callable[[torch.Tensor], torch.Tensor] = (
                lambda t: F.gelu(t, approximate="tanh")),
            mesh=None, expert_axis: str = "expert",
            capacity: int | None = None):
    """The MoE feed-forward: ``x`` [B, S, d], ``router_logits`` [B, S, E],
    expert banks ``w_up`` / ``w_gate`` [E, d, f] and ``w_down`` [E, f, d]
    in ``x``'s dtype -> ``(y [B, S, d], metrics)``.  ``capacity``
    overrides the slot count derived from S.  ``mesh`` (a ``DeviceMesh``
    or a degrees mapping) with an ``expert_axis`` of degree > 1 (expert
    parallelism) raises: this port runs MoE at expert degree 1."""
    if mesh is not None:
        from ..topology import mesh_degrees

        if mesh_degrees(mesh).get(expert_axis, 1) > 1:
            raise NotImplementedError(
                "moe_ffn over an expert mesh axis: expert parallelism is "
                "not ported to the PyTorch package yet (ROADMAP Queue 1 "
                "item 6)")
    B, S, d = x.shape
    E = w_up.shape[0]
    if capacity is None:
        capacity = expert_capacity(S, E, top_k, capacity_factor)
    combine, dispatch, metrics = top_k_routing(router_logits, top_k, capacity)
    dt = x.dtype
    h = torch.einsum("bsec,bsd->becd", dispatch.to(dt), x)
    h = expert_mlp(h, w_up, w_gate, w_down, act)
    y = torch.einsum("bsec,becd->bsd", combine.to(dt), h)
    return y.to(x.dtype), metrics
