"""Optimizers with optax's semantics, as plain tensor code.

A :class:`GradientTransformation` is optax's ``(init, update)`` pair over
dicts of tensors keyed by parameter name: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``;
:func:`apply_updates` adds the updates to the parameters.  The presets
(:func:`adamw`, :func:`adamw_cosine`) are the ones the JAX package's
callers use, with optax's defaults, which differ from
``torch.optim.AdamW``'s: weight decay 1e-4 applied to every leaf unless
a ``mask`` says otherwise, the bias correction on the moments, and the
learning-rate schedule read at the count before the step (step 0 uses
``lr(0)``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..utils.device import is_dtensor

Params = dict[str, torch.Tensor]
Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def set_to_zero() -> GradientTransformation:
    """``optax.set_to_zero``: a zero update for every gradient it gets,
    and no state."""

    def update(updates, state, params=None):
        return {n: torch.zeros_like(g) for n, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def multi_transform(
        transforms: dict[str, GradientTransformation],
        labels: Callable[[Params], dict[str, str]] | dict[str, str]
) -> GradientTransformation:
    """``optax.multi_transform``: each parameter's gradient goes through
    the transformation its label names (``labels``: a name -> label
    mapping, or a function of the parameters giving one), each
    transformation's state covers its own parameters only."""

    def label_of(tree) -> dict[str, str]:
        lab = labels(tree) if callable(labels) else labels
        unknown = {lab[n] for n in tree} - set(transforms)
        if unknown:
            raise ValueError(f"labels {sorted(unknown)} name no "
                             f"transformation of {sorted(transforms)}")
        return lab

    def part(tree, lab, key):
        return {n: v for n, v in tree.items() if lab[n] == key}

    def init(params):
        lab = label_of(params)
        return {key: tx.init(part(params, lab, key))
                for key, tx in transforms.items()}

    def update(updates, state, params=None):
        lab = label_of(updates)
        out, new_state = {}, {}
        for key, tx in transforms.items():
            sub = part(updates, lab, key)
            sub_params = None if params is None else {
                n: params[n] for n in sub}
            upd, new_state[key] = tx.update(sub, state[key], sub_params)
            out.update(upd)
        return out, new_state

    return GradientTransformation(init, update)


def _scale_by_adam(b1: float, b2: float, eps: float) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params=None):
        mu = {n: (1 - b1) * g + b1 * state["mu"][n]
              for n, g in updates.items()}
        nu = {n: (1 - b2) * (g * g) + b2 * state["nu"][n]
              for n, g in updates.items()}
        count = state["count"] + 1
        # 1 - decay**count in fp32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        out = {n: (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
               for n in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def _add_decayed_weights(weight_decay: float, mask) -> GradientTransformation:
    def update(updates, state, params=None):
        keep = mask(params) if callable(mask) else mask
        return {n: g + weight_decay * params[n]
                if keep is None or keep[n] else g
                for n, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def _scale_by_learning_rate(lr: float | Schedule) -> GradientTransformation:
    def update(updates, state, params=None):
        step = lr(state["count"]) if callable(lr) else lr
        return ({n: g * -step for n, g in updates.items()},
                {"count": state["count"] + 1})

    return GradientTransformation(lambda params: {"count": 0}, update)


def adamw(lr_or_schedule: float | Schedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
          mask: Callable[[Params], dict[str, bool]] | dict | None = None
          ) -> GradientTransformation:
    """``optax.adamw``: Adam with bias correction, then decoupled weight
    decay (on every parameter unless ``mask`` maps its name to False),
    then the learning rate (a float or a schedule of the step count)."""
    return chain(_scale_by_adam(b1, b2, eps),
                 _add_decayed_weights(weight_decay, mask),
                 _scale_by_learning_rate(lr_or_schedule))


def _trace(decay: float, nesterov: bool) -> GradientTransformation:
    """``optax.trace``: ``t <- g + decay * t``; the update is ``t``, or
    ``g + decay * t`` with ``nesterov``.  One trace tensor a parameter,
    under ``"trace"``."""

    def init(params):
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params=None):
        trace = {n: g + decay * state["trace"][n] for n, g in updates.items()}
        out = ({n: g + decay * trace[n] for n, g in updates.items()}
               if nesterov else trace)
        return out, {"trace": trace}

    return GradientTransformation(init, update)


def sgd(lr_or_schedule: float | Schedule, momentum: float | None = None,
        nesterov: bool = False) -> GradientTransformation:
    """``optax.sgd``: the update is ``-lr * g``, or with ``momentum``
    ``-lr * t`` of :func:`_trace` (optax's ``trace``, then the learning
    rate)."""
    if momentum is None:
        return _scale_by_learning_rate(lr_or_schedule)
    return chain(_trace(momentum, nesterov),
                 _scale_by_learning_rate(lr_or_schedule))


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    """The sum of squares of a whole tensor: a ``DTensor``'s partial sums
    reduced over the mesh (each shard once, a replica once)."""
    s = (g * g).sum()
    return s.full_tensor() if is_dtensor(s) else s


_NORM_TOTAL = contextvars.ContextVar("tadnn_norm_total", default=None)


@contextlib.contextmanager
def norm_over(total: Callable[[dict], torch.Tensor] | None):
    """Within this context a global norm (``clip_by_global_norm``) is
    ``sqrt(total(squares))`` of the per-leaf squared norms by name,
    where the leaves are split over more than a ``DTensor`` shows: a
    pipeline's stages (``core.AutoDistribute``).  None: their plain
    sum."""
    token = _NORM_TOTAL.set(total)
    try:
        yield
    finally:
        _NORM_TOTAL.reset(token)


def global_sq_norm(updates: Params) -> torch.Tensor:
    """The squared global norm of ``updates``; a leaf held elsewhere (a
    meta tensor: another pipeline stage's layer) counts where it is
    held."""
    sq = {n: _sq_sum(g) for n, g in updates.items() if not g.is_meta}
    total = _NORM_TOTAL.get()
    return total(sq) if total is not None else sum(sq.values())


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: every update scaled by
    max_norm / ||updates|| when that norm is at least ``max_norm``.  The
    norm is the global one under a sharded plan (``DTensor`` updates
    beside plain replicated ones, and a pipeline's stages through
    :func:`norm_over`)."""

    def update(updates, state, params=None):
        g_norm = torch.sqrt(global_sq_norm(updates))
        trigger = g_norm < max_norm
        return {n: g if g.is_meta else torch.where(
            trigger, g, (g / g_norm.to(g.dtype)) * max_norm)
                for n, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def _zero1_dim(opt_spec, param_spec) -> int | None:
    """The dim ZeRO-1 shards over ``data`` (the optimizer spec's, where
    the parameter's has none), or None."""
    for d, entry in enumerate(opt_spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "data" in axes and (d >= len(param_spec)
                               or param_spec[d] != entry):
            return d
    return None


def _zero1_layout(p: torch.Tensor, mesh, d: int):
    """Where ZeRO-1 keeps ``p``'s optimizer shard: ``(mesh, placements
    of p, placements of the shard)``.  A plain (replicated) tensor
    shards over ``mesh["data"]``; a ``DTensor`` of a plan keeps its own
    placements and adds ``Shard(d)`` on ``data``: its mesh's data dim
    where it has one (HSDP), else a ``data`` dim in front of its mesh
    (tensor parallelism beside a data axis)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(p):
        return mesh["data"], [Replicate()], [Shard(d)]
    names = p.device_mesh.mesh_dim_names
    placements = list(p.placements)
    if "data" in names:
        i = names.index("data")
        return (p.device_mesh, placements,
                placements[:i] + [Shard(d)] + placements[i + 1:])
    return (mesh[("data", *names)], [Replicate(), *placements],
            [Shard(d), *placements])


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def zero1_shards(params: Params, *, mesh, opt_specs, param_specs) -> Params:
    """The optimizer's view of ``params`` under ZeRO-1: a leaf whose
    optimizer spec adds ``data`` on a dim is this rank's slice there, a
    ``DTensor`` sharded over ``data`` (:func:`_zero1_layout`: beside a
    plan's own tensor or fsdp shards); any other leaf is itself."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in params.items():
        d = _zero1_dim(opt_specs[name], param_specs[name])
        if d is None:
            out[name] = p
            continue
        m, whole, shard = _zero1_layout(p, mesh, d)
        out[name] = DTensor.from_local(
            _local(p.detach()), m, whole, run_check=False).redistribute(
                m, shard)
    return out


@torch.no_grad()
def zero1_update(optimizer: GradientTransformation, grads: Params,
                 opt_state: Any, params: Params, *, mesh, opt_specs,
                 param_specs) -> tuple[Params, Any]:
    """ZeRO-1 sharded weight update (arxiv 2004.13336): each rank's
    ``grads`` reduce-scattered onto the optimizer shard over
    ``mesh["data"]`` (averaged over its ranks; a gradient FSDP2 already
    averaged over data, under HSDP, is only sliced), the update run on
    the shard (``opt_state`` holds shards: :func:`zero1_shards` at
    init), the fresh shards all-gathered into ``params`` in place.  A
    leaf ZeRO-1 leaves whole has its gradient all-reduced over data,
    unless its ``DTensor`` already carries the data axis."""
    from torch.distributed.tensor import DTensor, Partial

    data = mesh["data"]
    n = data.size()
    shards = zero1_shards(params, mesh=mesh, opt_specs=opt_specs,
                          param_specs=param_specs)
    sharded_grads = {}
    for name, g in grads.items():
        d = _zero1_dim(opt_specs[name], param_specs[name])
        averaged = is_dtensor(g) and "data" in g.device_mesh.mesh_dim_names
        if d is None:
            if not averaged:
                local = _local(g).clone()
                torch.distributed.all_reduce(local, group=data.get_group())
                local = local / n
                g = (DTensor.from_local(local, g.device_mesh, g.placements,
                                        run_check=False)
                     if is_dtensor(g) else local)
            sharded_grads[name] = g
            continue
        m, whole, shard = _zero1_layout(params[name], mesh, d)
        if averaged:
            sharded_grads[name] = DTensor.from_local(
                _local(g), m, whole, run_check=False).redistribute(m, shard)
            continue
        # the data dim _zero1_layout put in front: this rank's sum
        sharded_grads[name] = DTensor.from_local(
            _local(g), m, [Partial(), *whole[1:]],
            run_check=False).redistribute(m, shard) / n
    updates, opt_state = optimizer.update(sharded_grads, opt_state, shards)
    for name, p in params.items():
        new = shards[name] + updates[name]
        d = _zero1_dim(opt_specs[name], param_specs[name])
        if d is not None:
            m, whole, _ = _zero1_layout(p, mesh, d)
            new = new.redistribute(m, whole)
        _local(p).copy_(_local(new))
    return params, opt_state


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """``p <- p + u`` in place for every parameter that has an update,
    computed in the promoted type and stored in the parameter's own
    (``optax.apply_updates``); a frozen parameter gets none."""
    for n, u in updates.items():
        params[n].copy_(params[n] + u)


def warmup_cosine(peak_lr: float, total_steps: int, *,
                  warmup_steps: int | None = None,
                  end_lr_frac: float = 0.1) -> Schedule:
    """Linear warmup from 0 to ``peak_lr``, then cosine decay to
    ``end_lr_frac * peak_lr`` at ``total_steps``
    (``optax.warmup_cosine_decay_schedule``).  ``warmup_steps`` defaults
    to 1% of ``total_steps`` (min 100, capped at total_steps // 10)."""
    if warmup_steps is None:
        warmup_steps = min(max(100, total_steps // 100),
                           max(1, total_steps // 10))
    end = end_lr_frac * peak_lr
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * (count / warmup_steps)
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return peak_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def decay_mask(params: Params) -> dict[str, bool]:
    """Weight-decay mask, the GPT no_decay parameter group: a parameter
    named ``scale`` or ``bias`` never decays; any other with two or more
    dimensions (embeddings, projections, the head) does."""
    return {n: n.rsplit(".", 1)[-1] not in ("bias", "scale") and p.ndim >= 2
            for n, p in params.items()}


def adamw_cosine(peak_lr: float = 3e-4, total_steps: int = 10000, *,
                 warmup_steps: int | None = None, weight_decay: float = 0.1,
                 b1: float = 0.9, b2: float = 0.95,
                 grad_clip: float = 1.0) -> GradientTransformation:
    """AdamW + global-norm clip + warmup-cosine: the standard GPT
    pretraining recipe in one call."""
    tx = adamw(warmup_cosine(peak_lr, total_steps, warmup_steps=warmup_steps),
               b1=b1, b2=b2, weight_decay=weight_decay, mask=decay_mask)
    if grad_clip:
        tx = chain(clip_by_global_norm(grad_clip), tx)
    return tx
