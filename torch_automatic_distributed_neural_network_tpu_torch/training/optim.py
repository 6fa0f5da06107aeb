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

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

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


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: every update scaled by
    max_norm / ||updates|| when that norm is at least ``max_norm``."""

    def update(updates, state, params=None):
        g_norm = torch.sqrt(sum((g * g).sum() for g in updates.values()))
        trigger = g_norm < max_norm
        return {n: torch.where(trigger, g, (g / g_norm.to(g.dtype)) * max_norm)
                for n, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """``p <- p + u`` in place, computed in the promoted type and stored
    in the parameter's own (``optax.apply_updates``)."""
    for n, p in params.items():
        p.copy_(p + updates[n])


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
