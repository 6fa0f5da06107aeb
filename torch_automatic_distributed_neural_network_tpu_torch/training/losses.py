"""Losses with the ``AutoDistribute`` loss signature.

``loss_fn(model, batch, generator) -> (loss, aux_dict)``: the port's
counterpart of the JAX package's ``(params, batch, rng, apply_fn)``.
``model`` is the model (its parameters in the compute dtype), ``batch``
a dict of tensors on the model's device, ``generator`` a CPU
``torch.Generator`` for dropout or None (deterministic).  The batches:

- causal LM (``next_token_loss``, ``moe_next_token_loss``, the blockwise
  loss): ``input_ids`` or ``tokens`` [B, S+1], optional ``mask``;
- classification (``softmax_xent_loss``): ``x`` (or ``image``) and
  ``label`` (or ``y``) integer labels; regression (``mse_loss``): ``x``
  and ``y`` (or ``label``);
- stateful models (BatchNorm: ``softmax_xent_loss_mutable``,
  ``next_token_loss_mutable``): the model runs with ``train=True,
  mutable=True`` and the loss returns the new running statistics in
  ``aux["model_state"]``, which the step commits (JAX's mutable
  collections);
- MT (``seq2seq_loss``): ``src`` [B, S] and ``tgt`` [B, T+1], target 0
  padding;
- masked LM (``masked_lm_loss``): ``input_ids``, ``labels`` (-100, any
  negative, where not masked) and optional ``segment_ids`` /
  ``attn_mask``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax ``softmax_cross_entropy_with_integer_labels``: per position
    logsumexp(logits) - logits[target], fp32."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V).float(),
                           targets.reshape(-1).long(),
                           reduction="none").reshape(targets.shape)


def _shifted_xent(logits, tokens, mask):
    """Next-token cross-entropy on already-shifted logits; returns (mean
    loss, token count), padding-masked when ``mask`` is given."""
    targets = tokens[:, 1:]
    losses = _xent(logits, targets)
    if mask is not None:
        mask = mask[:, 1:].to(losses.dtype)
        denom = torch.clamp(mask.sum(), min=1)
        return (losses * mask).sum() / denom, denom
    return losses.mean(), torch.tensor(float(targets.numel()),
                                       device=losses.device)


def _tokens(batch):
    return batch.get("input_ids", batch.get("tokens"))


def _get(batch, *keys):
    """The first of ``keys`` present in ``batch`` (JAX's chained
    ``batch.get``), or None."""
    return next((batch[k] for k in keys if k in batch), None)


def softmax_xent_loss(model, batch, generator):
    """Image / sequence classification: logits vs integer labels."""
    labels = _get(batch, "label", "y")
    logits = model(_get(batch, "x", "image"), generator=generator)
    loss = _xent(logits, labels).mean()
    acc = (torch.argmax(logits, -1) == labels).to(torch.float32).mean()
    return loss, {"accuracy": acc}


def _apply_mutable(model, x, generator):
    """``(output, new model state)``: a stateful model (``stateful``, e.g.
    ``ResNet``) in training mode with its state updates, any other with
    none, as flax's ``apply(..., mutable=[])`` of a stateless model."""
    if getattr(model, "stateful", False):
        return model(x, train=True, mutable=True, generator=generator)
    return model(x, generator=generator), {}


def softmax_xent_loss_mutable(model, batch, generator):
    """Classification loss for stateful models (BatchNorm): the batch's
    statistics normalize, and the new running ones come back in
    ``aux["model_state"]``."""
    labels = _get(batch, "label", "y")
    logits, updates = _apply_mutable(model, _get(batch, "x", "image"),
                                     generator)
    loss = _xent(logits, labels).mean()
    acc = (torch.argmax(logits, -1) == labels).to(torch.float32).mean()
    return loss, {"accuracy": acc, "model_state": updates}


def next_token_loss_mutable(model, batch, generator):
    """The causal LM twin of :func:`softmax_xent_loss_mutable`: padding
    masks work as in :func:`next_token_loss`."""
    tokens = _tokens(batch)
    logits, updates = _apply_mutable(model, tokens[:, :-1], generator)
    loss, denom = _shifted_xent(logits, tokens, batch.get("mask"))
    return loss, {"tokens": denom, "model_state": updates}


def next_token_loss(model, batch, generator):
    """Causal LM: predict token t+1 from tokens <= t; ignores padding if
    an explicit ``mask`` is present."""
    tokens = _tokens(batch)
    logits = model(tokens[:, :-1], generator=generator)
    loss, denom = _shifted_xent(logits, tokens, batch.get("mask"))
    return loss, {"tokens": denom}


def moe_next_token_loss(model, batch, generator):
    """Causal LM loss for MoE models returning ``(logits, aux)``:
    ``next_token_loss``'s cross-entropy plus the router load-balance and
    z losses (``models/moe.py``)."""
    tokens = _tokens(batch)
    logits, aux_loss = model(tokens[:, :-1], generator=generator)
    xent, _ = _shifted_xent(logits, tokens, batch.get("mask"))
    return xent + aux_loss, {"xent": xent, "router_loss": aux_loss}


def seq2seq_loss(model, batch, generator):
    """Teacher-forced MT loss: predict tgt[t+1] from src + tgt[<=t];
    target positions equal to 0 are padding."""
    src, tgt = batch["src"], batch["tgt"]
    logits = model(src, tgt[:, :-1], generator=generator)
    targets = tgt[:, 1:]
    losses = _xent(logits, targets)
    mask = (targets != 0).to(losses.dtype)
    loss = (losses * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss, {"tokens": mask.sum()}


def masked_lm_loss(model, batch, generator):
    """BERT-style masked LM: cross-entropy at the masked positions only
    (``labels >= 0``; HF's -100 elsewhere)."""
    tokens, labels = batch["input_ids"], batch["labels"]
    logits = model(tokens, segment_ids=batch.get("segment_ids"),
                   attn_mask=batch.get("attn_mask"), generator=generator)
    keep = labels >= 0
    losses = _xent(logits, torch.where(keep, labels, torch.zeros_like(labels)))
    denom = torch.clamp(keep.sum(), min=1)
    loss = (losses * keep).sum() / denom
    return loss, {"tokens": denom.to(torch.float32)}


def mse_loss(model, batch, generator):
    """Mean squared error of ``model(x)`` against ``y``."""
    pred = model(batch.get("x"))
    loss = torch.mean((pred - _get(batch, "y", "label")) ** 2)
    return loss, {}


def _head_weight(model) -> torch.Tensor:
    """[d_model, V] head weight of a tied or untied decoder."""
    if model.cfg.tie_embeddings:
        return model.embed.T
    return model.lm_head


def _blockwise_xent(features, head_w, targets, mask, block_size):
    """Mean next-token CE without materializing the [B, S, V] logits:
    one [B, block, V] block at a time, recomputed in the backward.

    features: [B, S, d] (compute dtype); head_w: [d, V];
    targets: [B, S] int; mask: [B, S] float or None."""
    b, s, _ = features.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32,
                          device=features.device)
    mask = mask.to(torch.float32)

    def block_nll(f, t, m, w):
        logits = f.to(torch.float32) @ w.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        correct = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        return ((lse - correct) * m).sum()

    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for i in range(0, s, block_size):
        part = (features[:, i:i + block_size], targets[:, i:i + block_size],
                mask[:, i:i + block_size], head_w)
        if torch.is_grad_enabled():
            total = total + checkpoint(block_nll, *part, use_reentrant=False)
        else:
            total = total + block_nll(*part)
    return total / torch.clamp(mask.sum(), min=1)


def blockwise_next_token_loss(block_size: int = 512):
    """Factory: ``next_token_loss`` without the full-vocab logits.  The
    model returns its final-norm features (``return_features=True``) and
    the head is folded into the loss one sequence block at a time; an
    MoE model's router losses are added, as in JAX."""

    def loss_fn(model, batch, generator):
        tokens = _tokens(batch)
        out = model(tokens[:, :-1], return_features=True,
                    generator=generator)
        features, aux_loss = out if isinstance(out, tuple) else (out, None)
        mask = batch.get("mask")
        xent = _blockwise_xent(features, _head_weight(model), tokens[:, 1:],
                               None if mask is None else mask[:, 1:],
                               block_size)
        if aux_loss is not None:
            return xent + aux_loss, {"xent": xent, "router_loss": aux_loss}
        return xent, {}

    return loss_fn
