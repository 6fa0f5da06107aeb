"""Language-model losses with the ``AutoDistribute`` loss signature.

``loss_fn(model, batch, generator) -> (loss, aux_dict)``: the port's
counterpart of the JAX package's ``(params, batch, rng, apply_fn)``.
``model`` is the ``DecoderLM`` (its parameters in the compute dtype),
``batch`` a dict of tensors on the model's device (``input_ids`` or
``tokens`` [B, S+1], optional ``mask``), ``generator`` a CPU
``torch.Generator`` for dropout or None (deterministic).
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


def next_token_loss(model, batch, generator):
    """Causal LM: predict token t+1 from tokens <= t; ignores padding if
    an explicit ``mask`` is present."""
    tokens = _tokens(batch)
    logits = model(tokens[:, :-1], generator=generator)
    loss, denom = _shifted_xent(logits, tokens, batch.get("mask"))
    return loss, {"tokens": denom}


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
    the head is folded into the loss one sequence block at a time."""

    def loss_fn(model, batch, generator):
        tokens = _tokens(batch)
        features = model(tokens[:, :-1], return_features=True,
                         generator=generator)
        mask = batch.get("mask")
        xent = _blockwise_xent(features, _head_weight(model), tokens[:, 1:],
                               None if mask is None else mask[:, 1:],
                               block_size)
        return xent, {}

    return loss_fn
