"""Losses, optimizers and precision policies for the training step."""

from .losses import blockwise_next_token_loss, next_token_loss
from .optim import (
    GradientTransformation,
    adamw,
    adamw_cosine,
    apply_updates,
    chain,
    clip_by_global_norm,
    decay_mask,
    warmup_cosine,
)
from .precision import PRESETS, Precision, cast_floats, resolve, wrap_optimizer

__all__ = [
    "GradientTransformation", "PRESETS", "Precision", "adamw", "adamw_cosine",
    "apply_updates", "blockwise_next_token_loss", "cast_floats", "chain",
    "clip_by_global_norm", "decay_mask", "next_token_loss", "resolve",
    "warmup_cosine", "wrap_optimizer",
]
