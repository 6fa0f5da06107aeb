"""The MNIST example's 3-layer MLP, the port of the JAX package's
``models/mlp.py``: fp32 linear layers ``dense_0`` ... with ReLU between
them, on inputs flattened to [B, -1]."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .transformer_core import Linear, init_parameters


class MLP(nn.Module):
    def __init__(self, features: Sequence[int] = (512, 256, 10),
                 in_features: int = 784):
        """``in_features``: the flattened input width (flax infers it at
        init; MNIST's 28 x 28 x 1 by default)."""
        super().__init__()
        self.features = tuple(features)
        widths = (in_features, *self.features)
        self.dense = nn.ModuleList(Linear(a, b)
                                   for a, b in zip(widths, widths[1:]))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MLP":
        init_parameters(self, generator, embeddings=())
        return self

    def forward(self, x: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is accepted for the loss signature (no dropout)."""
        x = torch.as_tensor(x)
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        for i, layer in enumerate(self.dense):
            x = layer(x)
            if i < len(self.dense) - 1:
                x = torch.relu(x)
        return x
