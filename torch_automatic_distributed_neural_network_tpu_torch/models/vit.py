"""Vision Transformer family on the shared encoder core, the port of the
JAX package's ``models/vit.py``.

The patch embedding is an unfold and one linear layer (one
[B*N, p*p*C] x [p*p*C, d] product); a learned [CLS] token goes in row 0,
learned positions cover [CLS] + patches, and the rest is the shared
bidirectional pre-norm core (``causal=False``, exact-erf GELU, final
LayerNorm) entered through ``inputs_embeds``.  The classifier runs in
fp32 on row 0.

Images are **[B, H, W, C]** (channels last), the JAX package's layout,
not torch's NCHW habit, so one batch feeds both packages;
:func:`unfold_patches` keeps JAX's pixel order (ph, pw, c) inside each
row-major patch.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .transformer_core import (
    Linear,
    TransformerConfig,
    _linear,
    backbone_forward,
    build_backbone,
    init_parameters,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    core: TransformerConfig
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def num_params(self) -> int:
        """The core's analytic count with its token embedding (and an
        untied head, neither built here) swapped for the patch
        projection, the [CLS] token and the classifier (bias-free, as
        every family counts)."""
        c = self.core
        d = c.d_model
        emb = c.vocab_size * d * (1 if c.tie_embeddings else 2)
        return (c.num_params() - emb
                + self.patch_size ** 2 * self.channels * d  # patch_proj
                + d                                         # cls_token
                + d * self.num_classes)                     # classifier


def vit_config(size: str = "base", *, image_size: int = 224,
               patch_size: int = 16, num_classes: int = 1000,
               **overrides) -> ViTConfig:
    presets = {
        # name: (n_layers, d_model, n_heads)
        "base": (12, 768, 12),    # ViT-B/16: 86M
        "large": (24, 1024, 16),  # ViT-L/16: 307M
        # tiny config for tests / CPU
        "test": (2, 128, 4),
    }
    L, d, h = presets[size]
    base = dict(
        vocab_size=1,  # unused: inputs are patch embeddings
        d_model=d,
        n_layers=L,
        n_heads=h,
        norm="layernorm",
        act="gelu_exact",
        pos="learned",
        causal=False,
        norm_order="pre",
        final_norm=True,
        tie_embeddings=False,
        max_seq_len=(image_size // patch_size) ** 2 + 1,  # +1 CLS
    )
    base.update(overrides)
    return ViTConfig(core=TransformerConfig(**base), image_size=image_size,
                     patch_size=patch_size, num_classes=num_classes)


def unfold_patches(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, p*p*C]: row-major patches, pixel order
    (ph, pw, c) inside each patch, as in the JAX package."""
    p = patch_size
    b, hh, ww, c = images.shape
    nh, nw = hh // p, ww // p
    x = images.reshape(b, nh, p, nw, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, nh * nw, p * p * c)


class ViTEncoder(nn.Module):
    """images [B, H, W, C] -> classification logits [B, num_classes] fp32
    (or the final hidden states with ``return_features=True``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        core, d = cfg.core, cfg.core.d_model
        self.patch_proj = Linear(cfg.patch_size ** 2 * cfg.channels, d)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        build_backbone(self, core, token_embed=False)
        self.classifier = Linear(d, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ViTEncoder":
        init_parameters(self, generator, embeddings=("cls_token", "pos_embed"))
        return self

    def forward(self, images: torch.Tensor, return_features: bool = False,
                *, generator: torch.Generator | None = None) -> torch.Tensor:
        cfg, core = self.cfg, self.cfg.core
        b = images.shape[0]
        x = unfold_patches(torch.as_tensor(images).to(core.dtype),
                           cfg.patch_size)
        x = _linear(x, self.patch_proj, core.dtype)
        cls = self.cls_token.to(core.dtype).expand(b, 1, core.d_model)
        x = torch.cat([cls, x], dim=1)
        feats, _ = backbone_forward(self, core, None, generator=generator,
                                    inputs_embeds=x)
        if return_features:
            return feats
        return self.classifier(feats[:, 0].to(torch.float32))


def ViT(size: str = "base", **kw) -> ViTEncoder:
    return ViTEncoder(vit_config(size, **kw))
