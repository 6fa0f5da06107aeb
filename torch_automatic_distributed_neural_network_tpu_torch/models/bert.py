"""BERT family: encoder-only transformers on the shared backbone, the
port of the JAX package's ``models/bert.py``.

BERT is the shared core with the other switches thrown: bidirectional
attention (``causal=False``), post-norm residual order, LayerNorm'd
embeddings (eps 1e-12), segment embeddings, exact-erf GELU, and no final
norm.  The MLM head has the HF ``BertForMaskedLM`` layout: dense d -> d,
exact GELU, LayerNorm, then the decoder tied to the token embedding
(flax ``Embed.attend``: rounded in the compute dtype, then fp32) plus an
fp32 vocab bias.  A padding ``attn_mask`` becomes a ``[B, 1, 1, S]`` key
mask, which sends ``attention_impl="auto"`` to the plain path (the flash
kernels take no mask), as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .transformer_core import (
    Linear,
    TransformerConfig,
    _linear,
    backbone_forward,
    build_backbone,
    gathered,
    init_parameters,
    make_norm,
    tied_logits,
)


def bert_config(size: str = "base", **overrides) -> TransformerConfig:
    presets = {
        # name: (n_layers, d_model, n_heads)
        "base": (12, 768, 12),    # 110M
        "large": (24, 1024, 16),  # 340M
        # tiny config for tests / CPU
        "test": (2, 128, 4),
    }
    L, d, h = presets[size]
    base = dict(
        vocab_size=30522,
        d_model=d,
        n_layers=L,
        n_heads=h,
        max_seq_len=512,
        norm="layernorm",
        norm_eps=1e-12,  # HF BertConfig.layer_norm_eps default
        act="gelu_exact",
        pos="learned",
        causal=False,
        norm_order="post",
        embed_norm=True,
        final_norm=False,
        type_vocab_size=2,
        tie_embeddings=True,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def padding_mask(attn_mask):
    """[B, S] 1/0 (or bool) keep-mask -> the attention convention
    ``[B, 1, 1, S]`` (True = attend); None passes through."""
    if attn_mask is None:
        return None
    return torch.as_tensor(attn_mask).to(torch.bool)[:, None, None, :]


class BertEncoder(nn.Module):
    """Encoder-only LM with the HF-layout masked-LM head.

    ``forward(tokens, segment_ids=None, attn_mask=None)`` -> fp32 MLM
    logits [B, S, V]; ``return_features=True`` returns the final hidden
    states instead.  ``mlm_head=False`` builds the encoder without the
    head's parameters (the classifier's encoder, as flax creates none
    there)."""

    def __init__(self, cfg: TransformerConfig, *, mlm_head: bool = True):
        super().__init__()
        self.cfg = cfg
        build_backbone(self, cfg)
        if mlm_head:
            self.mlm_dense = Linear(cfg.d_model, cfg.d_model)
            self.mlm_norm = make_norm(cfg)
            self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertEncoder":
        init_parameters(self, generator)
        if hasattr(self, "mlm_bias"):
            self.mlm_bias.zero_()
        return self

    def forward(self, tokens, segment_ids=None, attn_mask=None,
                positions=None, return_features: bool = False, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        x, _ = backbone_forward(self, cfg, tokens, positions,
                                generator=generator, segment_ids=segment_ids,
                                mask=padding_mask(attn_mask))
        if return_features:
            return x
        # HF BertForMaskedLM: transform (dense + exact gelu + LN), then
        # the decoder tied to the embedding matrix + the vocab bias
        h = F.gelu(_linear(x, self.mlm_dense, cfg.dtype), approximate="none")
        h = self.mlm_norm(h)
        return tied_logits(h, gathered(self.embed), cfg.dtype) + self.mlm_bias


class BertClassifier(nn.Module):
    """Sequence classification: the first ([CLS]) position's final
    features -> fp32 logits [B, num_classes] (HF's
    ``BertForSequenceClassification`` without the pooler's tanh)."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 2):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        self.encoder = BertEncoder(cfg, mlm_head=False)
        self.classifier = Linear(cfg.d_model, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertClassifier":
        init_parameters(self.encoder, generator)
        init_parameters(self.classifier, generator, embeddings=())
        return self

    def forward(self, tokens, segment_ids=None, attn_mask=None, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feats = self.encoder(tokens, segment_ids, attn_mask,
                             return_features=True, generator=generator)
        return self.classifier(feats[:, 0].to(torch.float32))


def Bert(size: str = "base", **overrides) -> BertEncoder:
    return BertEncoder(bert_config(size, **overrides))
