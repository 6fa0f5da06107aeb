"""Encoder-decoder transformer for machine translation, the port of the
JAX package's ``models/transformer_mt.py``.

Transformer-base dimensions (6 + 6 layers, d 512, 8 heads, ff 2048),
pre-norm layers with biases, tanh GELU, learned positions shared by the
two stacks, and the decoder's head tied to the shared token embedding
(flax ``Embed.attend``: rounded in the compute dtype, then fp32).  The
decoder's cross-attention has Sq != Sk, so it always takes the plain
attention path (the flash kernels take self-attention only).  As in JAX,
the layers apply no dropout and recompute nothing in the backward.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.attention import attention
from .transformer_core import (
    Linear,
    MLPBlock,
    TransformerConfig,
    _linear,
    embedding_lookup,
    gathered,
    init_parameters,
    make_norm,
    tied_logits,
)


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 6  # per stack
    n_heads: int = 8
    d_ff: int = 2048
    max_seq_len: int = 256
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    def as_core(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size,
            d_model=self.d_model,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            d_ff=self.d_ff,
            max_seq_len=self.max_seq_len,
            norm="layernorm",
            act="gelu",
            pos="learned",
            dropout_rate=self.dropout_rate,
            dtype=self.dtype,
        )


class CrossAttention(nn.Module):
    """Attention of ``x`` [B, T, d] over ``memory`` [B, S, d] (queries
    from ``x``, keys and values from ``memory``), not causal."""

    causal = False

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        self.q_proj = Linear(d, cfg.n_heads * hd)
        self.k_proj = Linear(d, cfg.n_heads * hd)
        self.v_proj = Linear(d, cfg.n_heads * hd)
        self.o_proj = Linear(cfg.n_heads * hd, d)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        S = memory.shape[1]
        q = _linear(x, self.q_proj, cfg.dtype).view(B, T, cfg.n_heads, -1)
        k = _linear(memory, self.k_proj, cfg.dtype).view(B, S, cfg.n_heads, -1)
        v = _linear(memory, self.v_proj, cfg.dtype).view(B, S, cfg.n_heads, -1)
        out = attention(q, k, v, causal=self.causal, mask=mask)
        return _linear(out.flatten(-2), self.o_proj, cfg.dtype)


class SelfAttentionMT(CrossAttention):
    """Self-attention of the MT stacks: causal in the decoder, not in the
    encoder."""

    def __init__(self, cfg: TransformerConfig, causal: bool):
        super().__init__(cfg)
        self.causal = causal

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        return super().forward(x, x, mask)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.attn_norm = make_norm(cfg)
        self.attn = SelfAttentionMT(cfg, causal=False)
        self.mlp_norm = make_norm(cfg)
        self.mlp = MLPBlock(cfg)

    def forward(self, x, mask=None):
        x = x + self.attn(self.attn_norm(x), mask)
        return x + self.mlp(self.mlp_norm(x))


class DecoderLayerMT(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.attn_norm = make_norm(cfg)
        self.attn = SelfAttentionMT(cfg, causal=True)
        self.cross_norm = make_norm(cfg)
        self.cross_attn = CrossAttention(cfg)
        self.mlp_norm = make_norm(cfg)
        self.mlp = MLPBlock(cfg)

    def forward(self, x, memory, self_mask=None, cross_mask=None):
        x = x + self.attn(self.attn_norm(x), self_mask)
        x = x + self.cross_attn(self.cross_norm(x), memory, cross_mask)
        return x + self.mlp(self.mlp_norm(x))


class Seq2SeqTransformer(nn.Module):
    """``forward(src, tgt)`` -> fp32 logits [B, T, V] over the target
    vocabulary, teacher-forced (``training.losses.seq2seq_loss`` shifts
    ``tgt``)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        core = self.core = cfg.as_core()
        self.embed = nn.Parameter(torch.empty(core.vocab_size, core.d_model))
        self.pos_embed = nn.Parameter(
            torch.empty(core.max_seq_len, core.d_model))
        self.enc = nn.ModuleList(EncoderLayer(core)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = make_norm(core)
        self.dec = nn.ModuleList(DecoderLayerMT(core)
                                 for _ in range(cfg.n_layers))
        self.dec_norm = make_norm(core)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Seq2SeqTransformer":
        init_parameters(self, generator)
        return self

    def forward(self, src: torch.Tensor, tgt: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is accepted for the loss signature: the layers
        apply no dropout, as in JAX."""
        dt = self.core.dtype
        embed = gathered(self.embed)

        def embed_at(tokens):
            x = embedding_lookup(embed, tokens, dt)
            return x + self.pos_embed[:tokens.shape[1]].to(dt)[None]

        mem = embed_at(src)
        for layer in self.enc:
            mem = layer(mem)
        mem = self.enc_norm(mem)
        y = embed_at(tgt)
        for layer in self.dec:
            y = layer(y, mem)
        return tied_logits(self.dec_norm(y), embed, dt)


def TransformerMT(size: str = "base", **overrides) -> Seq2SeqTransformer:
    presets = {
        "base": dict(),
        "big": dict(d_model=1024, n_heads=16, d_ff=4096),
        "test": dict(d_model=64, n_layers=2, n_heads=4, d_ff=128,
                     vocab_size=512, max_seq_len=64),
    }
    kw = {**presets[size], **overrides}
    return Seq2SeqTransformer(Seq2SeqConfig(**kw))
