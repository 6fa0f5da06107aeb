"""Decoder-only transformer core shared by the GPT-2 and Llama families.

One config-driven module covers both: GPT-2 = LayerNorm + learned
positions + GELU MLP + tied head; Llama = RMSNorm + RoPE + SwiGLU + GQA +
untied head.  The port of the JAX package's
``models/transformer_core.py``: the config, the norms, rope, the
attention projections (split into ``qkv`` / ``out_proj`` so the cached
decode path applies them around its own attention), the MLP, the
layer, and :class:`DecoderLM` with the full-sequence forward
(``apply_decoder_backbone`` for tokens).

Parameters are fp32; ``cfg.dtype`` is the compute dtype.  Each
projection casts its input and weights to it (as flax's ``dtype=``
does), and the norms compute their statistics in fp32 and return
``cfg.dtype``.  Linear weights use ``nn.Linear``'s ``[out, in]`` layout;
``interop.py`` maps the JAX kernels onto it.  The JAX ``nn.scan`` over
stacked layers is one module per layer here (``scan_layers`` is kept
for the config's sake and changes nothing).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int | None = None  # None -> MHA; < n_heads -> GQA
    d_ff: int | None = None  # None -> 4*d_model (gelu) / 8/3*d_model (swiglu)
    max_seq_len: int = 1024
    norm: Literal["layernorm", "rmsnorm"] = "layernorm"
    norm_eps: float = 1e-5
    # 'gelu_exact' is the erf formulation; plain 'gelu' is the tanh
    # approximation (GPT-2's gelu_new)
    act: Literal["gelu", "gelu_exact", "swiglu"] = "gelu"
    pos: Literal["learned", "rope"] = "learned"
    # False -> bidirectional self-attention (encoder families)
    causal: bool = True
    # Mistral-style sliding-window attention: position q attends keys in
    # (q - window, q].  None = full causal.
    sliding_window: int | None = None
    # 'post' = original-transformer/BERT residual order (norm after the
    # residual add); 'pre' = GPT-2/Llama
    norm_order: Literal["pre", "post"] = "pre"
    embed_norm: bool = False  # a norm on the embeddings (BERT)
    final_norm: bool = True  # post-norm stacks end already normalized
    tie_embeddings: bool = True
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay fp32
    attention_impl: str = "auto"  # ops.attention.attention's impl
    scan_layers: bool = True  # accepted for the JAX configs; no effect
    # recompute each layer in the backward: 'dots' keeps the matrix
    # products' outputs, 'nothing' recomputes the whole layer
    remat: bool = True
    remat_policy: Literal["dots", "nothing"] = "dots"
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.sliding_window is not None:
            if not self.causal:
                raise ValueError(
                    "sliding_window requires causal=True (a windowed "
                    "bidirectional encoder would run full attention)")
            if self.sliding_window < 1:
                raise ValueError(
                    f"sliding_window must be >= 1, got {self.sliding_window}")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.act == "swiglu":
            # Llama convention: 2/3 * 4d rounded to a multiple of 256
            d = int(8 * self.d_model / 3)
            return (d + 255) // 256 * 256
        return 4 * self.d_model

    def num_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, f, L, v = self.d_model, self.ff_dim, self.n_layers, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.kv_heads * hd) + (
            self.n_heads * hd) * d
        mlp = (3 if self.act == "swiglu" else 2) * d * f
        norms = (2 * d) * L + (d if self.final_norm else 0) + (
            d if self.embed_norm else 0)
        emb = v * d * (1 if self.tie_embeddings else 2)
        pos = self.max_seq_len * d if self.pos == "learned" else 0
        return L * (attn + mlp) + norms + emb + pos


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``'s numerics: fp32 statistics with the fast
    variance ``E[x^2] - E[x]^2`` (clipped at 0), output in ``dtype``."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``'s numerics: ``x * rsqrt(E[x^2] + eps) * scale``
    in fp32, output in ``dtype``."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        ms = (xf * xf).mean(-1, keepdim=True)
        return (xf * (torch.rsqrt(ms + self.eps) * self.scale)).to(self.dtype)


def make_norm(cfg: TransformerConfig) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, cfg.norm_eps, cfg.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """``layer`` in the compute dtype: input, weight and bias cast to it."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding on [B, S, H, D] (rotate-half form); the
    frequencies are computed in fp32 numpy, as the JAX package does."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class SelfAttention(nn.Module):
    """Self-attention over a full sequence (:meth:`forward`); the decode
    path applies its pieces around its own attention: ``qkv``
    (projections + rope) and ``out_proj``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        hd, bias = cfg.head_dim, cfg.norm == "layernorm"
        self.q_proj = nn.Linear(cfg.d_model, cfg.n_heads * hd, bias=bias)
        self.k_proj = nn.Linear(cfg.d_model, cfg.kv_heads * hd, bias=bias)
        self.v_proj = nn.Linear(cfg.d_model, cfg.kv_heads * hd, bias=bias)
        self.o_proj = nn.Linear(cfg.n_heads * hd, cfg.d_model, bias=bias)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projected (and rope-rotated) q [B, T, H, hd] and k, v
        [B, T, kvH, hd] for a chunk at ``positions`` [B, T]."""
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        q = _linear(x, self.q_proj, cfg.dtype).view(B, T, cfg.n_heads, hd)
        k = _linear(x, self.k_proj, cfg.dtype).view(B, T, cfg.kv_heads, hd)
        v = _linear(x, self.v_proj, cfg.dtype).view(B, T, cfg.kv_heads, hd)
        if cfg.pos == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def out_proj(self, out: torch.Tensor) -> torch.Tensor:
        """[B, T, H, hd] attention output -> [B, T, d]."""
        return _linear(out.flatten(-2), self.o_proj, self.cfg.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self.qkv(x, positions)
        out = attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                        impl=cfg.attention_impl)
        return self.out_proj(out)


class MLPBlock(nn.Module):
    """The gelu / SwiGLU feed-forward."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        bias = cfg.norm == "layernorm"
        if cfg.act == "swiglu":
            self.gate_proj = nn.Linear(cfg.d_model, cfg.ff_dim, bias=bias)
        self.up_proj = nn.Linear(cfg.d_model, cfg.ff_dim, bias=bias)
        self.down_proj = nn.Linear(cfg.ff_dim, cfg.d_model, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        if self.cfg.act == "swiglu":
            h = F.silu(_linear(x, self.gate_proj, dt)) * _linear(
                x, self.up_proj, dt)
        else:
            h = F.gelu(_linear(x, self.up_proj, dt),
                       approximate=("none" if self.cfg.act == "gelu_exact"
                                    else "tanh"))
        return _linear(h, self.down_proj, dt)


def _dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate), from a generator seeded with ``seed``
    (None: deterministic, no dropout).  A seed, not a generator, crosses
    the layer's checkpoint, so the recompute draws the same mask."""
    if not rate or seed is None:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class DecoderLayer(nn.Module):
    """Attention + MLP block, pre-norm (GPT-2, Llama) or post-norm."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = make_norm(cfg)
        self.attn = SelfAttention(cfg)
        self.mlp_norm = make_norm(cfg)
        self.mlp = MLPBlock(cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                seeds: tuple[int, int] | None = None) -> torch.Tensor:
        """``seeds``: the two dropout seeds (attention, MLP), or None."""
        cfg = self.cfg
        post = cfg.norm_order == "post"
        s_attn, s_mlp = seeds or (None, None)
        h = x if post else self.attn_norm(x)
        h = _dropout(self.attn(h, positions), cfg.dropout_rate, s_attn)
        x = x + h
        if post:
            x = self.attn_norm(x)
        h = x if post else self.mlp_norm(x)
        h = _dropout(self.mlp(h), cfg.dropout_rate, s_mlp)
        out = x + h
        if post:
            out = self.mlp_norm(out)
        return out


# ``checkpoint_dots_with_no_batch_dims``: keep the outputs of the matrix
# products without batch dimensions (every projection), recompute the
# rest, batched attention products included
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args, policy: Literal["dots", "nothing"] = "dots"):
    """``fn(*args)`` with its activations recomputed in the backward
    (``jax.checkpoint``): ``policy`` 'dots' keeps the matrix products'
    outputs, 'nothing' recomputes everything.  Changes memory, never
    numbers."""
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
                  if policy == "dots" else None)
    kw = {"context_fn": context_fn} if context_fn else {}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


class DecoderLM(nn.Module):
    """Causal language model: token embedding, learned positions
    (GPT-2), per-layer modules, final norm, and a tied or untied head.
    :meth:`forward` runs a full sequence; the cached decode passes live
    in ``inference/decode.py`` (``forward_cached``) and the serving
    engine's decode step."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        if cfg.pos == "learned":
            self.pos_embed = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model))
        if cfg.embed_norm:
            self.embed_norm = make_norm(cfg)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.n_layers))
        if cfg.final_norm:
            self.final_norm = make_norm(cfg)
        if not cfg.tie_embeddings:
            # [d, V], the JAX package's lm_head kernel layout
            self.lm_head = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights from ``generator``, with the JAX package's
        initializers: N(0, 0.02) embeddings, lecun-normal projections
        (std 1/sqrt(fan_in)), zero biases, unit norm scales."""
        self.embed.normal_(0.0, 0.02, generator=generator)
        if self.cfg.pos == "learned":
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (LayerNorm, RMSNorm)):
                mod.scale.fill_(1.0)
                if isinstance(mod, LayerNorm):
                    mod.bias.zero_()
        if not self.cfg.tie_embeddings:
            self.lm_head.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model),
                                 generator=generator)
        return self

    def logits(self, feats: torch.Tensor) -> torch.Tensor:
        """fp32 logits of fp32 features through the tied or untied head:
        the decode path's head (the training forward's tied head rounds
        in ``cfg.dtype``, see :meth:`forward`)."""
        if self.cfg.tie_embeddings:
            return feats @ self.embed.to(torch.float32).T
        return feats @ self.lm_head.to(torch.float32)

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                return_features: bool = False, *,
                generator: torch.Generator | None = None,
                segment_ids=None, inputs_embeds=None,
                head=None) -> torch.Tensor:
        """Logits [B, S, V] fp32 of tokens [B, S], or with
        ``return_features`` the final-norm features [B, S, d] in
        ``cfg.dtype``.  ``generator`` (a CPU generator) draws the dropout
        seeds; None is deterministic.

        The tied head is flax ``Embed.attend``: features and embedding
        both in ``cfg.dtype``, the product rounded to it, then fp32.  The
        untied head is an fp32 product."""
        if segment_ids is not None or inputs_embeds is not None or (
                head is not None):
            raise NotImplementedError(
                "segment_ids, inputs_embeds and head= serve the BERT and "
                "ViT families, not ported yet (ROADMAP Queue 1 item 6)")
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed[tokens].to(cfg.dtype)
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
        if cfg.pos == "learned":
            x = x + self.pos_embed[:S].to(cfg.dtype)[None]
        if cfg.embed_norm:
            x = self.embed_norm(x)
        for layer in self.layers:
            seeds = None
            if cfg.dropout_rate and generator is not None:
                seeds = tuple(int(s) for s in torch.randint(
                    0, 2**62, (2,), generator=generator))
            if cfg.remat and torch.is_grad_enabled():
                x = remat(layer, x, positions, seeds, policy=cfg.remat_policy)
            else:
                x = layer(x, positions, seeds)
        if cfg.final_norm:
            x = self.final_norm(x)
        if return_features:
            return x
        if cfg.tie_embeddings:
            return F.linear(x.to(cfg.dtype), self.embed.to(cfg.dtype)).to(
                torch.float32)
        return x.to(torch.float32) @ self.lm_head.to(torch.float32)
