"""KV-cached forward pass and sampling for the decoder families.

``forward_cached`` runs a chunk of tokens (a prompt chunk at prefill,
one token after) against a contiguous per-layer KV cache: it writes the
chunk's keys and values at the cache cursor, attends over everything
cached so far under the causal (and sliding-window) mask, and returns
logits.  The per-layer math is the model's own modules applied
piecewise (``make_norm``, ``SelfAttention.qkv`` / ``out_proj``,
``MLPBlock``), as in the JAX package's ``inference/decode.py``; the JAX
``lax.scan`` over stacked layers is a Python loop over the per-layer
modules, and the cache is updated in place.

Works for both decoder families (GPT-2: layernorm / learned positions /
gelu / tied head; Llama: rmsnorm / rope / swiglu / GQA / untied head).
MoE decoding is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.attention import xla_attention
from .quant import embedding_lookup


class KVCache(NamedTuple):
    """Per-layer stacked KV: [n_layers, B, S_max, kv_heads, head_dim];
    ``length`` tokens are cached."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def init(cls, cfg, batch: int, max_len: int, dtype=torch.bfloat16,
             device=None) -> "KVCache":
        shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def _cached_attention(q, k_cache, v_cache, q_pos: int, kv_len: int,
                      window=None):
    """q: [B, T, H, hd] at absolute positions q_pos..q_pos+T-1;
    k/v_cache: [B, S_max, kvH, hd] with kv_len entries valid (the current
    chunk already written).  Key j is visible to query i iff ``j <= i``
    and ``j < kv_len`` (and, windowed, ``j > i - window``)."""
    T = q.shape[1]
    S = k_cache.shape[1]
    key_idx = torch.arange(S, device=q.device)[None, :]
    q_idx = (q_pos + torch.arange(T, device=q.device))[:, None]
    mask = (key_idx <= q_idx) & (key_idx < kv_len)  # [T, S]
    if window is not None:
        mask &= key_idx > q_idx - window
    return xla_attention(q, k_cache, v_cache, causal=False,
                         mask=mask[None, None])


@torch.no_grad()
def forward_cached(model, tokens: torch.Tensor, cache: KVCache, *,
                   all_logits: bool = False
                   ) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder on a [B, T] chunk against the cache; returns
    (logits of the chunk's last position [B, vocab] — or of every
    position [B, T, vocab] with ``all_logits=True`` — and the cache with
    its cursor advanced).  The cache tensors are updated in place."""
    cfg = model.cfg
    B, T = tokens.shape
    pos0 = int(cache.length)
    dtype = cfg.dtype

    x = embedding_lookup(model.embed, tokens, dtype)
    positions = (pos0 + torch.arange(T, device=tokens.device))[None, :]
    positions = positions.expand(B, T)
    if cfg.pos == "learned":
        x = x + model.pos_embed[pos0:pos0 + T].to(dtype)[None]

    for layer, k_cache, v_cache in zip(model.layers, cache.k, cache.v):
        h = layer.attn_norm(x)
        q, k, v = layer.attn.qkv(h, positions)
        k_cache[:, pos0:pos0 + T] = k.to(k_cache.dtype)
        v_cache[:, pos0:pos0 + T] = v.to(v_cache.dtype)
        o = _cached_attention(q, k_cache, v_cache, pos0, pos0 + T,
                              window=cfg.sliding_window)
        x = x + layer.attn.out_proj(o.to(dtype))
        x = x + layer.mlp(layer.mlp_norm(x))

    x = model.final_norm(x)
    feats = (x if all_logits else x[:, -1]).to(torch.float32)
    return model.logits(feats), cache._replace(length=pos0 + T)


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    temperature: float = 1.0  # 0 -> greedy
    top_k: int = 0  # 0 -> full distribution
    top_p: float = 1.0  # nucleus: keep the smallest set with mass >= p

    def __post_init__(self):
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p} "
                f"(for greedy decoding use temperature=0)")


def _sample(logits: torch.Tensor, generator: torch.Generator | None,
            sc: SampleConfig) -> torch.Tensor:
    """[B, V] logits -> [B] int32 tokens.  Greedy takes the first
    maximum, as ``jnp.argmax`` does; otherwise top-k, then nucleus
    filtering, then one categorical draw per row from ``generator``."""
    if sc.temperature == 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    logits = logits / sc.temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if sc.top_k:
        kth = torch.sort(logits, -1).values[:, -sc.top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if sc.top_p < 1.0:
        # keep the highest-probability tokens whose cumulative mass
        # reaches p; the first token crossing the threshold is kept
        sorted_logits = torch.sort(logits, -1, descending=True).values
        probs = torch.softmax(sorted_logits, -1)
        cum = torch.cumsum(probs, -1)
        keep = cum - probs < sc.top_p  # mass BEFORE this token
        cutoff = torch.where(
            keep, sorted_logits,
            torch.tensor(float("inf"), device=logits.device)
        ).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    probs = torch.softmax(logits, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
