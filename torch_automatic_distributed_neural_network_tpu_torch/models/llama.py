"""Llama-style decoder configs: RMSNorm, RoPE, SwiGLU, GQA, untied
embeddings, no biases."""

from __future__ import annotations

from .transformer_core import DecoderLM, TransformerConfig


def llama_config(size: str = "8b", **overrides) -> TransformerConfig:
    presets = {
        # name: (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab)
        "8b": (32, 4096, 32, 8, 14336, 128256),
        "3b": (28, 3072, 24, 8, 8192, 128256),
        "1b": (16, 2048, 32, 8, 8192, 128256),
        # Mistral-7B-v0.1 geometry (sliding_window=4096, theta 1e6
        # applied below)
        "mistral-7b": (32, 4096, 32, 8, 14336, 32000),
        # tiny configs for tests / CPU
        "test": (2, 128, 4, 2, 384, 1024),
        "nano": (4, 256, 8, 4, 768, 32000),
    }
    L, d, h, kvh, ff, v = presets[size]
    base = dict(
        vocab_size=v,
        d_model=d,
        n_layers=L,
        n_heads=h,
        n_kv_heads=kvh,
        d_ff=ff,
        max_seq_len=8192,
        norm="rmsnorm",
        act="swiglu",
        pos="rope",
        tie_embeddings=False,
        rope_theta=500000.0,
    )
    if size == "mistral-7b":
        base.update(rope_theta=1e6, sliding_window=4096)
    base.update(overrides)
    return TransformerConfig(**base)


def Llama(size: str = "8b", **overrides) -> DecoderLM:
    return DecoderLM(llama_config(size, **overrides))
