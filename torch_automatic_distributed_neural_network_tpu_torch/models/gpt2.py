"""GPT-2 family configs: LayerNorm, learned positional embeddings, GELU
MLP, tied embeddings, biases on."""

from __future__ import annotations

from .transformer_core import DecoderLM, TransformerConfig


def gpt2_config(size: str = "small", **overrides) -> TransformerConfig:
    presets = {
        # name: (n_layers, d_model, n_heads)
        "small": (12, 768, 12),      # 124M
        "medium": (24, 1024, 16),    # 350M
        "large": (36, 1280, 20),     # 774M
        "xl": (48, 1600, 25),        # 1.5B
        "1p3b": (24, 2048, 16),      # 1.3B (GPT-3-style aspect)
        # tiny configs for tests / CPU
        "test": (2, 128, 4),
        "nano": (4, 256, 8),
    }
    L, d, h = presets[size]
    base = dict(
        vocab_size=50257,
        d_model=d,
        n_layers=L,
        n_heads=h,
        max_seq_len=1024,
        norm="layernorm",
        act="gelu",
        pos="learned",
        tie_embeddings=True,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def GPT2(size: str = "small", **overrides) -> DecoderLM:
    return DecoderLM(gpt2_config(size, **overrides))
