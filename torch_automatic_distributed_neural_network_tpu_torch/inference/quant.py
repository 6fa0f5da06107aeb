"""int8 storage for the paged KV pool, with per-(token, head) scales.

The KV part of the JAX package's ``inference/quant.py``.  A quantized
leaf is a ``{"q": int8, "scale": fp32}`` dict: symmetric int8 with one
fp32 scale per channel the scheme reduces over, ``scale = max|x| / 127``
(floored at 1e-8 / 127), ``q = clip(round(x / scale), -127, 127)``.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the same
fp32 inputs quantize to the same payloads.

KV tensors reduce over head_dim only (their last axis), so each token of
each head requantizes independently when it is written into a paged
block: freeing or reusing a block needs no scale bookkeeping.
"""

from __future__ import annotations

import torch


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _quantize(leaf: torch.Tensor, reduce_dims: tuple[int, ...]) -> dict:
    """Symmetric int8 with per-channel scales over ``reduce_dims``."""
    w = leaf.to(torch.float32)
    amax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_leaf(x: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"q", "scale"} -> dense tensor in ``dtype``."""
    return (x["q"].to(torch.float32) * x["scale"]).to(dtype)


def dequantize_tree(tree, dtype=torch.bfloat16):
    """Replace every quantized leaf in a (sub)tree with its dense form."""
    if is_quantized_leaf(tree):
        return dequantize_leaf(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


def quantize_kv(x: torch.Tensor) -> dict:
    """int8 KV storage with per-token-per-head scales.

    ``x`` is any KV tensor whose LAST axis is head_dim (a [.., kvH, hd]
    cache block, a single written token, a whole pooled cache); the
    scale reduces over head_dim only."""
    return _quantize(x, (x.dim() - 1,))


def dequantize_kv(qkv: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"q", "scale"} KV leaf -> dense [.., kvH, hd] in ``dtype``."""
    return dequantize_leaf(qkv, dtype)


def kv_leaf_parts(x):
    """``(payload, scale | None)`` view of a KV-pool leaf: the storage
    contract the paged-attention kernel reads in-kernel (the int8 payload
    and its scales as separate operands, multiplied on load)."""
    if is_quantized_leaf(x):
        return x["q"], x["scale"]
    return x, None


def embedding_lookup(emb, tokens: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Gather-then-dequantize: only the looked-up rows convert."""
    if is_quantized_leaf(emb):
        rows = emb["q"][tokens].to(torch.float32)
        return (rows * emb["scale"][tokens]).to(dtype)
    return emb[tokens].to(dtype)
