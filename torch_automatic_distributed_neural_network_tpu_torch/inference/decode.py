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

``generate`` is the decode loop on top of it: one prefill pass over the
prompt, then one-token steps, each sampled from an explicit
``torch.Generator``; the JAX ``lax.scan`` / ``lax.while_loop`` is a
Python loop here.  An int8-weight model (``quant.quantize_for_decode``)
runs through the same code, its weights dequantized at use.

Works for the decoder families (GPT-2: layernorm / learned positions /
gelu / tied head; Llama: rmsnorm / rope / swiglu / GQA / untied head)
and MoE, whose expert MLP decodes by ``moe_decode``: ``"dense"`` runs
every expert on the chunk and combines with the renormalised top-k
gates (:func:`_moe_mlp_cached`; no capacity, so nothing drops),
``"routed"`` is the training ``moe_ffn`` on the chunk
(:func:`_moe_mlp_routed`; ``moe_capacity`` pins the training group's
slots).  Sharded decoding is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.transformer_core import embedding_lookup
from ..ops.attention import xla_attention
from ..parallel.expert import expert_mlp, moe_ffn

MOE_DECODE = ("dense", "routed")


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


def _moe_mlp_cached(mlp, h: torch.Tensor, cfg) -> torch.Tensor:
    """Dispatch-free MoE FFN for decode chunks: every expert runs on the
    chunk (``expert_mlp`` on a broadcast [B, E, T, d]) and the outputs
    combine with the router's renormalised top-k gates, as
    ``top_k_routing`` computes them where nothing drops.  E/k times the
    routed products, nothing at decode sizes."""
    B, T, d = h.shape
    up, gate, down = mlp.banks(h.dtype)
    E = up.shape[0]
    probs = torch.softmax(mlp.router(h.to(torch.float32)), dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    w = (torch.nn.functional.one_hot(topi, E).to(torch.float32)
         * gates[..., None]).sum(-2)  # [B, T, E]
    y = expert_mlp(h[:, None].expand(B, E, T, d), up, gate, down,
                   mlp.act())  # [B, E, T, d]
    return torch.einsum("betd,bte->btd", y, w.to(h.dtype))


def _moe_mlp_routed(mlp, h: torch.Tensor, cfg,
                    capacity_override: int | None = None) -> torch.Tensor:
    """The training ``moe_ffn`` on the decode chunk: each row a group of
    T tokens with its capacity derived from T, or the training group's
    (``capacity_override``), so a dropping configuration decodes as it
    trains; a one-token step has the 8-slot floor and never drops."""
    up, gate, down = mlp.banks(h.dtype)
    y, _ = moe_ffn(h, mlp.router(h.to(torch.float32)), up, down,
                   w_gate=gate, top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor, act=mlp.act(),
                   capacity=capacity_override)
    return y


def _mlp(layer, h: torch.Tensor, cfg, moe_decode: str,
         moe_capacity: int | None) -> torch.Tensor:
    """A layer's MLP on a decode chunk: the dense block, or an MoE bank by
    ``moe_decode``."""
    if not hasattr(layer.mlp, "experts_up"):
        return layer.mlp(h)
    if moe_decode == "routed":
        return _moe_mlp_routed(layer.mlp, h, cfg, moe_capacity)
    return _moe_mlp_cached(layer.mlp, h, cfg)


def check_moe_decode(moe_decode: str) -> None:
    if moe_decode not in MOE_DECODE:
        raise ValueError(f"unknown moe_decode {moe_decode!r}")


@torch.no_grad()
def forward_cached(model, tokens: torch.Tensor, cache: KVCache, *,
                   moe_decode: str = "dense",
                   moe_capacity: int | None = None,
                   all_logits: bool = False
                   ) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder on a [B, T] chunk against the cache; returns
    (logits of the chunk's last position [B, vocab] — or of every
    position [B, T, vocab] with ``all_logits=True`` — and the cache with
    its cursor advanced).  The cache tensors are updated in place.
    ``moe_decode`` / ``moe_capacity``: an MoE model's expert MLP (module
    docstring); a dense model ignores them."""
    check_moe_decode(moe_decode)
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
        x = x + _mlp(layer, layer.mlp_norm(x), cfg, moe_decode,
                     moe_capacity)

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


def model_device(model) -> torch.device:
    """The device a decoder's weights live on."""
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    raise ValueError("the model holds no tensors")


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int,
             sample: SampleConfig | None = None,
             generator: torch.Generator | None = None,
             cache_dtype=torch.bfloat16, mesh=None,
             eos_id: int | None = None, moe_decode: str = "dense",
             moe_capacity: int | None = None,
             early_stop: bool = False, return_lengths: bool = False):
    """Autoregressive generation: a prefill pass over ``prompt`` [B, P],
    then ``max_new_tokens - 1`` one-token steps.  Returns [B, P +
    max_new_tokens] int32 on the model's device.

    ``sample`` defaults to greedy; a sampled run draws from
    ``generator`` (on the model's device; None: torch's default
    generator).  ``eos_id``: once a row samples it, every later position
    of that row is ``eos_id``.  ``early_stop=True`` (needs ``eos_id``)
    ends the loop as soon as every row has sampled it, the positions
    never reached holding ``eos_id`` — the same output as the full loop.
    ``return_lengths=True`` also returns each row's valid length [B]
    int32: the prompt plus the generated tokens up to and including the
    first ``eos_id`` (``P + max_new_tokens`` for a row without one).

    ``moe_decode`` ('dense' or 'routed') decodes an MoE model's expert
    MLP (module docstring); ``moe_capacity`` pins the prefill's slots to
    the training group's, and the one-token steps derive theirs (the
    8-slot floor: they never drop).  ``mesh`` (sharded decode) is a
    later slice of the port."""
    if mesh is not None:
        raise NotImplementedError(
            "generate(mesh=...): sharded decode is not ported yet (ROADMAP "
            "Queue 1 item 3); the port decodes on one device")
    check_moe_decode(moe_decode)
    if sample is None:
        sample = SampleConfig(temperature=0.0)
    if early_stop and eos_id is None:
        raise ValueError("early_stop=True requires eos_id")
    cfg = model.cfg
    device = model_device(model)
    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.int64)
    B, P = prompt.shape
    if max_new_tokens < 1:
        out = prompt.to(torch.int32)
        if return_lengths:
            return out, torch.full((B,), P, dtype=torch.int32, device=device)
        return out
    total = P + max_new_tokens
    if cfg.pos == "learned" and total > cfg.max_seq_len:
        raise ValueError(
            f"prompt {P} + max_new_tokens {max_new_tokens} = {total} exceeds "
            f"the model's {cfg.max_seq_len} learned positions")

    cache = KVCache.init(cfg, B, total, dtype=cache_dtype, device=device)
    logits, cache = forward_cached(model, prompt, cache,
                                   moe_decode=moe_decode,
                                   moe_capacity=moe_capacity)
    tok = _sample(logits, generator, sample)
    done = (tok == eos_id if eos_id is not None
            else torch.zeros_like(tok, dtype=torch.bool))
    new = torch.full((B, max_new_tokens), -1 if eos_id is None else eos_id,
                     dtype=torch.int32, device=device)
    new[:, 0] = tok
    for step in range(1, max_new_tokens):
        if early_stop and bool(done.all()):
            break  # the rest of the buffer already holds eos_id
        logits, cache = forward_cached(model, tok[:, None].to(torch.int64),
                                       cache, moe_decode=moe_decode)
        nxt = _sample(logits, generator, sample)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        new[:, step] = nxt
        tok = nxt
    out = torch.cat([prompt.to(torch.int32), new], dim=1)
    if not return_lengths:
        return out
    if eos_id is None:
        lengths = torch.full((B,), total, dtype=torch.int32, device=device)
    else:
        is_eos = new == eos_id
        first = torch.argmax(is_eos.to(torch.int32), dim=1)
        lengths = P + torch.where(is_eos.any(dim=1), first + 1,
                                  torch.full_like(first, max_new_tokens))
    return out, lengths.to(torch.int32)
