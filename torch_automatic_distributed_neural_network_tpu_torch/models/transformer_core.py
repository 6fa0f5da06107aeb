"""Decoder-only transformer core shared by the GPT-2 and Llama families.

One config-driven module covers both: GPT-2 = LayerNorm + learned
positions + GELU MLP + tied head; Llama = RMSNorm + RoPE + SwiGLU + GQA +
untied head.  The port of the JAX package's
``models/transformer_core.py``: the config, the norms, rope, the
attention projections (split into ``qkv`` / ``out_proj`` so the cached
decode path applies them around its own attention), the MLP, the
layer, the backbone every family shares (:func:`build_backbone` and
:func:`backbone_forward`, JAX's ``apply_decoder_backbone``: token or
given input embeddings, learned positions, segment embeddings, the
layer stack with its summed aux losses, the final norm), and
:class:`DecoderLM` with the full-sequence forward.

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
from ..parallel.collectives import gather_whole, scatter_slices
from ..parallel.context import seq_offset, sequence_parallel
from ..utils.device import is_dtensor


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
    type_vocab_size: int = 0  # >0 -> segment embeddings (BERT)
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
        emb += self.type_vocab_size * d
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


def dense_weight(w, dtype) -> torch.Tensor:
    """A weight as a dense tensor in ``dtype``: a parameter is cast; a
    weight kept in another form (the int8 ``QuantizedWeight`` of
    ``inference/quant.py``) gives its own (``w.dense(dtype)``)."""
    return w.to(dtype) if isinstance(w, torch.Tensor) else w.dense(dtype)


def embedding_lookup(emb, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows ``tokens`` of an embedding in ``dtype``; a table kept in
    another form gathers its own rows (``emb.rows``), converting only
    those."""
    if isinstance(emb, torch.Tensor):
        return emb[tokens].to(dtype)
    return emb.rows(tokens, dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype: weight and bias cast
    to it (:func:`dense_weight`, as flax's ``dtype=``).  The model calls
    it as a module, so a tensor-parallel plan's hooks
    (``parallelize_module``) see its input and output."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, dense_weight(self.weight, x.dtype), bias)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """``layer`` in the compute dtype: input, weight and bias cast to it."""
    return layer(x.to(dtype))


def gathered(p):
    """A parameter as a plain tensor: a tensor-parallel ``DTensor`` (the
    plan's vocab split of the embedding or the head) all-gathered, in a
    way autograd differentiates.  A CUDA ``DTensor`` on a gloo mesh (two
    processes sharing one card: gloo moves CUDA tensors by all-reduce and
    broadcast only) is gathered by an all-reduce of its zero-padded
    shards, which is exact.  A weight kept in another form (the int8
    ``QuantizedWeight``) gives its own whole form (``p.whole()``)."""
    if not isinstance(p, torch.Tensor):
        return p.whole()
    if not is_dtensor(p):
        return p
    if p.is_cuda:
        import torch.distributed as dist

        if dist.get_backend(p.device_mesh.get_group(0)) == "gloo":
            return _GatherBySum.apply(p.to_local(), p)
    return p.full_tensor()


class _GatherBySum(torch.autograd.Function):
    """A sharded ``DTensor`` whole from its local shard: the shard written
    into zeros at its offset, summed over each mesh dim it is sharded on;
    the gradient (the same on every rank) sliced back to the shard."""

    @staticmethod
    def forward(ctx, local, p):
        import torch.distributed as dist
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        mesh = p.device_mesh
        shape, offset = compute_local_shape_and_global_offset(
            p.shape, mesh, p.placements)
        ctx.where = tuple(slice(o, o + n) for o, n in zip(offset, shape))
        full = torch.zeros(p.shape, dtype=local.dtype, device=local.device)
        full[ctx.where] = local
        for dim, placement in enumerate(p.placements):
            if placement.is_shard():
                dist.all_reduce(full, group=mesh.get_group(dim))
        return full

    @staticmethod
    def backward(ctx, g):
        return g[ctx.where], None


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
        self.q_proj = Linear(cfg.d_model, cfg.n_heads * hd, bias=bias)
        self.k_proj = Linear(cfg.d_model, cfg.kv_heads * hd, bias=bias)
        self.v_proj = Linear(cfg.d_model, cfg.kv_heads * hd, bias=bias)
        self.o_proj = Linear(cfg.n_heads * hd, cfg.d_model, bias=bias)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projected (and rope-rotated) q [B, T, H, hd] and k, v
        [B, T, kvH, hd] for a chunk at ``positions`` [B, T].  Under
        tensor parallelism the projections give this rank's columns:
        H and kvH are its local head counts, read from their width."""
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        q = _linear(x, self.q_proj, cfg.dtype).view(B, T, -1, hd)
        k = _linear(x, self.k_proj, cfg.dtype).view(B, T, -1, hd)
        v = _linear(x, self.v_proj, cfg.dtype).view(B, T, -1, hd)
        if cfg.pos == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def out_proj(self, out: torch.Tensor) -> torch.Tensor:
        """[B, T, H, hd] attention output -> [B, T, d]."""
        return _linear(out.flatten(-2), self.o_proj, self.cfg.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """``mask``: [B, 1|H, 1|T, T] boolean, True = attend (a padding
        mask sends ``impl="auto"`` to the plain path, as in JAX)."""
        cfg = self.cfg
        q, k, v = self.qkv(x, positions)
        out = attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                        mask=mask, impl=cfg.attention_impl)
        return self.out_proj(out)


class MLPBlock(nn.Module):
    """The gelu / SwiGLU feed-forward."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        bias = cfg.norm == "layernorm"
        if cfg.act == "swiglu":
            self.gate_proj = Linear(cfg.d_model, cfg.ff_dim, bias=bias)
        self.up_proj = Linear(cfg.d_model, cfg.ff_dim, bias=bias)
        self.down_proj = Linear(cfg.ff_dim, cfg.d_model, bias=bias)

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


def _dropout(x: torch.Tensor, rate: float, seed: int | None,
             shard: tuple[int, int] | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate), from a generator seeded with ``seed``
    (None: deterministic, no dropout).  A seed, not a generator, crosses
    the layer's checkpoint, so the recompute draws the same mask.
    ``shard`` ``(n, i)``: ``x`` is slice i of n of the sequence (dim 1),
    and takes that slice of the whole sequence's mask."""
    if not rate or seed is None:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    shape = list(x.shape)
    if shard is not None:
        shape[1] *= shard[0]
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    if shard is not None:
        keep = keep.narrow(1, shard[1] * x.shape[1], x.shape[1])
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class DecoderLayer(nn.Module):
    """Attention + MLP block, pre-norm (GPT-2, Llama) or post-norm.
    ``mlp_cls`` swaps the feed-forward (``models/moe.py``'s routed
    ``MoEMlp``): an MLP returning ``(h, aux)`` makes the layer return
    ``(x, aux)``."""

    def __init__(self, cfg: TransformerConfig, mlp_cls=MLPBlock):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = make_norm(cfg)
        self.attn = SelfAttention(cfg)
        self.mlp_norm = make_norm(cfg)
        self.mlp = mlp_cls(cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                seeds: tuple[int, int] | None = None,
                mask: torch.Tensor | None = None):
        """``seeds``: the two dropout seeds (attention, MLP), or None;
        ``mask``: the attention's key mask, or None."""
        cfg = self.cfg
        post = cfg.norm_order == "post"
        s_attn, s_mlp = seeds or (None, None)
        sp = sequence_parallel(self)
        shard = None if sp is None else (
            sp.sp_degree, sp.mesh.get_local_rank("tensor"))
        h = x if post else self.attn_norm(x)
        h = _dropout(self.attn(h, positions, mask), cfg.dropout_rate, s_attn,
                     shard)
        x = x + h
        if post:
            x = self.attn_norm(x)
        h = x if post else self.mlp_norm(x)
        h, aux = self.mlp(h), None
        if isinstance(h, tuple):
            h, aux = h
        h = _dropout(h, cfg.dropout_rate, s_mlp, shard)
        out = x + h
        if post:
            out = self.mlp_norm(out)
        return out if aux is None else (out, aux)


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


def build_backbone(mod: nn.Module, cfg: TransformerConfig,
                   layer_cls=DecoderLayer, *, token_embed: bool = True) -> None:
    """Register the shared backbone's parameters on ``mod``, with the
    names every family shares: ``embed`` (unless ``token_embed`` is
    False: continuous inputs, ViT, have no token table), ``pos_embed``,
    ``seg_embed``, ``embed_norm``, ``layers`` and ``final_norm``, each
    where the config has it."""
    if token_embed:
        mod.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
    if cfg.pos == "learned":
        mod.pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model))
    if cfg.type_vocab_size:
        mod.seg_embed = nn.Parameter(
            torch.empty(cfg.type_vocab_size, cfg.d_model))
    if cfg.embed_norm:
        mod.embed_norm = make_norm(cfg)
    mod.layers = nn.ModuleList(layer_cls(cfg) for _ in range(cfg.n_layers))
    if cfg.final_norm:
        mod.final_norm = make_norm(cfg)


@torch.no_grad()
def init_parameters(mod: nn.Module, generator: torch.Generator,
                    embeddings=("embed", "pos_embed", "seg_embed")) -> None:
    """The JAX package's initializers on ``mod``: N(0, 0.02) for each
    parameter of ``mod`` named in ``embeddings`` that it has, in that
    order, then lecun-normal linear weights (std 1/sqrt(fan_in)), zero
    biases and unit norm scales, module by module."""
    for name in embeddings:
        p = getattr(mod, name, None)
        if isinstance(p, torch.Tensor):
            p.normal_(0.0, 0.02, generator=generator)
    for sub in mod.modules():
        if isinstance(sub, nn.Linear):
            sub.weight.normal_(0.0, 1.0 / math.sqrt(sub.in_features),
                               generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, (LayerNorm, RMSNorm)):
            sub.scale.fill_(1.0)
            if isinstance(sub, LayerNorm):
                sub.bias.zero_()


def layer_seeds(cfg: TransformerConfig, generator, n: int):
    """The two dropout seeds of each of ``n`` layers, drawn in order from
    ``generator``; None without dropout or without a generator."""
    if not cfg.dropout_rate or generator is None:
        return [None] * n
    return [tuple(int(s) for s in torch.randint(0, 2**62, (2,),
                                                generator=generator))
            for _ in range(n)]


def run_layers(layers, cfg: TransformerConfig, x, positions, seeds, mask,
               remat_layers: bool | None = None):
    """``x`` through ``layers`` in order (all of a model's, or one
    pipeline stage's), each recomputed in the backward under
    ``remat_layers`` (default ``cfg.remat``) when gradients are on.
    ``seeds``: each layer's dropout seeds (or None).  Returns ``(x,
    aux)``, aux the fp32 sum of the layers' aux losses."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    use_remat = cfg.remat if remat_layers is None else remat_layers
    for layer, layer_seeds_ in zip(layers, seeds):
        if use_remat and torch.is_grad_enabled():
            out = remat(layer, x, positions, layer_seeds_, mask,
                        policy=cfg.remat_policy)
        else:
            out = layer(x, positions, layer_seeds_, mask)
        if isinstance(out, tuple):
            x, layer_aux = out
            aux = aux + layer_aux
        else:
            x = out
    return x, aux


def backbone_forward(mod: nn.Module, cfg: TransformerConfig, tokens,
                     positions=None, *, generator=None, segment_ids=None,
                     inputs_embeds=None, mask=None, trunk=None):
    """The shared body (JAX ``apply_decoder_backbone`` up to the head):
    embed -> layer stack (each layer recomputed in the backward under
    ``cfg.remat``) -> final norm.  Returns ``(features, aux)``: the
    features [B, S, d] in ``cfg.dtype`` and the fp32 sum of the layers'
    aux losses (MoE layers return ``(x, aux)``; zero for dense layers).

    ``segment_ids`` [B, S] add the segment embeddings (``cfg.type_vocab_size
    > 0``; zeros when None); ``inputs_embeds`` [B, S, d] take the token
    embedding's place (ViT's patches); ``mask`` is the attention's key
    mask (BERT's padding, [B, 1, 1, S]); ``generator`` (a CPU
    generator) draws the dropout seeds, None is deterministic.
    ``trunk(x, positions, generator, mask)`` replaces the layer stack
    (the pipeline's stages, ``parallel/pipeline.py``).

    Under context parallelism (``parallel/context.py``) the tokens are
    this rank's slice of the sequence: the default positions, and the
    learned position rows, start at its offset.  Under Megatron-SP the
    layer stack runs on this rank's slice of the (local) sequence,
    scattered after the embeddings and gathered before the final norm;
    the positions are the whole sequence's."""
    if inputs_embeds is not None:
        if tokens is not None:
            raise ValueError("pass tokens or inputs_embeds, not both")
        x = inputs_embeds.to(cfg.dtype)
    else:
        x = embedding_lookup(gathered(mod.embed), tokens, cfg.dtype)
    B, S = x.shape[:2]
    offset = seq_offset(S)
    if positions is None:
        positions = (offset + torch.arange(S, device=x.device))[None].expand(
            B, S)
    if cfg.pos == "learned":
        x = x + mod.pos_embed[offset:offset + S].to(cfg.dtype)[None]
    if cfg.type_vocab_size:
        if segment_ids is None:
            segment_ids = torch.zeros((B, S), dtype=torch.long,
                                      device=x.device)
        x = x + embedding_lookup(mod.seg_embed, segment_ids.long(),
                                 cfg.dtype)
    if cfg.embed_norm:
        x = mod.embed_norm(x)
    sp = sequence_parallel(mod)
    if sp is not None:
        if S % sp.sp_degree:
            raise ValueError(
                f"Megatron-SP splits the sequence over tensor "
                f"{sp.sp_degree}: {S} tokens do not divide; pass "
                f"AutoDistribute(megatron_sp=False)")
        x = scatter_slices(x, sp.tensor_group)
    if trunk is not None:
        x = trunk(x, positions, generator, mask)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = run_layers(mod.layers, cfg, x, positions,
                            layer_seeds(cfg, generator, len(mod.layers)),
                            mask)
    if sp is not None:
        x = gather_whole(x, sp.tensor_group)
    if cfg.final_norm:
        x = mod.final_norm(x)
    return x, aux


def tied_logits(x: torch.Tensor, embed, dtype) -> torch.Tensor:
    """flax ``Embed.attend``: features and embedding both in ``dtype``,
    the product rounded to it, then fp32."""
    return F.linear(x.to(dtype), dense_weight(embed, dtype)).to(torch.float32)


class DecoderLM(nn.Module):
    """Causal language model: token embedding, learned positions
    (GPT-2), per-layer modules, final norm, and a tied or untied head.
    :meth:`forward` runs a full sequence; the cached decode passes live
    in ``inference/decode.py`` (``forward_cached``) and the serving
    engine's decode step.  ``layer_cls`` is the layer a subclass stacks
    (``models/moe.py``'s routed layer)."""

    layer_cls = DecoderLayer

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        build_backbone(self, cfg, self.layer_cls)
        if not cfg.tie_embeddings:
            # [d, V], the JAX package's lm_head kernel layout
            self.lm_head = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights from ``generator``, with the JAX package's
        initializers (:func:`init_parameters`; the untied head
        lecun-normal)."""
        init_parameters(self, generator)
        if not self.cfg.tie_embeddings:
            self.lm_head.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model),
                                 generator=generator)
        return self

    def logits(self, feats: torch.Tensor) -> torch.Tensor:
        """fp32 logits of fp32 features through the tied or untied head:
        the decode path's head (the training forward's tied head rounds
        in ``cfg.dtype``, see :meth:`forward`).  An int8 head or
        embedding is dequantized to fp32 first, as in the JAX decode
        path."""
        if self.cfg.tie_embeddings:
            return feats @ dense_weight(gathered(self.embed), torch.float32).T
        return feats @ dense_weight(gathered(self.lm_head), torch.float32)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward's head: the tied one is flax
        ``Embed.attend`` (:func:`tied_logits`); the untied one an fp32
        product."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            return tied_logits(x, gathered(self.embed), cfg.dtype)
        return x.to(torch.float32) @ dense_weight(gathered(self.lm_head),
                                                  torch.float32)

    def forward(self, tokens: torch.Tensor | None,
                positions: torch.Tensor | None = None,
                return_features: bool = False, *,
                generator: torch.Generator | None = None,
                segment_ids=None, inputs_embeds=None, head=None,
                mask=None, trunk=None) -> torch.Tensor:
        """Logits [B, S, V] fp32 of tokens [B, S], or with
        ``return_features`` the final-norm features [B, S, d] in
        ``cfg.dtype``.  ``segment_ids``, ``inputs_embeds``, ``mask`` and
        ``trunk`` go to :func:`backbone_forward`; ``head(features,
        embed)`` replaces the tied or untied head (``embed`` the token
        table)."""
        x, _ = backbone_forward(self, self.cfg, tokens, positions,
                                generator=generator, segment_ids=segment_ids,
                                inputs_embeds=inputs_embeds, mask=mask,
                                trunk=trunk)
        if return_features:
            return x
        if head is not None:
            return head(x, gathered(self.embed))
        return self._head(x)
