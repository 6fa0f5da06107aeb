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
slots).

Sharded decoding (``generate(mesh=)``, JAX's ``cache_partition_spec``
placement): the model is the one a plan wrapped (``executor.apply_plan``:
its weights stay sharded as trained), one process a device.  Each rank
takes its rows of the batch on the batch axes (``data``, ``fsdp``,
``expert``) and, under a ``tensor`` axis, its kv heads (the column-split
k/v projections give them); the cache holds those rows and heads only.
An FSDP2 layer is unsharded around its step of each decode pass and
resharded after it, as its forward hook would (the decode path calls
the layer's pieces, never the layer); the root's own parameters stay
unsharded for the whole call.  Under an expert strategy the routed MLP
exchanges its slots over the expert group as in training, and the dense
combine reads the banks whole.  The rows are gathered back at the end,
so every rank returns the whole batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from ..models.transformer_core import dense_weight, embedding_lookup, gathered
from ..ops.attention import xla_attention
from ..ops.paged_attention import tensor_degree
from ..parallel.expert import expert_mlp, moe_ffn

MOE_DECODE = ("dense", "routed")
BATCH_AXES = ("data", "fsdp", "expert")  # the mesh axes that split rows


class KVCache(NamedTuple):
    """Per-layer stacked KV: [n_layers, B, S_max, kv_heads, head_dim];
    ``length`` tokens are cached."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def init(cls, cfg, batch: int, max_len: int, dtype=torch.bfloat16,
             device=None, kv_heads: int | None = None) -> "KVCache":
        """Zeros for ``batch`` rows of ``max_len`` tokens; ``kv_heads``
        (default ``cfg.kv_heads``) is a tensor-parallel rank's share."""
        shape = (cfg.n_layers, batch, max_len, kv_heads or cfg.kv_heads,
                 cfg.head_dim)
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
    routed products, nothing at decode sizes.  Banks sharded over an
    expert group are read whole."""
    B, T, d = h.shape
    up, gate, down = (None if w is None else gathered(w).to(h.dtype)
                      for w in (mlp.experts_up,
                                getattr(mlp, "experts_gate", None),
                                mlp.experts_down))
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
                    capacity_override: int | None = None,
                    mesh=None) -> torch.Tensor:
    """The training ``moe_ffn`` on the decode chunk: each row a group of
    T tokens with its capacity derived from T, or the training group's
    (``capacity_override``), so a dropping configuration decodes as it
    trains; a one-token step has the 8-slot floor and never drops.
    ``mesh``: the plan's mesh, whose expert group the dispatched slots
    cross when the banks are sharded over it (``MoEMlp.expert_mesh``,
    set by an expert strategy), as in training."""
    up, gate, down = mlp.banks(h.dtype)
    sharded = mesh is not None and mlp.expert_mesh is not None
    y, _ = moe_ffn(h, mlp.router(h.to(torch.float32)), up, down,
                   w_gate=gate, top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor, act=mlp.act(),
                   capacity=capacity_override,
                   mesh=mlp.expert_mesh if sharded else None,
                   tensor_axis=mlp.expert_tensor_axis if sharded else None)
    return y


def _mlp(layer, h: torch.Tensor, cfg, moe_decode: str,
         moe_capacity: int | None, mesh=None) -> torch.Tensor:
    """A layer's MLP on a decode chunk: the dense block, or an MoE bank by
    ``moe_decode``."""
    if not hasattr(layer.mlp, "experts_up"):
        return layer.mlp(h)
    if moe_decode == "routed":
        return _moe_mlp_routed(layer.mlp, h, cfg, moe_capacity, mesh)
    return _moe_mlp_cached(layer.mlp, h, cfg)


@contextlib.contextmanager
def unsharded(module):
    """An FSDP2 module's own parameters whole for the duration (its
    all-gather), resharded after; any other module as it is.  The decode
    path calls a layer's pieces, never the layer, so FSDP2's forward
    hooks do not fire and this stands in for them."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(module, FSDPModule):
        yield module
        return
    module.unshard()
    try:
        yield module
    finally:
        module.reshard()


def cache_partition_spec(cfg, mesh,
                         batch_axes: tuple[str, ...] = BATCH_AXES,
                         head_axis: str = "tensor") -> tuple:
    """The placement of the [L, B, S, kvH, hd] cache under ``mesh`` (a
    ``DeviceMesh`` or a degrees mapping), JAX's ``PartitionSpec`` entries
    as a tuple: batch rows on the data axes of degree > 1, kv heads on
    the tensor axis when the head count divides it."""
    from ..topology import mesh_degrees

    degrees = mesh_degrees(mesh)
    present = tuple(a for a in batch_axes if degrees.get(a, 1) > 1)
    t = degrees.get(head_axis, 1)
    head_entry = head_axis if t > 1 and cfg.kv_heads % t == 0 else None
    # one axis is its name alone, as a PartitionSpec entry normalizes it
    rows = (present[0] if len(present) == 1 else present) or None
    return (None, rows, None, head_entry, None)


def vocab_weights(model) -> tuple:
    """``(token table, untied head or None)`` whole on this rank: a
    plan's vocab split gathered, once for a whole decode call."""
    head = None if model.cfg.tie_embeddings else gathered(model.lm_head)
    return gathered(model.embed), head


def _logits(model, feats: torch.Tensor, vocab) -> torch.Tensor:
    """``model.logits`` with ``vocab`` (:func:`vocab_weights`) when
    given."""
    if vocab is None:
        return model.logits(feats)
    embed, head = vocab
    if head is None:
        return feats @ dense_weight(embed, torch.float32).T
    return feats @ dense_weight(head, torch.float32)


def check_moe_decode(moe_decode: str) -> None:
    if moe_decode not in MOE_DECODE:
        raise ValueError(f"unknown moe_decode {moe_decode!r}")


@torch.no_grad()
def forward_cached(model, tokens: torch.Tensor, cache: KVCache, *,
                   moe_decode: str = "dense",
                   moe_capacity: int | None = None,
                   all_logits: bool = False, mesh=None,
                   vocab=None) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder on a [B, T] chunk against the cache; returns
    (logits of the chunk's last position [B, vocab] — or of every
    position [B, T, vocab] with ``all_logits=True`` — and the cache with
    its cursor advanced).  The cache tensors are updated in place.
    ``moe_decode`` / ``moe_capacity``: an MoE model's expert MLP (module
    docstring); a dense model ignores them.  ``mesh``: the plan's mesh of
    a wrapped model (module docstring): the chunk is this rank's rows,
    the cache its rows and kv heads, and an FSDP2 root's own parameters
    are unsharded by the caller (``generate`` does).  ``vocab``:
    :func:`vocab_weights` (``generate`` gathers a vocab split once a
    call); None reads the model's."""
    check_moe_decode(moe_decode)
    cfg = model.cfg
    B, T = tokens.shape
    pos0 = int(cache.length)
    dtype = cfg.dtype

    embed = vocab[0] if vocab is not None else gathered(model.embed)
    x = embedding_lookup(embed, tokens, dtype)
    positions = (pos0 + torch.arange(T, device=tokens.device))[None, :]
    positions = positions.expand(B, T)
    if cfg.pos == "learned":
        x = x + model.pos_embed[pos0:pos0 + T].to(dtype)[None]

    for layer, k_cache, v_cache in zip(model.layers, cache.k, cache.v):
        with unsharded(layer):
            h = layer.attn_norm(x)
            q, k, v = layer.attn.qkv(h, positions)
            k_cache[:, pos0:pos0 + T] = k.to(k_cache.dtype)
            v_cache[:, pos0:pos0 + T] = v.to(v_cache.dtype)
            o = _cached_attention(q, k_cache, v_cache, pos0, pos0 + T,
                                  window=cfg.sliding_window)
            x = x + layer.attn.out_proj(o.to(dtype))
            x = x + _mlp(layer, layer.mlp_norm(x), cfg, moe_decode,
                         moe_capacity, mesh)

    x = model.final_norm(x)
    feats = (x if all_logits else x[:, -1]).to(torch.float32)
    return _logits(model, feats, vocab), cache._replace(length=pos0 + T)


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


def _batch_rows(mesh, B: int):
    """(this rank's row slice of a batch of ``B``, whether the rows are
    split): its coordinate on the batch axes of degree > 1, data-major;
    every row on every rank when they do not divide ``B`` (JAX
    replicates such a prompt)."""
    from ..topology import mesh_degrees

    degrees = mesh_degrees(mesh)
    n, idx = 1, 0
    for axis in BATCH_AXES:
        deg = degrees.get(axis, 1)
        if deg > 1:
            n *= deg
            idx = idx * deg + mesh.get_local_rank(axis)
    if n == 1 or B % n:
        return slice(0, B), False
    r = B // n
    return slice(idx * r, (idx + 1) * r), True


def _gather_rows(mesh, local: torch.Tensor, rows: slice, B: int
                 ) -> torch.Tensor:
    """Every rank's rows of the batch, whole on each: the ranks at
    coordinate 0 of every other axis write their rows into zeros and the
    world sums them (on the host under gloo)."""
    lead = all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names
               if a not in BATCH_AXES)
    full = torch.zeros((B,) + tuple(local.shape[1:]), dtype=torch.int64,
                       device=local.device)
    if lead:
        full[rows] = local.to(torch.int64)
    return _world_sum(full).to(local.dtype)


def _world_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the world; a CUDA tensor through the host under
    gloo (a few bytes: the token ids or a count)."""
    import torch.distributed as dist

    if x.is_cuda and dist.get_backend() == "gloo":
        return _world_sum(x.cpu()).to(x.device)
    dist.all_reduce(x)
    return x


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
    8-slot floor: they never drop).

    ``mesh``: the ``DeviceMesh`` of the plan that wrapped ``model``
    (sharded decode, module docstring); every rank of it calls this with
    the same prompt and returns the whole batch.  A sampled run draws
    each rank's rows from its own ``generator``."""
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
    rows, split = slice(0, B), False
    kv_heads = cfg.kv_heads
    if mesh is not None:
        rows, split = _batch_rows(mesh, B)
        if cache_partition_spec(cfg, mesh)[3] is not None:
            kv_heads //= tensor_degree(mesh)
    with unsharded(model):
        out = _decode(model, prompt[rows], max_new_tokens, sample,
                      generator, cache_dtype, kv_heads, eos_id, moe_decode,
                      moe_capacity, early_stop, mesh, split)
    if split:
        out = _gather_rows(mesh, out, rows, B)
    if not return_lengths:
        return out
    new = out[:, P:]
    if eos_id is None:
        lengths = torch.full((B,), total, dtype=torch.int32, device=device)
    else:
        is_eos = new == eos_id
        first = torch.argmax(is_eos.to(torch.int32), dim=1)
        lengths = P + torch.where(is_eos.any(dim=1), first + 1,
                                  torch.full_like(first, max_new_tokens))
    return out, lengths.to(torch.int32)


def _decode(model, prompt, max_new_tokens, sample, generator, cache_dtype,
            kv_heads, eos_id, moe_decode, moe_capacity, early_stop, mesh,
            split: bool) -> torch.Tensor:
    """The decode loop on this rank's rows: [b, P + max_new_tokens]
    int32.  ``split``: the rows are split over ``mesh``, so ``early_stop``
    ends every rank's loop at the same step (each step's collectives
    need every rank)."""
    cfg = model.cfg
    B, P = prompt.shape
    device = prompt.device
    vocab = vocab_weights(model)
    cache = KVCache.init(cfg, B, P + max_new_tokens, dtype=cache_dtype,
                         device=device, kv_heads=kv_heads)
    logits, cache = forward_cached(model, prompt, cache,
                                   moe_decode=moe_decode,
                                   moe_capacity=moe_capacity, mesh=mesh,
                                   vocab=vocab)
    tok = _sample(logits, generator, sample)
    done = (tok == eos_id if eos_id is not None
            else torch.zeros_like(tok, dtype=torch.bool))
    new = torch.full((B, max_new_tokens), -1 if eos_id is None else eos_id,
                     dtype=torch.int32, device=device)
    new[:, 0] = tok
    for step in range(1, max_new_tokens):
        if early_stop and _all_done(done, split):
            break  # the rest of the buffer already holds eos_id
        logits, cache = forward_cached(model, tok[:, None].to(torch.int64),
                                       cache, moe_decode=moe_decode,
                                       mesh=mesh, vocab=vocab)
        nxt = _sample(logits, generator, sample)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        new[:, step] = nxt
        tok = nxt
    return torch.cat([prompt.to(torch.int32), new], dim=1)


def _all_done(done: torch.Tensor, split: bool) -> bool:
    """Whether every row has finished: on this rank, or on every rank
    when the rows are split over the ranks."""
    if not split:
        return bool(done.all())
    return int(_world_sum((~done).sum().to(torch.int64).reshape(1))) == 0
