"""Serving engine: one slot-padded decode step over a paged KV pool.

One fixed-shape decode step serves every live request at once.  The
batch axis is ``n_slots`` *slots*, not requests: a slot is either bound
to a running request or inactive (null block table, masked sampling).
Each call advances EVERY decoding request by one token; between calls
the scheduler evicts finished requests and admits queued ones.

Per-layer math is the model's own modules applied piecewise — the same
discipline as ``decode.forward_cached``, from which the decode step
differs in three ways:

- positions/lengths are PER-SLOT vectors (requests at different depths
  share a step), so rope angles and the attention mask row vary by slot;
- KV reads/writes go through the paged pool: each layer writes its new
  token (``kv_pool.write_token``) BEFORE attending, in place;
- sampled tokens are masked to 0 on inactive slots.

The decode-step attention is ``attention_impl``: ``"paged"`` (default)
runs the paged-attention kernel, which reads the block table itself
(ops/paged_attention.py); ``"dense"`` keeps the reference
``gather_blocks`` + ``xla_attention`` path the kernel is held against.

Prefill runs ``forward_cached`` on a dense bf16 temp cache (bf16 whatever
the pool's type, as in the JAX engine, so the prefilled keys round the
same way), then copies the rows into the request's blocks.  By default
prefill is CHUNKED: the prompt streams through fixed [1, C] chunks
against a [1, max_len] temp cache (C snapped to a divisor of max_len),
one chunk per engine step per prefilling slot, interleaved with decode.
``prefill_chunk=None`` is the single-shot prefill (one [1, P] pass at
admission).  In int8 mode each chunk's fresh rows round-trip through the
pool's (q, scale) form before later chunks attend to them, and the commit
scatters those exact pairs.

The kernel takes head dims 32, 64, 96 and 128: on a CUDA device the
engine raises at construction for another head dim under
``attention_impl="paged"`` (``attention_impl="dense"`` is the explicit
choice for such a model).

Prefix caching (``prefix_cache=True``, chunked prefill only): a radix
index over resident prompt blocks (``prefix_cache.py``); a new request's
matched prefix is ref'd into its table, its temp cache is seeded from
those blocks (``pool.read_blocks``) and only the uncached suffix is
prefilled; each committed prompt is published; a decode write into a
shared block forks it first (``_cow_fork_writes``).  In int8 mode a match
is floored to the prefill-chunk boundaries, so cache-on tokens are the
cache-off tokens bit for bit.

Speculative decoding (``speculative=k``, greedy only): every decode step
drafts k tokens per slot host-side (prompt-lookup n-grams, no draft
model) and verifies ``[last, d_1..d_k]`` in one step of T = 1 + k
positions, accepting the longest agreeing prefix plus the target's next
token.  As in the JAX engine, T = 1 steps take the paged kernel and a
verify step (T > 1) the dense ``gather_blocks`` + mask path: the kernel
attends one query per slot.  ``decode_routes`` counts the steps of each.

Multi-tenant LoRA (``lora_spec=...``): each request may name a
registered adapter (``register_adapter``).  The decode step gathers each
slot's (A, B) factors from the fixed-shape adapter pool
(``adapters.AdapterPool``) by slot id and adds the per-slot low-rank
delta ``scaling * (x @ A) @ B`` to q, k, v (q and k rope-rotated) and to
o's output, so heterogeneous tenants and the base model (identity
adapter 0) share one decode step: a one-token step still attends through
the paged kernel, one launch a layer.  A tenant's prompt is prefilled
through its merged weights, merged per layer in each chunk's forward
(``training.lora.adapted``).  Adapters are pinned in the pool only while
their request is RUNNING; if every pool slot is pinned when a prefill
completes, the request bounces back to the queue (``Scheduler.requeue``)
and ``serve.adapter`` journals the stall.  Prefix-cache keys commit to
the adapter, so a tenant reuses only its own KV.

Greedy decoding (temperature 0) gives the JAX engine's tokens; stochastic
sampling is reproducible under the engine's own seeded generator.

Telemetry: the same ``serve.engine`` / ``serve.prefill_chunk`` /
``serve.preempt`` / ``serve.prefix`` / ``serve.speculate`` /
``serve.adapter`` / ``serve.step`` / ``serve.request_done`` journal
records as the JAX engine, so its ``tadnn report`` renders them.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): disaggregated prefill, tensor parallelism (a mesh) and the AOT
export cache.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any

import numpy as np
import torch

from ...obs import journal as _journal
from ...models.transformer_core import embedding_lookup, rope
from ...ops.attention import xla_attention
from ...ops.paged_attention import kernel_takes, paged_attention
from ...training.lora import LoraSpec, adapted
from ...utils.device import resolve_device
from ..decode import KVCache, SampleConfig, _sample, forward_cached
from ..quant import dequantize_kv, quantize_kv
from ..speculative import accept_length, ngram_propose
from .adapters import AdapterPool, factor_rows
from .kv_pool import PagedKVPool, blocks_for_tokens, gather_blocks, write_token
from .prefix_cache import PrefixCache
from .scheduler import Request, Scheduler

_LATER = "is a later slice of the PyTorch port (ROADMAP Queue 1 item {})"


def _step_route(attention_impl: str, T: int) -> str:
    """The step's KV read: the paged kernel for one query a slot, else
    the dense gather (the kernel attends a single query, so a T > 1
    verify step reads densely, as in the JAX engine)."""
    return "paged" if attention_impl == "paged" and T == 1 else "dense"


def _lora_delta(site: dict, inp: torch.Tensor, ids: torch.Tensor,
                scaling: float) -> torch.Tensor:
    """Each slot's low-rank delta ``scaling * (x @ A_id) @ B_id`` in fp32:
    ``inp [S, T, d_in]`` fp32, the site's layer factors gathered at
    ``ids [S]`` -> ``[S, T, d_out]``."""
    a = factor_rows(site["a"], ids)  # [S, d_in, r]
    b = factor_rows(site["b"], ids)  # [S, r, d_out]
    return scaling * torch.bmm(torch.bmm(inp, a), b)


def _plus_delta(t: torch.Tensor, delta: torch.Tensor, cfg,
                positions: torch.Tensor, rotate: bool = False):
    """``t + delta`` in fp32, stored in ``t``'s dtype; a q or k delta is
    rope-rotated like the projection it perturbs (rope is linear, so
    that IS the merged weight's output)."""
    d = delta.reshape(t.shape)
    if rotate and cfg.pos == "rope":
        d = rope(d, positions, cfg.rope_theta)
    return (t.to(torch.float32) + d).to(t.dtype)


@torch.no_grad()
def _decode_logits(model, pool: PagedKVPool, tables: torch.Tensor,
                   ctx_lens: torch.Tensor, tok: torch.Tensor, *,
                   attention_impl: str = "paged",
                   adapters: AdapterPool | None = None,
                   adapter_ids: torch.Tensor | None = None) -> torch.Tensor:
    """A [S, T] token chunk per slot: T == 1 is one-token decode, T ==
    1 + k a speculative verify step.  Writes each layer's k/v for chunk
    position t at ``ctx_lens + t`` into the pool (in place), then
    position t attends keys ``0..ctx + t`` inclusive.  With ``adapters``
    each slot's LoRA delta (its pool slot in ``adapter_ids [S]``) is
    added to q, k, v and o's output.  Returns fp32 logits [S, T,
    vocab]."""
    cfg = model.cfg
    dtype = cfg.dtype
    window = cfg.sliding_window
    T = tok.shape[1]
    route = _step_route(attention_impl, T)
    x = embedding_lookup(model.embed, tok, dtype)  # [S, T, d]
    positions = (ctx_lens.to(torch.int64)[:, None]
                 + torch.arange(T, device=tok.device)[None, :])  # [S, T]
    if cfg.pos == "learned":
        x = x + model.pos_embed.to(dtype)[positions]

    mask = None
    if route == "dense":
        n_keys = tables.shape[1] * pool.block_size
        key_idx = torch.arange(n_keys, device=tok.device)[None, None, :]
        # position t writes at ctx + t then attends keys 0..ctx + t
        # inclusive; table padding gathers null-block garbage this never
        # admits
        mask = key_idx <= positions[:, :, None]
        if window is not None:
            mask &= key_idx > positions[:, :, None] - window
        mask = mask[:, None]  # [S, 1, T, K]

    scaling = adapters.spec.scaling if adapters is not None else 1.0
    for i, (layer, k_layer, v_layer) in enumerate(
            zip(model.layers, pool.k, pool.v)):
        h = layer.attn_norm(x)
        q, k, v = layer.attn.qkv(h, positions)
        ad = adapters.layer_factors(i) if adapters is not None else {}
        if ad:
            hf = h.to(torch.float32)
            if "q" in ad:
                q = _plus_delta(q, _lora_delta(ad["q"], hf, adapter_ids,
                                               scaling), cfg, positions, True)
            if "k" in ad:
                k = _plus_delta(k, _lora_delta(ad["k"], hf, adapter_ids,
                                               scaling), cfg, positions, True)
            if "v" in ad:
                v = _plus_delta(v, _lora_delta(ad["v"], hf, adapter_ids,
                                               scaling), cfg, positions)
        for t in range(T):
            write_token(k_layer, tables, ctx_lens + t, k[:, t])
            write_token(v_layer, tables, ctx_lens + t, v[:, t])
        if route == "paged":
            o = paged_attention(q[:, 0], k_layer, v_layer, tables, ctx_lens,
                                window=window)[:, None]
        else:
            kd = gather_blocks(k_layer, tables, dtype)
            vd = gather_blocks(v_layer, tables, dtype)
            o = xla_attention(q, kd, vd, causal=False, mask=mask)
        ao = layer.attn.out_proj(o.to(dtype))
        if "o" in ad:
            of = o.reshape(o.shape[0], o.shape[1], -1).to(torch.float32)
            ao = _plus_delta(ao, _lora_delta(ad["o"], of, adapter_ids,
                                             scaling), cfg, positions)
        x = x + ao
        x = x + layer.mlp(layer.mlp_norm(x))

    x = model.final_norm(x)
    return model.logits(x.to(torch.float32))


def _paged_decode_step(model, pool, tables, ctx_lens, tok, active,
                       generator, *, sample: SampleConfig,
                       attention_impl: str = "paged",
                       adapters: AdapterPool | None = None,
                       adapter_ids: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The decode step: sampled tokens [S] int32 for a one-token step,
    or the target's greedy choices [S, T] int32 at every position of a
    verify step (temperature 0 by contract); 0 on inactive slots."""
    logits = _decode_logits(model, pool, tables, ctx_lens, tok,
                            attention_impl=attention_impl,
                            adapters=adapters, adapter_ids=adapter_ids)
    if tok.shape[1] == 1:
        nxt = _sample(logits[:, 0], generator, sample)
        return torch.where(active, nxt, torch.zeros_like(nxt))
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(active[:, None], tgt, torch.zeros_like(tgt))


@torch.no_grad()
def _prefill_chunk_step(model, tokens: torch.Tensor, cache: KVCache,
                        last_idx: int, *, quantize: bool = False,
                        lora: dict | None = None,
                        lora_spec: LoraSpec | None = None):
    """One [1, C] prefill chunk through ``forward_cached`` against the
    [1, max_len] temp cache.  The final chunk of a prompt may be
    right-padded; ``last_idx`` selects the last REAL token's logits, and
    causal masking keeps the pad positions out of that row.

    ``quantize=True`` (int8 pools) round-trips the chunk's fresh cache
    rows through the pool's (q, scale) form before later chunks attend
    to them, and returns that quantized chunk so the commit scatters the
    exact same pairs.  ``lora``: a tenant's factors, merged into the
    targeted weights layer by layer for this chunk's forward.  Returns
    ``(logits [1, V], cache, qchunk | None)``.
    """
    pos0 = cache.length
    with adapted(model, lora, lora_spec):
        logits, cache = forward_cached(model, tokens, cache, all_logits=True)
    last = logits[:, last_idx]
    if not quantize:
        return last, cache, None
    T = tokens.shape[1]
    rows = slice(pos0, pos0 + T)
    qk = quantize_kv(cache.k[:, 0, rows])  # [L, T, kvH, hd]
    qv = quantize_kv(cache.v[:, 0, rows])
    cache.k[:, 0, rows] = dequantize_kv(qk, cache.k.dtype)
    cache.v[:, 0, rows] = dequantize_kv(qv, cache.v.dtype)
    return last, cache, {"k": qk, "v": qv}


def _cat_qchunks(qchunks: list, n_tokens: int):
    """The prefill's per-chunk quantized KV concatenated along the token
    axis, the final chunk's pad rows trimmed: two ``{"q", "scale"}``
    leaves of [L, n_tokens, kvH, *]."""
    out = []
    for side in ("k", "v"):
        q = torch.cat([c[side]["q"] for c in qchunks], dim=1)
        s = torch.cat([c[side]["scale"] for c in qchunks], dim=1)
        out.append({"q": q[:, :n_tokens], "scale": s[:, :n_tokens]})
    return out[0], out[1]


@dataclasses.dataclass
class _PrefillState:
    """Cursor of one in-flight chunked prefill: the [1, max_len] temp
    cache being filled, how many prompt tokens have streamed through it
    (a prefix-cache hit starts past the reused rows), the tenant's
    factors (None for base-model requests), and (int8 pools only) the
    per-chunk (q, scale) pairs to commit."""

    cache: KVCache
    pos: int = 0
    lora: Any = None
    qchunks: list = dataclasses.field(default_factory=list)


class ServeEngine:
    """Continuous-batching server over a model + paged KV pool.

        eng = ServeEngine(model, n_slots=8, max_len=256)   # on cuda
        eng.submit([1, 2, 3], max_new_tokens=32, eos_id=0)
        done = eng.run()          # [Request] with .prompt + .out_tokens

    ``device`` defaults to ``cuda`` and raises without it; pass
    ``device="cpu"`` to run the plain PyTorch path (the paged kernel's
    plain version) on the CPU.  The model is moved to the device.

    ``lora_spec`` serves LoRA tenants: a pool of ``n_adapters`` slots
    (slot 0 the base model), int8 factors with ``quant_adapters``; size
    ``n_adapters > n_slots`` to never stall on a full pool.
    """

    def __init__(self, model, *,
                 n_slots: int = 8,
                 max_len: int = 256,
                 block_size: int = 16,
                 num_blocks: int | None = None,
                 quant_kv: bool = False,
                 cache_dtype=torch.bfloat16,
                 sample: SampleConfig | None = None,
                 admission: str = "reserve",
                 attention_impl: str = "paged",
                 prefill_chunk: int | None = 32,
                 prefill_chunks_per_step: int = 1,
                 lora_spec: LoraSpec | None = None,
                 n_adapters: int = 8,
                 quant_adapters: bool = False,
                 speculative: int = 0,
                 prefix_cache: bool = False,
                 prefix_ttl_s: float | None = None,
                 disaggregate: bool = False,
                 mesh: Any = None,
                 export_cache: Any = None,
                 generator: torch.Generator | None = None,
                 journal: Any = None,
                 device=None):
        if attention_impl not in ("paged", "dense"):
            raise ValueError(
                f"unknown attention_impl {attention_impl!r} "
                f"(expected 'paged' or 'dense')")
        for name, value, item in (
                ("disaggregate (disaggregated prefill)", disaggregate, "2"),
                ("mesh (tensor-parallel serving)", mesh, "2"),
                ("export_cache", export_cache, "4"),
                (f"serving {type(model).__name__} (MoE decoding)",
                 getattr(model.cfg, "n_experts", None), "6")):
            if value:
                raise NotImplementedError(f"{name} {_LATER.format(item)}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = model.cfg
        if self.cfg.pos == "learned" and max_len > self.cfg.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds the model's {self.cfg.max_seq_len}"
                f" learned positions")
        self.sample = sample or SampleConfig(temperature=0.0)
        self.n_slots = n_slots
        self.max_len = max_len
        self.speculative = int(speculative)
        if self.speculative < 0:
            raise ValueError(f"speculative={speculative} must be >= 0")
        if self.speculative and self.sample.temperature != 0.0:
            raise ValueError(
                "speculative decoding is greedy-only (the accept rule "
                "compares against the target's argmax) — use "
                "temperature=0.0")
        pool_dtype = torch.int8 if quant_kv else cache_dtype
        hd = self.cfg.head_dim
        if (attention_impl == "paged" and self.device.type == "cuda"
                and not kernel_takes(hd, self.cfg.dtype, pool_dtype)):
            raise ValueError(
                f"attention_impl='paged': the paged-attention kernel does "
                f"not take this model's head_dim {hd} ({self.cfg.dtype} "
                f"queries, a {pool_dtype} pool); pass "
                f"attention_impl='dense' to serve it by the dense path")
        self.attention_impl = attention_impl
        if prefill_chunk is not None:
            # snap the chunk to a divisor of max_len: the temp cache is
            # exactly [1, max_len], so the cursor never runs past it
            prefill_chunk = math.gcd(min(int(prefill_chunk), max_len),
                                     max_len)
        self.prefill_chunk = prefill_chunk
        self.prefill_chunks_per_step = max(1, int(prefill_chunks_per_step))
        self.max_blocks = blocks_for_tokens(max_len, block_size)
        if num_blocks is None:
            # worst case every slot full-length, plus the null block
            num_blocks = n_slots * self.max_blocks + 1
        self.pool = PagedKVPool(
            self.cfg, num_blocks=num_blocks, block_size=block_size,
            dtype=cache_dtype, quantize=quant_kv, device=self.device)
        self.journal = journal or _journal.get_default()
        self.lora_spec = lora_spec
        self.adapter_pool: AdapterPool | None = None
        if lora_spec is not None:
            self.adapter_pool = AdapterPool(
                self.model, lora_spec, n_adapters=n_adapters,
                quantize=quant_adapters, device=self.device)
        # cross-request prefix caching: matched prefixes are ref'd into
        # the new request's table and their chunks skipped.  A match
        # aligns to blocks, and in int8 mode also to prefill-chunk
        # boundaries, so the cache-off chunk partition of the recomputed
        # suffix is reproduced exactly
        self._prefix_cache = None
        self.prefix_ttl_s = prefix_ttl_s
        match_align = None
        if prefix_cache:
            if prefill_chunk is None:
                raise ValueError(
                    "prefix_cache requires chunked prefill (the "
                    "single-shot path cannot resume from a cached prefix)")
            self._prefix_cache = PrefixCache(
                block_size=block_size, allocator=self.pool.allocator,
                journal=self.journal)
            match_align = (math.lcm(block_size, self.prefill_chunk)
                           if quant_kv else block_size)
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_cached_tokens = 0
        self.prefix_saved_chunks = 0
        self.cow_forks = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # decode steps by their KV read: "paged" (the kernel) or "dense"
        self.decode_routes = {"paged": 0, "dense": 0}
        self.scheduler = Scheduler(
            n_slots=n_slots, allocator=self.pool.allocator,
            block_size=block_size, admission=admission,
            adapter_pool=self.adapter_pool, spec_lookahead=self.speculative,
            prefix_cache=self._prefix_cache, match_align=match_align)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self._gen = generator
        # TADNN_DEBUG_INVARIANTS=1: audit the scheduler after every step
        self._debug_invariants = (
            os.environ.get("TADNN_DEBUG_INVARIANTS", "") not in ("", "0"))
        self._step_count = 0
        self._occupancy_sum = 0.0
        self.prefill_busy_s = 0.0
        self.decode_busy_s = 0.0
        self.overlapped_wall_s = 0.0
        self.tokens_emitted = 0
        self.finished: list[Request] = []
        self._prefill: dict[int, _PrefillState] = {}
        if self.journal is not None:
            self.journal.event(
                "serve.engine", attention_impl=self.attention_impl,
                prefill_chunk=self.prefill_chunk,
                n_slots=n_slots, max_len=max_len, block_size=block_size,
                quant_kv=bool(quant_kv),
                n_adapters=(n_adapters if lora_spec else 0),
                adapter_rank=(lora_spec.rank if lora_spec else None),
                quant_adapters=bool(quant_adapters and lora_spec),
                speculative=self.speculative,
                prefix_cache=self._prefix_cache is not None,
                disaggregate=False, tp=1)

    # -- request intake ------------------------------------------------------

    def register_adapter(self, name: str, lora) -> None:
        """Stage a tenant's LoRA factors for serving (see
        ``AdapterPool.register``).  Requires ``lora_spec`` at
        construction."""
        if self.adapter_pool is None:
            raise ValueError(
                "engine built without lora_spec — pass lora_spec=... to "
                "serve adapters")
        self.adapter_pool.register(name, lora)

    def submit(self, prompt: list[int], max_new_tokens: int,
               eos_id: int | None = None, adapter: str | None = None,
               priority: int = 0) -> Request:
        total = len(prompt) + max_new_tokens
        # speculative steps write up to k draft keys past the emitted
        # context: that lookahead must fit the slot's table too
        need_len = total + self.speculative
        if need_len > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                + (f"+ speculative lookahead {self.speculative} "
                   if self.speculative else "")
                + f"= {need_len} exceeds engine max_len {self.max_len}")
        if not prompt:
            raise ValueError("empty prompt")
        if adapter is not None:
            if self.adapter_pool is None:
                raise ValueError(
                    "engine built without lora_spec cannot serve "
                    f"adapter {adapter!r}")
            if not self.adapter_pool.has(adapter):
                raise ValueError(
                    f"unknown adapter {adapter!r} — register_adapter() "
                    "it first")
        need = blocks_for_tokens(need_len, self.pool.block_size)
        if need > self.pool.num_blocks - 1:
            # the pool could never cover this request even alone
            raise ValueError(
                f"request needs {need} blocks but the pool has "
                f"{self.pool.num_blocks - 1} allocatable")
        req = Request(prompt=list(map(int, prompt)),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      adapter=adapter, priority=int(priority))
        self.scheduler.submit(req)
        return req

    # -- one serving iteration ----------------------------------------------

    def _bind_adapter(self, slot: int, req: Request) -> bool:
        """Pin the request's adapter at the move into decode (pins back
        live decode reads only; prefilling slots reference adapters by
        name).  When every pool slot is pinned by other running
        requests, the request bounces back to the queue
        recompute-style; pins are held by running slots only, so some
        slot always makes progress and the bounce cannot livelock."""
        info = self.scheduler.pin_adapter(req)
        if info is None:
            self._prefill.pop(req.rid, None)
            self.scheduler.requeue(slot)
            if self.journal is not None:
                self.journal.event("serve.adapter", kind="stall",
                                   rid=req.rid, adapter=req.adapter)
            return False
        if info and self.journal is not None:
            self.journal.event(
                "serve.adapter", kind="hit" if info["hit"] else "fault",
                rid=req.rid, adapter=req.adapter, idx=info["idx"],
                evicted=info["evicted"])
        return True

    def _req_lora(self, req: Request):
        if req.adapter is None:
            return None
        return self.adapter_pool.effective_lora(req.adapter)

    def _commit_prefill(self, req: Request, k: Any, v: Any) -> None:
        """Land a finished prefill's computed cache rows in the request's
        blocks — only the uncached suffix: rows ``k``/``v`` start at token
        ``req.cached_tokens`` (a prefix-cache hit's reused blocks already
        hold their KV).  Then publish every full prompt block into the
        radix index: decode writes start at position n_prompt, so those
        rows are immutable."""
        full = blocks_for_tokens(req.n_prompt, self.pool.block_size)
        self.pool.write_prefill(req.blocks[req.cached_blocks:full], k, v)
        if self._prefix_cache is not None:
            n_pub = req.n_prompt // self.pool.block_size
            new = self._prefix_cache.insert(
                req.prompt[:n_pub * self.pool.block_size],
                req.blocks[:n_pub], ttl_s=self.prefix_ttl_s,
                adapter=req.adapter)
            if new and self.journal is not None:
                self.journal.event("serve.prefix", kind="publish",
                                   rid=req.rid, n_blocks=new)

    def _first_token(self, req: Request, logits: torch.Tensor) -> None:
        req.out_tokens = [int(_sample(logits, self._gen, self.sample)[0])]
        req.t_first_token = self.scheduler.clock()
        req.token_walls = [req.t_first_token]
        self.tokens_emitted += 1

    def _prefill_into_slot(self, req: Request) -> None:
        tokens = torch.tensor([req.prompt], dtype=torch.int64,
                              device=self.device)
        cache = KVCache.init(self.cfg, 1, tokens.shape[1],
                             dtype=torch.bfloat16, device=self.device)
        with adapted(self.model, self._req_lora(req), self.lora_spec):
            logits, cache = forward_cached(self.model, tokens, cache)
        self._first_token(req, logits)
        self._commit_prefill(req, cache.k[:, 0], cache.v[:, 0])

    def _start_prefill(self, slot: int, req: Request) -> None:
        """Admission entry point: single-shot prefill, or flip the slot to
        "prefilling" so step() streams the prompt through [1, C] chunks,
        interleaved with decode."""
        if self.prefill_chunk is None:
            # single-shot requests go straight to running, so the pin
            # happens here, before the prefill work
            if not self._bind_adapter(slot, req):
                return
            self._prefill_into_slot(req)
            return
        req.state = "prefilling"
        cache = KVCache.init(self.cfg, 1, self.max_len, dtype=torch.bfloat16,
                             device=self.device)
        if self._prefix_cache is not None:
            self.prefix_queries += 1
            if req.cached_tokens:
                # seed the temp cache with the matched blocks' KV and
                # start the cursor after them: the chunks then compute
                # only the suffix, attending to the reused rows as the
                # original prefill's later chunks attended to them
                self.prefix_hits += 1
                self.prefix_cached_tokens += req.cached_tokens
                C = self.prefill_chunk
                self.prefix_saved_chunks += (
                    -(-req.n_prompt // C)
                    - -(-(req.n_prompt - req.cached_tokens) // C))
                kd, vd = self.pool.read_blocks(
                    req.blocks[:req.cached_blocks], self.max_blocks,
                    dtype=cache.k.dtype)
                cache.k[:, 0] = kd[:, :self.max_len]
                cache.v[:, 0] = vd[:, :self.max_len]
                cache = cache._replace(length=req.cached_tokens)
            if self.journal is not None:
                self.journal.event(
                    "serve.prefix", kind="match", rid=req.rid,
                    hit=bool(req.cached_tokens),
                    cached_tokens=req.cached_tokens,
                    cached_blocks=req.cached_blocks)
        self._prefill[req.rid] = _PrefillState(
            cache=cache, pos=req.cached_tokens, lora=self._req_lora(req))

    def _advance_prefill(self, slot: int, req: Request) -> None:
        """One [1, C] chunk of ``req``'s prompt; on the final chunk, pin
        the adapter (bouncing the request if the pool is full), sample
        the first token, copy the filled temp-cache rows into the
        request's blocks, and hand the slot to decode."""
        st = self._prefill[req.rid]
        C = self.prefill_chunk
        chunk = req.prompt[st.pos:st.pos + C]
        n_real = len(chunk)
        tokens = torch.tensor([chunk + [0] * (C - n_real)],
                              dtype=torch.int64, device=self.device)
        t0 = time.monotonic()
        logits, st.cache, qchunk = _prefill_chunk_step(
            self.model, tokens, st.cache, n_real - 1,
            quantize=self.pool.quantize, lora=st.lora,
            lora_spec=self.lora_spec)
        if qchunk is not None:
            st.qchunks.append(qchunk)
        st.pos += n_real
        done = st.pos >= req.n_prompt
        bounced = done and not self._bind_adapter(slot, req)
        if done and not bounced:
            self._first_token(req, logits)
            n_suffix = req.n_prompt - req.cached_tokens
            if self.pool.quantize:
                # commit the chunks' own (q, scale) pairs verbatim:
                # re-quantizing the round-tripped bf16 rows would not be
                # idempotent
                k_rows, v_rows = _cat_qchunks(st.qchunks, n_suffix)
            else:
                k_rows = st.cache.k[:, 0, req.cached_tokens:req.n_prompt]
                v_rows = st.cache.v[:, 0, req.cached_tokens:req.n_prompt]
            self._commit_prefill(req, k_rows, v_rows)
            req.state = "running"
            del self._prefill[req.rid]
        chunk_s = time.monotonic() - t0
        req.prefill_chunks += 1
        req.prefill_compute_s += chunk_s
        if self.journal is not None:
            self.journal.event(
                "serve.prefill_chunk", rid=req.rid, slot=slot,
                pos=min(st.pos, req.n_prompt), n_tokens=n_real,
                seconds=chunk_s, done=bool(done and not bounced))

    def _cow_fork_writes(self) -> None:
        """Copy-on-write guard, run right before the decode step: any
        block this step will write into (positions ctx..ctx+lookahead)
        that is shared (refcount > 1: another table or the radix index
        also points at it) is forked to a private copy first, so the
        write can never corrupt another owner's view.  Natural traffic
        never fires it (matches stop below the prompt's end and published
        blocks sit before the first decode write); the guard makes
        sharing safe by construction."""
        bs = self.pool.block_size
        alloc = self.pool.allocator
        for req in self.scheduler.slots:
            if req is None or req.state != "running":
                continue
            ctx = req.n_prompt + req.n_generated - 1
            for t in range(1 + self.speculative):
                bi = (ctx + t) // bs
                if bi >= len(req.blocks):
                    break  # optimistic growth handles coverage
                b = req.blocks[bi]
                if alloc.refcount(b) <= 1:
                    continue
                nb = self.pool.fork_block(b)
                if (nb is None and self._prefix_cache is not None
                        and self._prefix_cache.evict(1)):
                    nb = self.pool.fork_block(b)
                if nb is None:
                    raise RuntimeError(
                        f"cannot fork shared block {b}: pool exhausted "
                        f"and no evictable index leaf")
                req.blocks[bi] = nb
                alloc.release([b])
                self.cow_forks += 1
                if self.journal is not None:
                    self.journal.event("serve.prefix", kind="cow",
                                       rid=req.rid, block=b, fork=nb)

    def _decode_inputs(self):
        """The decode step's slot-padded operands on the device: block
        tables [S, MB] int32, ctx [S] int32, tokens [S, 1 + k] (the last
        emitted token, then k prompt-lookup drafts), active [S], adapter
        pool slots [S] (0, the identity, for base-model and idle slots).
        Inactive and prefilling slots keep an all-null table: the step's
        unconditional KV write lands in the null block instead of their
        half-filled prompt blocks."""
        S, MB, k_spec = self.n_slots, self.max_blocks, self.speculative
        tables = np.zeros((S, MB), np.int32)
        ctx = np.zeros((S,), np.int32)
        tok = np.zeros((S, 1 + k_spec), np.int64)
        act = np.zeros((S,), bool)
        ids = np.zeros((S,), np.int64)
        for s, req in enumerate(self.scheduler.slots):
            if req is None or req.state != "running":
                continue
            tables[s, :len(req.blocks)] = req.blocks
            # this step writes token n_generated at absolute position
            # n_prompt + n_generated - 1 (the first generated token came
            # from prefill and was never written)
            ctx[s] = req.n_prompt + req.n_generated - 1
            tok[s, 0] = req.out_tokens[-1]
            if k_spec:
                tok[s, 1:] = ngram_propose(req.prompt + req.out_tokens,
                                           k_spec)
            ids[s] = req.adapter_idx
            act[s] = True
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (tables, ctx, tok, act, ids))

    def _decode_all(self) -> None:
        tables, ctx, tok, act, ids = self._decode_inputs()
        k_spec = self.speculative
        self.decode_routes[_step_route(self.attention_impl, 1 + k_spec)] += 1
        out = _paged_decode_step(
            self.model, self.pool, tables, ctx, tok, act, self._gen,
            sample=self.sample, attention_impl=self.attention_impl,
            adapters=self.adapter_pool, adapter_ids=ids)
        out = out.tolist()
        # one stamp per step: every token this step emits shares it (a
        # speculative burst lands together)
        now = self.scheduler.clock()
        if not k_spec:
            for s, req in enumerate(self.scheduler.slots):
                if req is not None and req.state == "running":
                    req.out_tokens.append(int(out[s]))
                    req.token_walls.append(now)
                    self.tokens_emitted += 1
            return
        drafted = accepted = n_active = 0
        drafts_all = tok.tolist()
        for s, req in enumerate(self.scheduler.slots):
            if req is None or req.state != "running":
                continue
            n_active += 1
            drafts = drafts_all[s][1:]
            tgt = out[s]  # [1 + k] the target's greedy choices
            a = accept_length(drafts, tgt)
            # d_1..d_a agreed; tgt[a] is the target's own next token
            emit = [int(d) for d in drafts[:a]] + [int(tgt[a])]
            drafted += k_spec
            accepted += a
            # clip to the budget, and stop at EOS where sequential
            # decode would have
            emit = emit[:req.max_new_tokens - req.n_generated]
            if req.eos_id is not None and req.eos_id in emit:
                emit = emit[:emit.index(req.eos_id) + 1]
            req.out_tokens.extend(emit)
            req.token_walls.extend([now] * len(emit))
            self.tokens_emitted += len(emit)
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        if self.journal is not None:
            self.journal.event(
                "serve.speculate", step=self._step_count + 1, k=k_spec,
                n_active=n_active, drafted=drafted, accepted=accepted,
                accept_rate=(accepted / drafted if drafted else None))

    def _finish(self, slot: int) -> None:
        # evict() zeroes the prefix accounting with the block table
        cached_tokens = self.scheduler.slots[slot].cached_tokens
        req = self.scheduler.evict(slot)
        self.finished.append(req)
        if self.journal is None:
            return
        # queue_s runs submit -> LAST admission, prefill_s admission ->
        # first token, decode_s first token -> done
        queue_s = (req.t_admit or req.t_submit) - req.t_submit
        prefill_s = ((req.t_first_token - req.t_admit)
                     if req.t_first_token and req.t_admit else None)
        decode_s = ((req.t_done - req.t_first_token)
                    if req.t_first_token else None)
        total_s = req.t_done - req.t_submit
        walls = req.token_walls
        itl_s = [round(b - a, 6) for a, b in zip(walls, walls[1:])]
        self.journal.event(
            "serve.request_done", rid=req.rid, n_prompt=req.n_prompt,
            n_new=req.n_generated, queue_s=queue_s,
            prefill_s=prefill_s, decode_s=decode_s, total_s=total_s,
            tokens_per_s=(req.n_generated / decode_s
                          if decode_s else None),
            preempted=req.preempted,
            ttft_s=((req.t_first_token - req.t_submit)
                    if req.t_first_token else None),
            itl_s=itl_s,
            itl_mean_s=(sum(itl_s) / len(itl_s) if itl_s else None),
            kv_ship_s=None, cached_tokens=cached_tokens or None,
            prefill_chunks=req.prefill_chunks or None,
            prefill_compute_s=(round(req.prefill_compute_s, 6)
                               if req.prefill_chunks else None),
            lost_s=req.lost_s or None)

    def step(self) -> None:
        """One serving iteration: evict finished, admit queued, advance
        prefill chunks (at most ``prefill_chunks_per_step``), grow/preempt
        (optimistic), decode every decoding slot."""
        sched = self.scheduler
        tokens_before = self.tokens_emitted
        for s in range(self.n_slots):
            req = sched.slots[s]
            if (req is not None and req.state == "running"
                    and req.finished()):
                self._finish(s)
        for slot, req in sched.admit():
            self._start_prefill(slot, req)
            if req.state == "running" and req.finished():
                self._finish(slot)  # single-shot, max_new_tokens == 1
        prefill_s = 0.0
        for slot, req in sched.prefill_plan(self.prefill_chunks_per_step):
            t0 = time.monotonic()
            self._advance_prefill(slot, req)
            prefill_s += time.monotonic() - t0
            if req.state == "running" and req.finished():
                self._finish(slot)  # chunked, max_new_tokens == 1
        for victim in sched.grow_for_step():
            self._prefill.pop(victim.rid, None)
            if self.journal is not None:
                self.journal.event("serve.preempt", rid=victim.rid,
                                   n_regenerate=victim.n_prompt)
        decode_s = 0.0
        if sched.n_decoding:
            if self._prefix_cache is not None:
                self._cow_fork_writes()
            t0 = time.monotonic()
            self._decode_all()
            decode_s = time.monotonic() - t0
        self._step_count += 1
        self._occupancy_sum += sched.n_active / self.n_slots
        self.prefill_busy_s += prefill_s
        self.decode_busy_s += decode_s
        self.overlapped_wall_s += prefill_s + decode_s
        if self.journal is not None:
            extra = {}
            if self.adapter_pool is not None:
                alloc = self.adapter_pool.allocator
                extra.update(adapters_resident=alloc.n_resident,
                             adapters_pinned=alloc.n_pinned)
            if self._prefix_cache is not None:
                extra.update(
                    prefix_blocks=self._prefix_cache.n_blocks,
                    prefix_hit_tokens=self._prefix_cache.hit_tokens)
            self.journal.event(
                "serve.step", step=self._step_count,
                n_active=sched.n_active, n_queued=sched.n_queued,
                n_prefilling=sched.n_prefilling,
                new_tokens=self.tokens_emitted - tokens_before,
                occupancy=sched.n_active / self.n_slots,
                free_blocks=self.pool.allocator.n_free,
                prefill_s=prefill_s, decode_s=decode_s,
                mode="colocated", overlap_s=prefill_s + decode_s,
                **extra)
        if self._debug_invariants:
            sched.check_invariants()

    @property
    def prefix_cache(self) -> PrefixCache | None:
        """The engine's radix reuse index (None when disabled)."""
        return self._prefix_cache

    @property
    def mean_occupancy(self) -> float | None:
        """Mean active-slot fraction over every step so far."""
        if not self._step_count:
            return None
        return self._occupancy_sum / self._step_count

    def run(self) -> list[Request]:
        """Step until queue and slots drain; returns finished requests
        (every submitted request, in completion order)."""
        while not self.scheduler.idle():
            self.step()
        return list(self.finished)
