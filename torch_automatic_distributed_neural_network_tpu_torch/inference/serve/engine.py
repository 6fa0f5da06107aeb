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

Greedy decoding (temperature 0) gives the JAX engine's tokens; stochastic
sampling is reproducible under the engine's own seeded generator.

Telemetry: the same ``serve.engine`` / ``serve.prefill_chunk`` /
``serve.preempt`` / ``serve.prefix`` / ``serve.speculate`` /
``serve.step`` / ``serve.request_done`` journal records as the JAX
engine, so its ``tadnn report`` renders them.

Not ported yet (each raises ``NotImplementedError``): LoRA adapters,
disaggregated prefill, tensor parallelism (a mesh) and the AOT export
cache.
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
from ...models.transformer_core import embedding_lookup
from ...ops.attention import xla_attention
from ...ops.paged_attention import kernel_takes, paged_attention
from ...utils.device import resolve_device
from ..decode import KVCache, SampleConfig, _sample, forward_cached
from ..quant import dequantize_kv, quantize_kv
from ..speculative import accept_length, ngram_propose
from .kv_pool import PagedKVPool, blocks_for_tokens, gather_blocks, write_token
from .prefix_cache import PrefixCache
from .scheduler import Request, Scheduler

_LATER = "is a later slice of the PyTorch port (see ROADMAP.md)"


def _step_route(attention_impl: str, T: int) -> str:
    """The step's KV read: the paged kernel for one query a slot, else
    the dense gather (the kernel attends a single query, so a T > 1
    verify step reads densely, as in the JAX engine)."""
    return "paged" if attention_impl == "paged" and T == 1 else "dense"


@torch.no_grad()
def _decode_logits(model, pool: PagedKVPool, tables: torch.Tensor,
                   ctx_lens: torch.Tensor, tok: torch.Tensor, *,
                   attention_impl: str = "paged") -> torch.Tensor:
    """A [S, T] token chunk per slot: T == 1 is one-token decode, T ==
    1 + k a speculative verify step.  Writes each layer's k/v for chunk
    position t at ``ctx_lens + t`` into the pool (in place), then
    position t attends keys ``0..ctx + t`` inclusive.  Returns fp32
    logits [S, T, vocab]."""
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

    for layer, k_layer, v_layer in zip(model.layers, pool.k, pool.v):
        h = layer.attn_norm(x)
        q, k, v = layer.attn.qkv(h, positions)
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
        x = x + layer.attn.out_proj(o.to(dtype))
        x = x + layer.mlp(layer.mlp_norm(x))

    x = model.final_norm(x)
    return model.logits(x.to(torch.float32))


def _paged_decode_step(model, pool, tables, ctx_lens, tok, active,
                       generator, *, sample: SampleConfig,
                       attention_impl: str = "paged") -> torch.Tensor:
    """The decode step: sampled tokens [S] int32 for a one-token step,
    or the target's greedy choices [S, T] int32 at every position of a
    verify step (temperature 0 by contract); 0 on inactive slots."""
    logits = _decode_logits(model, pool, tables, ctx_lens, tok,
                            attention_impl=attention_impl)
    if tok.shape[1] == 1:
        nxt = _sample(logits[:, 0], generator, sample)
        return torch.where(active, nxt, torch.zeros_like(nxt))
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(active[:, None], tgt, torch.zeros_like(tgt))


@torch.no_grad()
def _prefill_chunk_step(model, tokens: torch.Tensor, cache: KVCache,
                        last_idx: int, *, quantize: bool = False):
    """One [1, C] prefill chunk through ``forward_cached`` against the
    [1, max_len] temp cache.  The final chunk of a prompt may be
    right-padded; ``last_idx`` selects the last REAL token's logits, and
    causal masking keeps the pad positions out of that row.

    ``quantize=True`` (int8 pools) round-trips the chunk's fresh cache
    rows through the pool's (q, scale) form before later chunks attend
    to them, and returns that quantized chunk so the commit scatters the
    exact same pairs.  Returns ``(logits [1, V], cache, qchunk | None)``.
    """
    pos0 = cache.length
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
    (a prefix-cache hit starts past the reused rows), and (int8 pools
    only) the per-chunk (q, scale) pairs to commit."""

    cache: KVCache
    pos: int = 0
    qchunks: list = dataclasses.field(default_factory=list)


class ServeEngine:
    """Continuous-batching server over a model + paged KV pool.

        eng = ServeEngine(model, n_slots=8, max_len=256)   # on cuda
        eng.submit([1, 2, 3], max_new_tokens=32, eos_id=0)
        done = eng.run()          # [Request] with .prompt + .out_tokens

    ``device`` defaults to ``cuda`` and raises without it; pass
    ``device="cpu"`` to run the plain PyTorch path (the paged kernel's
    plain version) on the CPU.  The model is moved to the device.
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
                 lora_spec: Any = None,
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
        for name, value in (("lora_spec (LoRA adapters)", lora_spec),
                            ("disaggregate", disaggregate),
                            ("mesh (tensor-parallel serving)", mesh),
                            ("export_cache", export_cache)):
            if value:
                raise NotImplementedError(f"{name} {_LATER}")
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
            spec_lookahead=self.speculative,
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
                quant_kv=bool(quant_kv), n_adapters=0, adapter_rank=None,
                quant_adapters=False, speculative=self.speculative,
                prefix_cache=self._prefix_cache is not None,
                disaggregate=False, tp=1)

    # -- request intake ------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int,
               eos_id: int | None = None, adapter: str | None = None,
               priority: int = 0) -> Request:
        if adapter is not None:
            raise NotImplementedError(f"serving LoRA adapters {_LATER}")
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
        need = blocks_for_tokens(need_len, self.pool.block_size)
        if need > self.pool.num_blocks - 1:
            # the pool could never cover this request even alone
            raise ValueError(
                f"request needs {need} blocks but the pool has "
                f"{self.pool.num_blocks - 1} allocatable")
        req = Request(prompt=list(map(int, prompt)),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      priority=int(priority))
        self.scheduler.submit(req)
        return req

    # -- one serving iteration ----------------------------------------------

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
                req.blocks[:n_pub], ttl_s=self.prefix_ttl_s)
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
        logits, cache = forward_cached(self.model, tokens, cache)
        self._first_token(req, logits)
        self._commit_prefill(req, cache.k[:, 0], cache.v[:, 0])

    def _start_prefill(self, slot: int, req: Request) -> None:
        """Admission entry point: single-shot prefill, or flip the slot to
        "prefilling" so step() streams the prompt through [1, C] chunks,
        interleaved with decode."""
        if self.prefill_chunk is None:
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
        self._prefill[req.rid] = _PrefillState(cache=cache,
                                               pos=req.cached_tokens)

    def _advance_prefill(self, slot: int, req: Request) -> None:
        """One [1, C] chunk of ``req``'s prompt; on the final chunk,
        sample the first token, copy the filled temp-cache rows into the
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
            quantize=self.pool.quantize)
        if qchunk is not None:
            st.qchunks.append(qchunk)
        st.pos += n_real
        done = st.pos >= req.n_prompt
        if done:
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
                seconds=chunk_s, done=bool(done))

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
        emitted token, then k prompt-lookup drafts), active [S].
        Inactive and prefilling slots keep an all-null table: the step's
        unconditional KV write lands in the null block instead of their
        half-filled prompt blocks."""
        S, MB, k_spec = self.n_slots, self.max_blocks, self.speculative
        tables = np.zeros((S, MB), np.int32)
        ctx = np.zeros((S,), np.int32)
        tok = np.zeros((S, 1 + k_spec), np.int64)
        act = np.zeros((S,), bool)
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
            act[s] = True
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (tables, ctx, tok, act))

    def _decode_all(self) -> None:
        tables, ctx, tok, act = self._decode_inputs()
        k_spec = self.speculative
        self.decode_routes[_step_route(self.attention_impl, 1 + k_spec)] += 1
        out = _paged_decode_step(
            self.model, self.pool, tables, ctx, tok, act, self._gen,
            sample=self.sample, attention_impl=self.attention_impl)
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
            prefix_stats = {}
            if self._prefix_cache is not None:
                prefix_stats = dict(
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
                **prefix_stats)
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
