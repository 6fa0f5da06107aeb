"""Serving-trace lint: GL/DT rules over the ServeEngine's traced steps.

Training steps have graph + dtype preflight; this module gives the
serving decode/prefill steps (the programs a replica actually runs per
token) the same, for ``tadnn check --serving --trace-serve``: build a
ServeEngine on the requested config, make the operands the engine
feeds its steps (``_decode_inputs``' tables, context lengths, tokens,
active flags and adapter ids; a prefill chunk and its ``[1, max_len]``
temp cache), trace ``_paged_decode_step`` and ``_prefill_chunk_step``
on fake tensors (``graph_lint.trace_step``: the weights, the pool and
the cache are the trace's inputs, nothing runs) and run
:mod:`.graph_lint` + :mod:`.dtype_lint` over both traces.  The decode
trace holds the paged-attention kernel (K4) as one ``tadnn`` node a
layer.

Host syncs inside the decode step (GL001) are the marquee catch: one
stray ``.item()`` in the sampled-token path syncs every decode step of
every stream.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn

from . import Finding


class _Step(nn.Module):
    """One engine step as a module call, so the trace takes the model's
    weights as inputs (``torch.func.functional_call``)."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def serve_trace_check(
    model: Any,
    *,
    n_slots: int = 4,
    max_len: int = 64,
    block_size: int = 8,
    quant_kv: bool = False,
    attention_impl: str = "paged",
    prefill_chunk: int | None = 32,
    compute_dtype: Any = None,
    device: Any = None,
) -> tuple[list[Finding], dict]:
    """Build a ServeEngine and lint its decode + prefill traces.

    Returns ``(findings, stats)`` where ``stats`` carries per-trace
    node/collective counts (and the kernels' nodes) for the JSON output.
    The engine is real (the traces must match dispatch) but small —
    callers pass test-size shapes; no request is ever submitted and no
    step runs.
    """
    from ..inference.decode import KVCache
    from ..inference.serve import engine as engine_mod
    from ..inference.serve.kv_pool import _layer_views
    from . import dtype_lint, graph_lint

    eng = engine_mod.ServeEngine(
        model, n_slots=n_slots, max_len=max_len, block_size=block_size,
        quant_kv=quant_kv, attention_impl=attention_impl,
        prefill_chunk=prefill_chunk, journal=None, device=device)
    params = dict(eng.model.named_parameters())
    if compute_dtype is None:
        # the model's activation dtype: its attention casts fp32 products
        # to it, the configured policy
        compute_dtype = eng.cfg.dtype
    findings: list[Finding] = []
    stats: dict[str, dict] = {}

    def lint_one(tag: str, fn, args: tuple) -> None:
        step = _Step(eng.model, fn)

        def traced(weights, *a):
            tree = {f"model.{n}": t for n, t in weights.items()}
            return torch.func.functional_call(step, tree, a, strict=False)

        closed = graph_lint.trace_step(traced, params, *args)
        fs = graph_lint.lint_graph(closed, abstract_params=params)
        fs += dtype_lint.lint_dtypes(
            closed, abstract_params=params, compute_dtype=compute_dtype)
        # re-anchor the layer-level `where` so decode/prefill findings
        # are tellable apart in one report
        findings.extend(
            Finding(f.code, f.severity, f.layer,
                    f"serve:{tag}:{f.where}", f.msg)
            for f in fs)
        stats[tag] = {
            "eqns": len(list(graph_lint.iter_eqns(closed))),
            "collectives": len(graph_lint.collective_inventory(closed)),
            "kernels": graph_lint.kernel_nodes(closed),
        }

    # decode: the operands _decode_inputs feeds _paged_decode_step
    S, MB, T = eng.n_slots, eng.max_blocks, 1 + eng.speculative
    dev = eng.device

    def decode(model, kv, tables, ctx, tok, act, ids):
        pool = copy.copy(eng.pool)
        pool.kv = kv
        pool.k = _layer_views(kv["k"], eng.cfg.n_layers)
        pool.v = _layer_views(kv["v"], eng.cfg.n_layers)
        return engine_mod._paged_decode_step(
            model, pool, tables, ctx, tok, act, eng._gen,
            sample=eng.sample, attention_impl=eng.attention_impl,
            adapters=eng.adapter_pool, adapter_ids=ids)

    lint_one("decode", decode, (
        eng.pool.kv,
        torch.zeros((S, MB), dtype=torch.int32, device=dev),
        torch.zeros((S,), dtype=torch.int32, device=dev),
        torch.zeros((S, T), dtype=torch.int32, device=dev),
        torch.zeros((S,), dtype=torch.bool, device=dev),
        torch.zeros((S,), dtype=torch.int32, device=dev)))

    if eng.prefill_chunk:
        C = eng.prefill_chunk
        # the temp cache the engine's prefill writes (_start_prefill)
        cache = KVCache.init(eng.cfg, 1, eng.max_len, dtype=torch.bfloat16,
                             device=dev, kv_heads=eng.pool.kv_heads)

        def prefill(model, k, v, tokens):
            return engine_mod._prefill_chunk_step(
                model, tokens, KVCache(k, v, 0), C - 1,
                moe_decode=eng.moe_decode, quantize=eng.pool.quantize)

        lint_one("prefill", prefill, (
            cache.k, cache.v,
            torch.zeros((1, C), dtype=torch.int64, device=dev)))
    return findings, stats
