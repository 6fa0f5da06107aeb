"""Serving capacity lint: predict max concurrent streams statically.

``tadnn check --serving`` answers, before any hardware is touched: under
this chip's HBM budget, how many concurrent streams of ``max_len``
tokens can the paged KV pool (inference/serve/kv_pool.py) hold?  The
arithmetic is the same per-device accounting the training memory lint
uses — the pool pytree is charged through
:func:`sharded_tree_bytes` under the same head-sharding spec
``cache_partition_spec`` applies to the live cache — so the static
number and the runtime allocation agree by construction.

Findings land in the shared Finding/RULES vocabulary: **ML004** (error)
when not even one stream fits, **ML005** (warn) when fewer fit than the
deployment asked for, **ML006** (error) when a multi-tenant LoRA
adapter pool (inference/serve/adapters.py, charged per-adapter ×
pool-size, int8-aware) is what pushes an otherwise-serving deployment
to zero streams.  The full estimate is journaled as
``lint.serve_estimate`` for ``tadnn report``.

The PyTorch package's copy of the JAX package's ``analysis/serve_lint.py``
(what ``tune/simulate`` sizes a serving replica's pool with): the pool
is a pair of ``[n_layers, 1, block, kv_heads, head_dim]`` shapes charged
through the planner's spec arithmetic; the byte formatting, the budget
and the headroom are the memory lint's (``analysis/mem_lint``), as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from .. import planner
from . import ERROR, WARN, Finding
from .mem_lint import DEFAULT_HEADROOM, _fmt_bytes, resolve_budget

# host-side radix-index metadata per resident block: 24-hex key string,
# parent/child dict entries, and a float timestamp (prefix_cache._Node)
PREFIX_NODE_BYTES = 192


@dataclasses.dataclass(frozen=True)
class _Shape:
    """An abstract pool leaf: its shape and itemsize."""

    shape: tuple[int, ...]
    itemsize: int


def _flat(tree: Any) -> list:
    """A pool tree's leaves (a side, or its ``q``/``scale`` pair), in
    key order."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    return [tree]


def sharded_tree_bytes(
    tree: Any, specs: Any, degrees: Mapping[str, int]
) -> tuple[int, int]:
    """(per_device_bytes, global_bytes) of a pool tree under its spec
    tree — replicated-because-unsharded leaves charged in full."""
    per_dev = 0.0
    total = 0
    for spec, leaf in zip(_flat(specs), _flat(tree)):
        b = (math.prod(leaf.shape) if leaf.shape else 1) * leaf.itemsize
        frac = 1
        for ax in planner.spec_axes(spec):
            frac *= int(degrees.get(ax, 1))
        total += b
        per_dev += b / max(1, frac)
    return int(per_dev), int(total)


def _pool_specs(cfg, degrees: Mapping[str, int], quantize: bool):
    """Abstract pool tree + matching PartitionSpec tree for ONE block
    — kv heads on the tensor axis when divisible, the rule the
    tensor-parallel engine's pool follows (restated over a degrees
    mapping so no mesh object is needed)."""
    P = planner.PartitionSpec

    t = int(degrees.get("tensor", 1))
    head = "tensor" if t > 1 and cfg.kv_heads % t == 0 else None
    spec = P(None, None, None, head, None)

    def side(block_size):
        shape = (cfg.n_layers, 1, block_size, cfg.kv_heads, cfg.head_dim)
        if quantize:
            return {
                "q": _Shape(shape, 1),
                "scale": _Shape(shape[:-1] + (1,), 4),
            }
        return _Shape(shape, 2)

    def side_spec():
        if quantize:
            return {"q": spec, "scale": P(None, None, None, head, None)}
        return spec

    return side, side_spec


def serve_estimate(cfg, *,
                   budget: int | str | None = None,
                   headroom: float = DEFAULT_HEADROOM,
                   block_size: int = 16,
                   max_len: int = 256,
                   streams: int | None = None,
                   quant_kv: bool = False,
                   params_bytes: int = 0,
                   attention_impl: str = "paged",
                   adapters: int | None = None,
                   adapter_rank: int = 8,
                   quant_adapters: bool = False,
                   prefix_cache: bool = False,
                   expected_hit_rate: float = 0.0,
                   degrees: Mapping[str, int] | None = None,
                   ) -> tuple[list[Finding], dict[str, Any]]:
    """(findings, estimate) for a serving deployment of ``cfg``.

    ``params_bytes`` is charged replicated (the latency-first serving
    layout); ``degrees`` shards the KV pool's head axis (matching
    ``cache_partition_spec``) and the adapter pool's b factors, so
    stream caps recompute from per-shard HBM.  ``streams`` is the requested concurrency
    — when given, fitting fewer is an ML005 warning.

    ``adapters`` sizes a multi-tenant LoRA pool (slot 0, the identity
    adapter, is counted on top — the pool the engine builds holds
    ``adapters + 1`` entries), charged per shard via
    ``pool_adapter_bytes(degrees=...)`` (default q+v recipe at
    ``adapter_rank``, int8 payload + fp32 scales when
    ``quant_adapters``; b factors split over the tensor degree exactly
    as AdapterPool shards them).  When that
    term alone turns a >=1-stream deployment into a 0-stream one, the
    finding is ML006, not ML004 — the fix is a smaller/int8 adapter
    pool, not a smaller KV pool.

    ``prefix_cache`` charges the radix index's host-side metadata (one
    node per resident block — hash key, pointers, timestamp; see
    ``PREFIX_NODE_BYTES``) against the pool budget, and
    ``expected_hit_rate`` — the expected fraction of prompt tokens
    served from cache on this deployment's traffic — reprices stream
    capacity: the cached prefix is resident ONCE and shared, so each
    concurrent stream uniquely owns only its uncached blocks
    (``effective_max_streams``).  The same knob is what
    ``tune/simulate.py`` prices per-request from its TrafficMix, so the
    static and replayed numbers share a vocabulary.

    ``attention_impl`` matches the engine's knob: the ``"dense"`` decode
    path materializes one layer's gathered K and V views per step
    ([S, max_len, kvH, hd] bf16 each — ``kv_pool.gather_blocks``), a
    transient workspace charged against the pool budget here;
    ``"paged"`` (default) reads blocks in-kernel
    (ops/paged_attention.py) so its workspace is exactly 0 bytes.
    """
    from ..inference.serve.kv_pool import blocks_for_tokens

    if attention_impl not in ("paged", "dense"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    degrees = dict(degrees or {})
    budget_bytes = resolve_budget(budget)
    side, side_spec = _pool_specs(cfg, degrees, quant_kv)
    one_block = {"k": side(block_size), "v": side(block_size)}
    one_spec = {"k": side_spec(), "v": side_spec()}
    block_bytes_dev, block_bytes_global = sharded_tree_bytes(
        one_block, one_spec, degrees)

    adapter_pool_bytes = 0
    if adapters:
        from ..inference.serve.adapters import pool_adapter_bytes

        # +1: the engine's pool reserves slot 0 for the identity
        # adapter.  Charged PER SHARD: under a tensor degree the
        # AdapterPool splits each b factor's output channels, so only
        # b/t lands on the device being budgeted (a deployment that
        # fits sharded must not be rejected from replicated arithmetic)
        adapter_pool_bytes = pool_adapter_bytes(
            cfg, rank=adapter_rank, n_adapters=int(adapters) + 1,
            quantize=quant_adapters, degrees=degrees)

    usable = (int(budget_bytes * (1.0 - headroom)) - int(params_bytes)
              - adapter_pool_bytes)
    num_blocks = max(0, usable // max(1, block_bytes_dev))
    prefix_index_bytes = 0
    if prefix_cache:
        if not 0.0 <= expected_hit_rate < 1.0:
            raise ValueError(
                f"expected_hit_rate={expected_hit_rate} must be in "
                "[0, 1)")
        # radix node per resident block (worst case: every block
        # indexed) — hash key string, parent/children entries, float
        # timestamp.  Host RAM in practice, charged here so the
        # estimate is conservative and the knob is never free.
        prefix_index_bytes = num_blocks * PREFIX_NODE_BYTES
        usable -= prefix_index_bytes
        num_blocks = max(0, usable // max(1, block_bytes_dev))
    blocks_per_stream = blocks_for_tokens(max_len, block_size)
    # one block is the reserved null block (kv_pool.NULL_BLOCK)
    max_streams = max(0, (num_blocks - 1) // blocks_per_stream)
    # capacity WITHOUT the adapter term — distinguishes "the model
    # doesn't fit" (ML004) from "the adapter pool ate the KV budget"
    # (ML006)
    blocks_sans_adapters = max(
        0, (usable + adapter_pool_bytes) // max(1, block_bytes_dev))
    streams_sans_adapters = max(
        0, (blocks_sans_adapters - 1) // blocks_per_stream)

    decode_workspace_bytes = 0
    if attention_impl == "dense":
        # one layer's gathered k+v dense views, alive during every
        # decode step; shards over the head axis like the pool
        t = int(degrees.get("tensor", 1))
        shard = t if t > 1 and cfg.kv_heads % t == 0 else 1
        per_stream_ws = 2 * max_len * cfg.kv_heads * cfg.head_dim * 2
        per_stream_ws //= shard
        n_ws = streams if streams is not None else max_streams
        decode_workspace_bytes = int(per_stream_ws * n_ws)
        num_blocks = max(
            0, (usable - decode_workspace_bytes) // max(1, block_bytes_dev))
        max_streams = max(0, (num_blocks - 1) // blocks_per_stream)

    # expected-hit-rate repricing: the cached prefix (hit_rate of each
    # prompt's blocks, to first order) is resident once and SHARED, so
    # each concurrent stream uniquely consumes only its uncached
    # blocks.  effective_max_streams is the shared-traffic capacity.
    effective_max_streams = max_streams
    if prefix_cache and expected_hit_rate > 0.0 and max_streams >= 1:
        shared_blocks = int(round(blocks_per_stream * expected_hit_rate))
        unique_blocks = max(1, blocks_per_stream - shared_blocks)
        effective_max_streams = max(
            max_streams,
            (num_blocks - 1 - shared_blocks) // unique_blocks)

    est: dict[str, Any] = {
        "attention_impl": attention_impl,
        "decode_workspace_bytes": decode_workspace_bytes,
        "budget_bytes": int(budget_bytes),
        "headroom": headroom,
        "params_bytes": int(params_bytes),
        "usable_pool_bytes": max(0, usable),
        "block_size": int(block_size),
        "block_bytes_per_device": int(block_bytes_dev),
        "block_bytes_global": int(block_bytes_global),
        "num_blocks": int(num_blocks),
        "max_len": int(max_len),
        "blocks_per_stream": int(blocks_per_stream),
        "max_streams": int(max_streams),
        "quant_kv": bool(quant_kv),
        "degrees": degrees,
        "requested_streams": streams,
        "adapter_pool_bytes": int(adapter_pool_bytes),
        "n_adapters": int(adapters or 0),
        "adapter_rank": int(adapter_rank) if adapters else None,
        "quant_adapters": bool(quant_adapters and adapters),
        "prefix_cache": bool(prefix_cache),
        "prefix_index_bytes": int(prefix_index_bytes),
        "expected_hit_rate": float(expected_hit_rate) if prefix_cache
        else None,
        "effective_max_streams": int(effective_max_streams),
    }

    findings: list[Finding] = []
    where = (f"serve[{cfg.n_layers}L x {cfg.kv_heads}kvH x "
             f"{cfg.head_dim}hd, max_len {max_len}]")
    if max_streams < 1 and streams_sans_adapters >= 1:
        findings.append(Finding(
            "ML006", ERROR, "mem", where,
            f"the {int(adapters)}-adapter rank-{adapter_rank} LoRA pool "
            f"({_fmt_bytes(adapter_pool_bytes)}) leaves no usable HBM "
            f"for even one KV stream ({streams_sans_adapters} would fit "
            "without it); shrink the pool or rank"
            + ("" if quant_adapters else
               ", or --serve-quant-adapters (int8 factors ~quarter the "
               "pool)")))
    elif max_streams < 1:
        findings.append(Finding(
            "ML004", ERROR, "mem", where,
            f"KV pool fits 0 streams: {blocks_per_stream} block(s) of "
            f"{_fmt_bytes(block_bytes_dev)} each exceed the usable "
            f"{_fmt_bytes(max(0, usable))} "
            f"(budget {_fmt_bytes(budget_bytes)} less "
            f"{headroom:.0%} headroom and "
            f"{_fmt_bytes(params_bytes)} params)"
            + ("" if quant_kv else "; try --quant-kv (int8 KV ~halves "
               "block bytes)")))
    elif streams is not None and max_streams < streams:
        findings.append(Finding(
            "ML005", WARN, "mem", where,
            f"requested {streams} concurrent streams but only "
            f"{max_streams} fit ({num_blocks} blocks / "
            f"{blocks_per_stream} per stream)"
            + ("" if quant_kv else "; --quant-kv (int8 KV) ~doubles "
               "capacity")
            + ("" if attention_impl == "paged" else
               "; attention_impl=paged frees the "
               f"{_fmt_bytes(decode_workspace_bytes)} gather workspace")))

    from ..obs import journal as obs_journal

    obs_journal.event("lint.serve_estimate", **est)
    return findings, est
