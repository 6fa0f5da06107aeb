"""Tuner orchestration: enumerate -> score -> (optionally measure) ->
cache, with every decision journaled.

Entry point is :func:`tune`; ``planner.make_plan(strategy='tuned')``
calls it and builds the winning mesh, so ``AutoDistribute(...,
strategy='tuned')`` and ``Trainer`` get autotuned plans with no other
changes.  Journal event names (all picked up by ``tadnn report``):

- ``tune.cache_hit`` / ``tune.cache_miss`` — persistent-cache probe
- ``tune.fallback`` — degenerate space, heuristic ``auto`` answer used
- ``tune.candidate`` — one per ranked candidate (top 8), with the full
  cost breakdown
- ``tune.decision`` — the winner and why
- ``tune.trial`` spans / ``tune.trial.result`` — measured calibration
  (tune/measure.py)

The PyTorch package's copy of the JAX package's ``tune/tuner.py``, with
one keyword more: ``heads`` ``(n_heads, kv_heads)`` splits the attention
projections in the charge view (``space.charge_view``), prunes the tensor
degrees the port cannot build and joins the cache key;
``make_plan(strategy='tuned', heads=...)`` passes its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from .. import planner
from .. import topology as topo_mod
from ..obs import journal as obs_journal
from . import cache as cache_mod
from . import cost as cost_mod
from . import space as space_mod


@dataclasses.dataclass(frozen=True)
class TunePolicy:
    """Knobs of the search; hashed into the cache key, so changing any
    of them re-tunes instead of replaying a stale decision."""

    grad_accums: tuple[int, ...] = (1,)
    max_tensor: int = 8
    state_factor: float = 4.0
    # items (tokens for LM batches) per global optimizer step; None ->
    # space.DEFAULT_BATCH_ITEMS
    batch_items: int | None = None
    safety: float = space_mod.MEMORY_SAFETY
    top_k: int = 3
    use_cache: bool = True
    # Enumerate ZeRO-1 optimizer-state-sharding variants (space.py adds
    # a zero1=True twin of every candidate with a nontrivial data axis).
    # Part of the frozen dataclass, so it hashes into the cache key —
    # a cached plain-dp decision can never shadow a dp+zero1 search.
    zero1: bool = True
    # Liveness activation profile of the real traced step — swaps the
    # coarse activation heuristic for measured liveness intervals in
    # memory pruning and ranking.  A plain JSON-able dict, so it hashes
    # into the cache key like every other knob
    # (AutoDistribute.activation_profile: the step traced on fake
    # tensors, no device needed).
    act_profile: Any = None


@dataclasses.dataclass
class TuneResult:
    strategy: str
    degrees: dict[str, int]
    grad_accum: int
    ranked: list  # list[cost.CostEstimate]; empty on cache hit/fallback
    source: str  # 'cost_model' | 'cache' | 'fallback'
    key: str
    zero1: bool = False  # winner shards optimizer state over 'data'


def tune(
    abstract_params: Mapping[str, Any],
    topo: topo_mod.Topology | None = None,
    *,
    rules: Sequence[planner.Rule] = planner.TRANSFORMER_RULES,
    policy: TunePolicy | None = None,
    cache_path: str | None = None,
    heads: tuple[int, int] | None = None,
) -> TuneResult:
    """Pick (strategy, mesh degrees, grad_accum) for this model on this
    topology.  Pure shape math — no device arrays are built, so it runs
    before any mesh exists."""
    topo = topo or topo_mod.detect()
    policy = policy or TunePolicy()
    signature = cache_mod.params_signature(abstract_params)
    if heads is not None:
        # the head counts decide which tensor degrees the port builds;
        # the shapes alone do not give them
        signature += ":heads=%d,%d" % tuple(heads)
    key = cache_mod.cache_key(
        signature, cache_mod.topology_fingerprint(topo), policy)

    if policy.use_cache:
        rec = cache_mod.lookup(key, path=cache_path)
        if rec and rec.get("strategy"):
            obs_journal.event(
                "tune.cache_hit", key=key, strategy=rec["strategy"],
                mesh=rec.get("degrees"), grad_accum=rec.get("grad_accum", 1),
                zero1=bool(rec.get("zero1", False)),
                step_time_ms=rec.get("step_time_ms"),
            )
            return TuneResult(
                strategy=rec["strategy"],
                degrees={k: int(v) for k, v in
                         (rec.get("degrees") or {}).items()},
                grad_accum=int(rec.get("grad_accum", 1)),
                ranked=[], source="cache", key=key,
                zero1=bool(rec.get("zero1", False)),
            )
        obs_journal.event("tune.cache_miss", key=key)

    kept, pruned = space_mod.enumerate_candidates(
        abstract_params, topo, rules=rules,
        grad_accums=policy.grad_accums, max_tensor=policy.max_tensor,
        state_factor=policy.state_factor, batch_items=policy.batch_items,
        safety=policy.safety, act_profile=policy.act_profile,
        zero1=policy.zero1, heads=heads,
    )
    if topo.num_devices == 1 or len(kept) <= 1:
        # Degenerate space (single chip, or pruning left at most one
        # survivor): nothing to rank — the auto heuristic is the answer.
        strategy, degrees = planner.choose_strategy(
            abstract_params, topo, rules, state_factor=policy.state_factor
        )
        obs_journal.event(
            "tune.fallback",
            reason=(f"degenerate space: {topo.num_devices} device(s), "
                    f"{len(kept)} candidate(s) after pruning"),
            strategy=strategy, mesh=dict(degrees), key=key,
        )
        return TuneResult(
            strategy=strategy, degrees=dict(degrees), grad_accum=1,
            ranked=[], source="fallback", key=key,
        )

    ranked = cost_mod.rank(
        abstract_params, topo, kept, rules=rules,
        state_factor=policy.state_factor, batch_items=policy.batch_items,
        safety=policy.safety, act_profile=policy.act_profile,
        heads=heads,
    )
    for i, est in enumerate(ranked[:8]):
        obs_journal.event("tune.candidate", rank=i, **est.to_json())
    win = ranked[0]
    decision = {
        "strategy": win.candidate.strategy,
        "degrees": win.candidate.degrees_dict,
        "grad_accum": win.candidate.grad_accum,
        "zero1": bool(win.candidate.zero1),
        "step_time_ms": round(win.step_time_s * 1e3, 4),
        "fits": win.fits,
    }
    obs_journal.event(
        "tune.decision", source="cost_model", key=key,
        n_candidates=len(kept), n_pruned=len(pruned),
        breakdown=win.breakdown, **decision,
    )
    if policy.use_cache:
        try:
            cache_mod.store(key, decision, path=cache_path)
        except OSError:
            pass  # read-only HOME etc. — tuning still worked
    return TuneResult(
        strategy=win.candidate.strategy,
        degrees=win.candidate.degrees_dict,
        grad_accum=win.candidate.grad_accum,
        ranked=ranked, source="cost_model", key=key,
        zero1=bool(win.candidate.zero1),
    )
