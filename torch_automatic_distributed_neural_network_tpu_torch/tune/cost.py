"""Analytic roofline step-time model for ranking tuner candidates.

Per candidate: build the *abstract* plan (the planner's pure functions
accept a degrees mapping in place of a mesh), take its
``expected_collective_bytes``, and combine three roofline terms with
per-link numbers from :class:`topology.ChipSpec`:

- compute: 6 * params * items FLOPs (fwd 2PN + bwd 4PN; +1/3 re-forward
  under remat), spread over all devices — or a caller-supplied FLOPs
  count when one exists;
- comms: the planner's ring-formula wire bytes per category, each
  riding the link inside a host (NVLink) or between hosts
  (InfiniBand) depending on whether its mesh axis crosses hosts
  (``topology.hybrid_factorization``), plus per-hop link latency — the
  multihost penalty;
- HBM: parameter + optimizer-state + activation traffic against the
  chip's HBM bandwidth.

step_time = max(compute, hbm) + comms + latency.  The absolute numbers
are coarse; what the tuner needs is the *ordering*, and the ordering is
driven by terms the model does capture (dp's 2(n-1)/n allreduce vs
ZeRO-3's 3(n-1)/n gather+scatter, between hosts vs inside one, memory
fit).

The PyTorch package's copy of the JAX package's ``tune/cost.py``, on the
port's ``ShardPlan``, ``batch_partition_spec``, ``zero1_spec_tree`` and
``expected_collective_bytes``, applied to the JAX-layout view of the
parameters (``space.charge_view``).  The chip numbers are the port's
table's (``topology._CHIP_SPECS``: the H100's for a card); a topology's
"ici" is its NVLink and its "dcn" the network between hosts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np

from .. import planner
from .. import topology as topo_mod
from .space import (
    Candidate,
    DEFAULT_BATCH_ITEMS,
    candidate_memory,
    charge_view,
    hbm_budget,
)

# Which mesh axes each comm category of expected_collective_bytes rides.
_CATEGORY_AXES = {
    "grad_allreduce": ("data", "expert"),
    "param_allgather": ("fsdp",),
    "grad_reduce_scatter": ("fsdp",),
    "zero1_grad_reduce_scatter": ("data",),
    "zero1_param_allgather": ("data",),
}

# Fraction of peak the analytic model assumes achievable (matmul
# efficiency / collective overlap are not modeled per-op).
_EFFICIENCY = 0.5


@dataclasses.dataclass
class CostEstimate:
    """A candidate with its modeled step time and full breakdown."""

    candidate: Candidate
    step_time_s: float
    fits: bool
    breakdown: dict

    def to_json(self) -> dict:
        return {
            "strategy": self.candidate.strategy,
            "mesh": self.candidate.degrees_dict,
            "grad_accum": self.candidate.grad_accum,
            "zero1": bool(self.candidate.zero1),
            "step_time_ms": round(self.step_time_s * 1e3, 4),
            "fits": self.fits,
            "breakdown": self.breakdown,
        }


def _param_count(abstract_params: Mapping[str, Any]) -> int:
    return sum(
        math.prod(planner._shape(leaf) or (1,))
        for leaf in abstract_params.values()
    )


def _dcn_axes(topo: topo_mod.Topology, degrees: dict) -> set[str]:
    """Mesh axes whose collectives cross hosts (ride the network)."""
    if not topo.is_multislice:
        return set()
    fact = topo_mod.hybrid_factorization(degrees, topo.num_slices)
    if fact is None:
        # flat-mesh fallback: every nontrivial axis may cross hosts
        return {ax for ax, d in degrees.items() if d > 1}
    _, dcn_shape = fact
    return {
        ax for ax, d in zip(topo_mod.MESH_AXES, dcn_shape) if d > 1
    }


def score(
    abstract_params: Mapping[str, Any],
    topo: topo_mod.Topology,
    cand: Candidate,
    *,
    rules: Sequence[planner.Rule] = planner.TRANSFORMER_RULES,
    state_factor: float = 4.0,
    batch_items: int | None = None,
    grad_dtype: Any = np.float32,
    flops_total: float | None = None,
    safety: float | None = None,
    act_profile: dict | None = None,
    measured_overlap: float | None = None,
    heads: tuple[int, int] | None = None,
) -> CostEstimate:
    """Roofline step-time estimate for one candidate.

    ``flops_total`` overrides the analytic 6*P*N FLOPs estimate with a
    measured one when the caller has one; ``act_profile`` swaps the
    activation heuristic for a liveness profile
    (``space.candidate_memory``).

    ``measured_overlap`` corrects the model's worst-case comm term with
    a measured exposed-collective fraction from a trace
    (``obs.trace.exposed_fraction``): the model charges every wire byte
    as serial time, but the schedule hides part of it behind compute,
    so a traced run can feed back "only 30% was exposed" and the comm
    term shrinks to match.  Clamped to [0, 1]; None keeps the worst
    case.
    """
    chip = topo.chip
    degrees = cand.full_degrees()
    items = batch_items or DEFAULT_BATCH_ITEMS
    remat = cand.strategy in ("fsdp", "tp_fsdp", "ep_fsdp")

    view, specs = charge_view(abstract_params, degrees, cand.strategy,
                              rules, heads)
    zero1 = bool(cand.zero1) and degrees.get("data", 1) > 1
    # abstract plan: mesh is the degrees mapping, which every planner
    # pure function accepts (topology.mesh_degrees)
    plan = planner.ShardPlan(
        mesh=degrees,
        strategy=cand.strategy,
        param_specs=specs,
        batch_spec=planner.batch_partition_spec(degrees),
        remat=remat,
        zero1=zero1,
        opt_spec_tree=(planner.zero1_spec_tree(view, degrees, specs)
                       if zero1 else None),
    )
    comm = planner.expected_collective_bytes(
        plan, view, grad_dtype=grad_dtype, grad_accum=cand.grad_accum,
    )

    pcount = _param_count(abstract_params)
    flops = flops_total if flops_total else 6.0 * pcount * items
    if remat:
        flops *= 4.0 / 3.0  # one extra forward in backward
    compute_s = flops / topo.num_devices / (chip.flops_per_s * _EFFICIENCY)

    dcn = _dcn_axes(topo, degrees)
    comm_s = 0.0
    latency_s = 0.0
    comm_detail: dict[str, dict] = {}
    for cat, vals in comm["per_device"].items():
        wire = float(vals["wire_bytes"])
        if not wire:
            continue
        axes = [a for a in _CATEGORY_AXES.get(cat, ())
                if degrees.get(a, 1) > 1]
        on_dcn = any(a in dcn for a in axes)
        bw = chip.dcn_bytes_per_s if on_dcn else chip.ici_bytes_per_s
        lat = chip.dcn_latency_s if on_dcn else chip.ici_latency_s
        hops = max(
            (degrees.get(a, 1) for a in axes), default=topo.num_devices
        ) - 1
        t = wire / bw
        l = hops * lat * cand.grad_accum
        comm_s += t
        latency_s += l
        comm_detail[cat] = {
            "wire_bytes": int(wire),
            "link": "dcn" if on_dcn else "ici",
            "s": t + l,
        }

    mem = candidate_memory(
        abstract_params, cand, state_factor=state_factor,
        batch_items=items, rules=rules, remat=remat,
        act_profile=act_profile, heads=heads,
    )
    # fwd+bwd read params twice, optimizer reads+writes state once each
    hbm_traffic = (4.0 * mem["param_bytes"] + 2.0 * mem["state_bytes"]
                   + 2.0 * mem["activation_bytes"])
    hbm_s = hbm_traffic / chip.hbm_bytes_per_s

    budget = hbm_budget(topo) if safety is None else int(
        safety * chip.hbm_bytes)
    fits = mem["total_bytes"] <= budget
    if measured_overlap is not None:
        # latency (per-hop setup) cannot be hidden; only the wire time
        # scales with how much of the collective was actually exposed
        comm_s *= min(1.0, max(0.0, measured_overlap))
    step = max(compute_s, hbm_s) + comm_s + latency_s
    return CostEstimate(
        candidate=cand,
        step_time_s=step,
        fits=fits,
        breakdown={
            "compute_ms": round(compute_s * 1e3, 4),
            "comm_ms": round(comm_s * 1e3, 4),
            "latency_ms": round(latency_s * 1e3, 4),
            "hbm_ms": round(hbm_s * 1e3, 4),
            "comm": comm_detail,
            "memory": mem,
            "hbm_budget_bytes": budget,
            "remat": remat,
            "flops_per_device": flops / topo.num_devices,
            "flops_source": "measured" if flops_total else "analytic_6PN",
            **({"measured_overlap": round(
                min(1.0, max(0.0, measured_overlap)), 4)}
               if measured_overlap is not None else {}),
        },
    )


def overlap_from_trace(trace_steps: Sequence[dict]) -> float | None:
    """Measured exposed-collective fraction over ``trace.step`` records
    (journal dicts or ``obs.trace.attribute`` output) — the value to
    feed back as ``score(measured_overlap=...)``.  None when the trace
    saw no collectives."""
    from ..obs.trace import exposed_fraction

    return exposed_fraction(trace_steps)


def rank(
    abstract_params: Mapping[str, Any],
    topo: topo_mod.Topology,
    candidates: Sequence[Candidate],
    **kwargs,
) -> list[CostEstimate]:
    """Score every candidate and sort best-first (fitting plans always
    rank above non-fitting ones, then by modeled step time)."""
    ests = [score(abstract_params, topo, c, **kwargs) for c in candidates]
    ests.sort(key=lambda e: (not e.fits, e.step_time_s))
    return ests
