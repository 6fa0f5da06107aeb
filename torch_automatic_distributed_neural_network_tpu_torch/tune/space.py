"""Candidate search space for the parallelism autotuner.

Enumerates every plan the framework could build on this topology:
divisor splits of the device count across strategies (dp / fsdp /
tp_fsdp / ep / ep_fsdp) x tensor degree x grad-accum choice x ZeRO-1
optimizer-state sharding (for meshes with a nontrivial data axis), then
prunes by a per-device memory-fit estimate — params + grads + optimizer
state through the planner's real ``param_spec_tree`` sharding math (so
indivisible dims that stay replicated are charged correctly) plus a
coarse activation estimate.

Everything here is pure shape math over the planner's ``name -> meta
tensor`` mapping (``planner.abstract_params``): candidates are scored on
a degrees *mapping*, never a built ``DeviceMesh``
(``topology.mesh_degrees`` accepts both), so enumeration works for
hypothetical fleets in unit tests.

The PyTorch package's port of the JAX package's ``tune/space.py``.  The
charge follows the JAX package's layout (:func:`charge_view`): JAX stacks
a decoder's layers into one leaf (``[L, ..]``) and keeps an attention
projection's heads apart from ``head_dim`` (``q_proj`` ``[d, H, hd]``,
``tensor`` on ``hd``), where the port holds one ``[H*hd, d]``
``nn.Linear`` weight a layer.  The two layouts put the same axes on a
parameter except where a dim divides in one and not the other (a
``[512]`` bias whose one dim carries ``tensor`` has no dim left for
``fsdp``; its stacked ``[L, 512]`` twin shards ``L``), so the port
scores each candidate on the JAX-layout view of its parameters and ranks
as the JAX tuner does.  ``heads`` ``(n_heads, kv_heads)`` gives the head
counts that split the projections; without it (a model with no attention)
they keep the port's layout.  The port's column split takes whole heads,
so with ``heads`` a tensor degree that does not divide both head counts
is pruned (``planner.make_plan`` would refuse its plan), where the JAX
package keeps it: the one place the candidate lists differ.
"""

from __future__ import annotations

import dataclasses
import math
import re
import warnings
from typing import Any, Mapping, Sequence

import numpy as np

from .. import planner
from .. import topology as topo_mod

# Per-device items assumed when the caller gives no batch: enough that
# compute (not fixed overhead) dominates the analytic step time.
DEFAULT_BATCH_ITEMS = 4096

# Fraction of HBM a candidate's state + activations may claim.
MEMORY_SAFETY = 0.9

# Activation shrink under gradient checkpointing: only boundary
# activations are stored, the rest recomputed in backward.
REMAT_ACT_FACTOR = 0.25


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space: a strategy, its mesh-axis degrees
    (only non-trivial axes listed, ordered like MESH_AXES), a
    grad-accumulation choice, and whether the optimizer state is
    ZeRO-1-sharded over the data axis."""

    strategy: str
    degrees: tuple[tuple[str, int], ...]
    grad_accum: int = 1
    zero1: bool = False

    @property
    def degrees_dict(self) -> dict[str, int]:
        return dict(self.degrees)

    def full_degrees(self) -> dict[str, int]:
        """Degrees over every canonical axis (unlisted axes -> 1)."""
        d = dict(self.degrees)
        return {ax: int(d.get(ax, 1)) for ax in topo_mod.MESH_AXES}

    def label(self) -> str:
        mesh = "x".join(f"{ax}{n}" for ax, n in self.degrees if n > 1)
        s = f"{self.strategy}[{mesh or '1'}]"
        if self.zero1:
            s += "+z1"
        if self.grad_accum > 1:
            s += f"/ga{self.grad_accum}"
        return s


def _degrees_key(strategy: str, degrees: dict[str, int],
                 zero1: bool = False) -> tuple:
    return (strategy,
            tuple(sorted((a, n) for a, n in degrees.items() if n > 1)),
            bool(zero1))


def _as_candidate(strategy: str, degrees: dict[str, int],
                  grad_accum: int, zero1: bool = False) -> Candidate:
    ordered = tuple(
        (ax, int(degrees[ax]))
        for ax in topo_mod.MESH_AXES
        if degrees.get(ax, 1) >= 1 and ax in degrees
    )
    return Candidate(strategy=strategy, degrees=ordered,
                     grad_accum=grad_accum, zero1=zero1)


def _batch_leaves(batch: Any) -> list:
    """The array leaves of a sample batch (a mapping, a sequence or one
    array), in key order."""
    if isinstance(batch, Mapping):
        return [leaf for v in batch.values() for leaf in _batch_leaves(v)]
    if isinstance(batch, (list, tuple)):
        return [leaf for v in batch for leaf in _batch_leaves(v)]
    return [batch] if hasattr(batch, "shape") else []


def _is_integer(dtype: Any) -> bool:
    if hasattr(dtype, "is_floating_point"):  # a torch dtype
        return not (dtype.is_floating_point or dtype.is_complex
                    or str(dtype) == "torch.bool")
    return bool(np.issubdtype(np.dtype(dtype), np.integer))


def estimate_batch_items(batch: Any) -> int:
    """Items per global step implied by a sample batch: tokens for LM
    batches ([B, S] integer ids), leading-dim rows otherwise."""
    best = 1
    for leaf in _batch_leaves(batch):
        shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
        if not shape:
            continue
        if _is_integer(getattr(leaf, "dtype", np.float32)) and len(shape) >= 2:
            best = max(best, shape[0] * shape[1])
        else:
            best = max(best, shape[0])
    return best


def _leaf_bytes(leaf: Any) -> int:
    shape = planner._shape(leaf)
    return ((math.prod(shape) if shape else 1)
            * planner._itemsize(getattr(leaf, "dtype", np.float32)))


_LAYER = re.compile(r"(?:^|\.)layers\.(\d+)\.")


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A parameter's shape and dtype in the charge view."""

    shape: tuple[int, ...]
    dtype: Any


# a strategy's degrees without the fsdp axis' wrappers: the spec
# assignment charge_view starts from (fsdp is placed on the view)
_NO_FSDP = {"fsdp": "dp", "tp_fsdp": "tp", "ep_fsdp": "ep"}


def _head_dims(name: str, shape: tuple[int, ...], entries: list,
               degrees: Mapping[str, int],
               heads: tuple[int, int] | None) -> tuple[list, list] | None:
    """An attention projection in the JAX layout: ``q/k/v`` weight
    ``[d, H, hd]`` and bias ``[H, hd]``, ``o`` weight ``[H, hd, d]``,
    ``tensor`` on ``hd`` where the port's row split carried it and
    ``hd`` divides by its degree (the JAX rule's check).  None for any
    other parameter, or without ``heads``."""
    match = planner._HEAD_PARAMS.search(name)
    if heads is None or match is None:
        return None
    kind, what = match.groups()
    count = heads[1] if kind in ("k_proj", "v_proj") else heads[0]
    if (kind == "o_proj" and what == "bias") or len(shape) != (
            1 if what == "bias" else 2):
        return None
    flat = shape[1] if kind == "o_proj" else shape[0]
    if count < 1 or flat % count:
        return None
    hd = flat // count
    tensor = "tensor" if ("tensor" in planner.spec_axes(planner.P(*entries))
                          and hd % degrees.get("tensor", 1) == 0) else None
    if kind == "o_proj":
        return [count, hd, shape[0]], [None, tensor, None]
    if what == "weight":
        return [shape[1], count, hd], [None, None, tensor]
    return [count, hd], [None, tensor]


def charge_view(
    abstract_params: Mapping[str, Any],
    degrees: Mapping[str, int],
    strategy: str,
    rules: Sequence[planner.Rule] = planner.TRANSFORMER_RULES,
    heads: tuple[int, int] | None = None,
) -> tuple[dict[str, _Leaf], dict[str, Any]]:
    """``(view, specs)``: the parameters in the JAX package's layout and
    the specs its planner gives them there, the input of every charge
    this module and ``tune/cost.py`` make.  The layers ``layers.<i>.X``
    of one shape stack into one ``layers.*.X`` leaf ``[L, ..]``; the
    attention projections split their heads (:func:`_head_dims`); the
    ``tensor`` and ``expert`` dims are the port planner's; ``fsdp`` then
    takes the largest free divisible dim of the view, the layer dim
    included, as the JAX planner's ``_fsdp_spec`` does."""
    base = planner.param_spec_tree(abstract_params, degrees,
                                   _NO_FSDP.get(strategy, strategy), rules)
    groups: dict[str, list[tuple[list, list, Any]]] = {}
    for name, leaf in abstract_params.items():
        shape = planner._shape(leaf)
        entries = list(base[name]) + [None] * (len(shape) - len(base[name]))
        dims = _head_dims(name, shape, entries, degrees, heads)
        if dims is None:
            dims = list(shape), entries
        key = _LAYER.sub(".layers.*.", "." + name)[1:]
        groups.setdefault(key, []).append(
            (dims[0], dims[1], getattr(leaf, "dtype", np.float32)))
    use_fsdp = (strategy in ("fsdp", "tp_fsdp", "ep_fsdp")
                and degrees.get("fsdp", 1) > 1)
    view: dict[str, _Leaf] = {}
    specs: dict[str, Any] = {}

    def put(key: str, shape: list, entries: list, dtype: Any) -> None:
        spec = planner._norm_spec(entries)
        if use_fsdp and shape:
            spec = planner._fsdp_spec(tuple(shape), degrees, existing=spec)
        view[key] = _Leaf(tuple(shape), dtype)
        specs[key] = spec

    for key, members in groups.items():
        first = members[0]
        if "*" in key and all(m[:2] == first[:2] for m in members):
            put(key, [len(members), *first[0]], [None, *first[1]], first[2])
        else:  # layers of different shapes stay apart
            for i, (shape, entries, dtype) in enumerate(members):
                put(key.replace("*", str(i)), shape, entries, dtype)
    return view, specs


def _heads_refusal(degrees: Mapping[str, int],
                   heads: tuple[int, int] | None) -> str | None:
    """Why the port cannot build this tensor degree for these head
    counts (``planner._check_heads``), or None when it can."""
    try:
        planner._check_heads(heads, degrees.get("tensor", 1))
    except ValueError as e:
        return f"heads: {e}"
    return None


def _model_width(abstract_params: Mapping[str, Any]) -> int:
    """Modal trailing dim of matrix params — a d_model estimate."""
    counts: dict[int, int] = {}
    for leaf in abstract_params.values():
        shape = planner._shape(leaf)
        if len(shape) >= 2:
            counts[shape[-1]] = counts.get(shape[-1], 0) + 1
    if not counts:
        return 1
    return max(counts, key=lambda k: (counts[k], k))


def activation_bytes(
    abstract_params: Mapping[str, Any],
    items_per_device: float,
    *,
    itemsize: int = 4,
    remat: bool = False,
) -> int:
    """Coarse per-device activation estimate.

    Every matmul writes one activation row per item; total activation
    elements per item ~ param_count / d_model (exact for a stack of
    square-ish matmuls, order-of-magnitude elsewhere — which is all a
    fit *estimate* needs).
    """
    param_count = sum(
        math.prod(planner._shape(leaf) or (1,))
        for leaf in abstract_params.values()
    )
    per_item = param_count / max(1, _model_width(abstract_params))
    est = itemsize * items_per_device * per_item
    return int(est * (REMAT_ACT_FACTOR if remat else 1.0))


def _profiled_activation_bytes(
    act_profile: dict,
    items_per_device: float,
    *,
    remat: bool,
    param_frac: float,
) -> int:
    """Per-device transient bytes from a liveness profile: the traced
    batch-proportional term rescales linearly to this candidate's
    items/device, param-shaped transients (grads, optimizer
    temporaries) scale with the candidate's average param shard
    fraction, the remainder is charged in full
    (``AutoDistribute.activation_profile`` makes the profile)."""
    key = "remat" if (remat and act_profile.get("remat")) else "noremat"
    prof = act_profile.get(key) or act_profile.get("noremat") or {}
    n0 = max(1, int(act_profile.get("batch_items") or 1))
    est = (
        prof.get("batch_bytes", 0) * (items_per_device / n0)
        + prof.get("param_like_bytes", 0) * param_frac
        + prof.get("other_bytes", 0)
    )
    return int(est)


def candidate_memory(
    abstract_params: Mapping[str, Any],
    cand: Candidate,
    *,
    state_factor: float = 4.0,
    batch_items: int | None = None,
    rules: Sequence[planner.Rule] = planner.TRANSFORMER_RULES,
    remat: bool = True,
    act_profile: dict | None = None,
    heads: tuple[int, int] | None = None,
) -> dict:
    """Per-device memory estimate for a candidate, via the planner's
    spec assignment on the JAX-layout view (:func:`charge_view`;
    replicated-because-indivisible dims are charged in full).

    With ``act_profile`` (a liveness profile of the *real* step) the
    activation term comes from measured liveness intervals rescaled to
    this candidate; without it, from the coarse param-count heuristic
    (:func:`activation_bytes`).
    """
    degrees = cand.full_degrees()
    view, specs = charge_view(abstract_params, degrees, cand.strategy,
                              rules, heads)

    def sharded_bytes(spec_tree: Mapping[str, Any]) -> float:
        acc = 0.0
        for name, leaf in view.items():
            frac = 1
            for ax in planner.spec_axes(spec_tree[name]):
                frac *= degrees.get(ax, 1)
            acc += _leaf_bytes(leaf) / max(1, frac)
        return acc

    total_b = float(sum(_leaf_bytes(leaf)
                        for leaf in abstract_params.values()))
    param_b = sharded_bytes(specs)
    if cand.zero1 and degrees.get("data", 1) > 1:
        # split state_factor: params + grads stay at the param sharding
        # (factor capped at 2), optimizer moments (the remainder — exact
        # 2.0 for uniform fp32 adam, conservative for mixed-precision
        # factors) are charged at the zero1 opt-spec sharding instead
        opt_tree = planner.zero1_spec_tree(view, degrees, specs)
        moment_factor = max(0.0, state_factor - 2.0)
        state_b = (min(state_factor, 2.0) * param_b
                   + moment_factor * sharded_bytes(opt_tree))
    else:
        state_b = state_factor * param_b
    batch_deg = math.prod(
        degrees.get(a, 1) for a in ("data", "fsdp", "expert")
    )
    items = (batch_items or DEFAULT_BATCH_ITEMS) / max(1, batch_deg)
    items /= max(1, cand.grad_accum)
    if act_profile:
        act_b = _profiled_activation_bytes(
            act_profile, items, remat=remat,
            param_frac=param_b / max(1.0, total_b))
    else:
        act_b = activation_bytes(abstract_params, items, remat=remat)
    return {
        "param_bytes": int(param_b),
        "state_bytes": int(state_b),
        "activation_bytes": int(act_b),
        "total_bytes": int(state_b + act_b),
        "profiled": bool(act_profile),
    }


def hbm_budget(topo: topo_mod.Topology, safety: float = MEMORY_SAFETY) -> int:
    return int(safety * topo.chip.hbm_bytes)


def enumerate_candidates(
    abstract_params: Mapping[str, Any],
    topo: topo_mod.Topology,
    *,
    rules: Sequence[planner.Rule] = planner.TRANSFORMER_RULES,
    grad_accums: Sequence[int] = (1,),
    max_tensor: int = 8,
    state_factor: float = 4.0,
    batch_items: int | None = None,
    safety: float = MEMORY_SAFETY,
    act_profile: dict | None = None,
    zero1: bool = True,
    heads: tuple[int, int] | None = None,
) -> tuple[list[Candidate], list[tuple[Candidate, str]]]:
    """(kept, pruned) candidates for this model on this topology.

    ``kept`` passes the per-device memory-fit estimate and, with
    ``heads``, has a tensor degree the port can build; ``pruned``
    carries a human-readable reason per dropped candidate so the CLI
    can show *why* the space shrank.
    """
    n = topo.num_devices
    raw: list[tuple[str, dict[str, int]]] = []
    seen: set = set()

    def add(strategy: str, degrees: dict[str, int]) -> None:
        key = _degrees_key(strategy, degrees)
        if key not in seen and math.prod(degrees.values()) == n:
            seen.add(key)
            raw.append((strategy, degrees))

    divisors = [d for d in range(1, n + 1) if n % d == 0]
    add("dp", {"data": n})
    if n > 1:
        add("fsdp", {"fsdp": n})
    if planner.tp_applicable(abstract_params, rules):
        for t in divisors:
            if 2 <= t <= max_tensor and n // t >= 2:
                add("tp_fsdp", {"tensor": t, "fsdp": n // t})
    if heads is None and any(s == "tp_fsdp" for s, _ in raw) and any(
            planner._HEAD_PARAMS.search(name) for name in abstract_params):
        warnings.warn(
            "tune: attention projections without heads=(n_heads, "
            "kv_heads): no tensor degree is checked against the head "
            "counts and the projections are charged flat; make_plan and "
            "AutoDistribute pass the model's", stacklevel=2)
    e_count = planner.detect_expert_count(abstract_params)
    if e_count:
        g = math.gcd(n, e_count)
        for e in divisors:
            if e >= 2 and g % e == 0:
                add("ep", {"expert": e, "data": n // e})
                if n // e >= 2:
                    add("ep_fsdp", {"expert": e, "fsdp": n // e})

    budget = hbm_budget(topo, safety)
    kept: list[Candidate] = []
    pruned: list[tuple[Candidate, str]] = []
    for strategy, degrees in raw:
        # a nontrivial data axis admits a ZeRO-1 variant: same mesh,
        # optimizer moments sharded over 'data' (arxiv 2004.13336)
        z1_opts = ((False, True) if zero1 and degrees.get("data", 1) > 1
                   else (False,))
        refusal = _heads_refusal(degrees, heads)
        for ga, z1 in ((g, z) for g in grad_accums for z in z1_opts):
            cand = _as_candidate(strategy, degrees, int(ga), zero1=z1)
            if refusal:
                pruned.append((cand, refusal))
                continue
            mem = candidate_memory(
                abstract_params, cand, state_factor=state_factor,
                batch_items=batch_items, rules=rules,
                act_profile=act_profile, heads=heads,
            )
            if mem["total_bytes"] > budget:
                kind = "liveness" if act_profile else "heuristic"
                pruned.append((cand, (
                    f"memory: ~{mem['total_bytes'] / 2**30:.2f} GiB "
                    f"(state {mem['state_bytes'] / 2**30:.2f} + act "
                    f"{mem['activation_bytes'] / 2**30:.2f}, {kind}) "
                    f"> budget {budget / 2**30:.2f} GiB")))
            else:
                kept.append(cand)
    return kept, pruned
