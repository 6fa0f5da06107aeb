"""Memory lint: liveness-based per-device peak-memory prediction (ML00x).

A single-pass walk over the traced train step — the same fake-tensor
``make_fx`` trace ``graph_lint`` walks — that predicts the per-device
resident-byte peak **before anything is allocated**:

- *persistent* terms (params, optimizer state, model state, the batch)
  are charged per device through the plan's real ``PartitionSpec``
  mapping × a plain mesh-degrees mapping (``topology.mesh_degrees``
  accepts both), so sharded vs replicated-because-indivisible leaves
  are accounted exactly as the wrappers lay them out;
- the *transient* term walks the graph's nodes in order, tracking each
  storage from the node that makes it to the last node that reads it
  or a view of it (liveness intervals) and taking the max resident
  set.  A view shares its base's storage and is charged once; an
  in-place update of an input (the optimizer's) is the input's own
  storage and is not charged again.  Grad-accum slicing and activation
  checkpointing show up by themselves: the traced step already holds
  the smaller slices, and a checkpointed forward's activations die
  early and are recomputed by forward nodes inside the backward.

The port's traced step (``AutoDistribute.traceable_step``) runs at the
plan's *local* shapes, so its transient walk is per device as it is
(``local=True``); a step traced at global shapes (``check_spec``'s
``fn``, the JAX package's layout) classifies each value by shape —
param-shaped (grads, optimizer temporaries: scaled by the plan's
average param shard fraction), batch-leading (activations: divided by
the batch-axis degree), or other (charged in full) — a deliberate
coarse model; the acceptance bar is "within 2× of the measured peak"
(``AutoDistribute.compile_report``), not exactness.

Everything is device-free: the same classified walk at global shapes
(:func:`activation_profile_from_trace`) feeds the tuner's memory
pruning (``tune/space.py``), scoring hypothetical meshes that were
never built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

from .. import planner as planner_mod
from .. import topology as topo_mod
from . import ERROR, WARN, Finding
from .graph_lint import _graph_of

# Warn (ML002) when the predicted peak lands within this fraction below
# the budget: the estimate is coarse, so a near-miss is a real risk.
DEFAULT_HEADROOM = 0.1

# Transient share of the peak above which "turn on remat" (ML003) is
# worth saying when the budget is already tight.
_ACT_DOMINANT = 0.5

_CLASSES = ("param_like", "batch", "other")


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.2f} TiB"


def _leaf_bytes(leaf: Any) -> int:
    shape = tuple(getattr(leaf, "shape", ()) or ())
    dtype = getattr(leaf, "dtype", torch.float32)
    return (math.prod(shape) if shape else 1) * planner_mod._itemsize(dtype)


def _leaves(tree: Any) -> list:
    """The tensor-like leaves of nested mappings, lists and tuples, in
    order (a mapping in insertion order)."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, planner_mod.PartitionSpec):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


def _storage_key(val: torch.Tensor) -> int:
    return val.untyped_storage()._cdata


def _storage_bytes(val: torch.Tensor) -> int:
    return val.untyped_storage().nbytes()


def _tensors(val: Any) -> list[torch.Tensor]:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _walk_liveness(
    graph: Any,
    mult: Callable[[str], float],
    classify: Callable[[Any], str],
    *,
    skip: frozenset = frozenset(),
) -> tuple[float, dict[str, float]]:
    """(peak_bytes, by_class_at_peak) over an fx graph.

    A storage made by a node is resident from that node to the last
    node that reads it or any view of it (the graph's outputs stay
    resident to the end; a storage nothing reads dies at once); the
    peak is the max over nodes of the resident set.  The inputs'
    storages (``placeholder`` nodes, charged as persistent state) and
    constants never count.  ``mult(class)`` scales a value to per-device
    bytes; ``skip`` holds storage keys charged elsewhere (outputs that
    alias the input state) as zero-size.
    """
    nodes = list(graph.nodes)
    persistent: set[int] = set()
    for node in nodes:
        if node.op in ("placeholder", "get_attr"):
            for t in _tensors(node.meta.get("val")):
                persistent.add(_storage_key(t))
    # storage key -> index of its last reader
    last_use: dict[int, int] = {}
    node_keys: dict[Any, list[int]] = {}
    for i, node in enumerate(nodes):
        keys = [_storage_key(t) for t in _tensors(node.meta.get("val"))]
        node_keys[node] = keys
        for key in keys:
            last_use.setdefault(key, i)
        for arg in node.all_input_nodes:
            for key in node_keys.get(arg, ()):
                last_use[key] = max(last_use.get(key, i), i)
        if node.op == "output":
            for arg in node.all_input_nodes:
                for key in node_keys.get(arg, ()):
                    last_use[key] = len(nodes)
    live: dict[int, tuple[str, float]] = {}
    peak = 0.0
    peak_by_class: dict[str, float] = {}
    for i, node in enumerate(nodes):
        if node.op == "call_function":
            for t in _tensors(node.meta.get("val")):
                key = _storage_key(t)
                if key in persistent or key in live:
                    continue
                cls = classify(t)
                b = 0.0 if key in skip else _storage_bytes(t) * mult(cls)
                live[key] = (cls, b)
        total = sum(b for _, b in live.values())
        if total > peak:
            peak = total
            peak_by_class = {}
            for cls, b in live.values():
                peak_by_class[cls] = peak_by_class.get(cls, 0.0) + b
        for key in [k for k in live if last_use.get(k, i) <= i]:
            live.pop(key)
    return peak, peak_by_class


# -- shape classification ----------------------------------------------------


def _param_shapes(abstract_params: Any) -> frozenset:
    shapes = set()
    for leaf in _leaves(abstract_params):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if shape:
            shapes.add(shape)
    return frozenset(shapes)


def _batch_dims(batch: Any, grad_accum: int) -> frozenset:
    dims = set()
    for leaf in _leaves(batch if batch is not None else {}):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if shape and shape[0] > 1:
            dims.add(int(shape[0]))
            if grad_accum > 1 and shape[0] % grad_accum == 0:
                dims.add(int(shape[0]) // grad_accum)
    return frozenset(dims)


def make_classifier(
    abstract_params: Any, batch: Any, grad_accum: int = 1
) -> Callable[[Any], str]:
    """value -> 'param_like' | 'batch' | 'other'.

    Param-shaped wins (a grad accumulator must never be mistaken for an
    activation just because a weight dim divides the batch size);
    'batch' means the leading dim is a multiple of a batch (or
    microbatch) leading dim, i.e. the value scales with items/device.
    """
    pshapes = _param_shapes(abstract_params)
    bdims = _batch_dims(batch, grad_accum)

    def classify(val: Any) -> str:
        shape = tuple(getattr(val, "shape", ()) or ())
        if shape in pshapes:
            return "param_like"
        if shape and any(
            shape[0] == b or shape[0] % b == 0 for b in bdims if b > 1
        ):
            return "batch"
        return "other"

    return classify


# -- sharded persistent-state accounting -------------------------------------


def _spec_fraction(spec: Any, degrees: Mapping[str, int]) -> int:
    frac = 1
    for ax in planner_mod.spec_axes(spec):
        frac *= int(degrees.get(ax, 1))
    return max(1, frac)


def _spec_leaves(specs: Any) -> list:
    if isinstance(specs, Mapping):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    return [specs]


def sharded_tree_bytes(
    tree: Any, specs: Any, degrees: Mapping[str, int]
) -> tuple[int, int]:
    """(per_device_bytes, global_bytes) of a tree under its spec tree
    (leaves paired in order) — replicated-because-unsharded leaves
    charged in full."""
    per_dev = 0.0
    total = 0
    for spec, leaf in zip(_spec_leaves(specs), _leaves(tree)):
        b = _leaf_bytes(leaf)
        total += b
        per_dev += b / _spec_fraction(spec, degrees)
    return int(per_dev), int(total)


def _shape_fracs(
    abstract_params: Any, specs: Any, degrees: Mapping[str, int]
) -> dict:
    """Param shape -> shard fraction, for charging optimizer-state
    leaves (moment trees mirror the param tree leaf-for-leaf, so a
    shape match inherits the param leaf's sharding)."""
    out: dict = {}
    for spec, leaf in zip(_spec_leaves(specs), _leaves(abstract_params)):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if shape:
            out[shape] = max(out.get(shape, 1), _spec_fraction(spec, degrees))
    return out


def _matched_tree_bytes(tree: Any, shape_fracs: Mapping) -> int:
    """Per-device bytes of a tree whose leaves shard like the param leaf
    of matching shape (unmatched leaves — counts, schedules — stay
    replicated)."""
    per_dev = 0.0
    for leaf in _leaves(tree):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        per_dev += _leaf_bytes(leaf) / shape_fracs.get(shape, 1)
    return int(per_dev)


def _batch_degree(batch_spec: Any, degrees: Mapping[str, int]) -> int:
    deg = 1
    for ax in planner_mod.spec_axes(batch_spec) if batch_spec is not None else ():
        deg *= int(degrees.get(ax, 1))
    return max(1, deg)


# -- the estimate ------------------------------------------------------------


@dataclasses.dataclass
class MemEstimate:
    """Per-device predicted residency, broken down the way ``tadnn
    report`` renders it (params/optimizer/activations/peak)."""

    params_bytes: int
    optimizer_bytes: int
    model_state_bytes: int
    batch_bytes: int
    activation_bytes: int  # transient liveness peak
    peak_bytes: int
    strategy: str
    degrees: dict
    grad_accum: int
    remat: bool
    transient_by_class: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _output_keys(graph: Any) -> frozenset:
    out = [n for n in graph.nodes if n.op == "output"]
    keys = set()
    for node in out:
        for arg in node.all_input_nodes:
            for t in _tensors(arg.meta.get("val")):
                keys.add(_storage_key(t))
    return frozenset(keys)


def estimate_step_memory(
    closed: Any,
    plan: Any,
    abstract_params: Any,
    *,
    opt_state: Any = None,
    model_state: Any = None,
    batch: Any = None,
    grad_accum: int = 1,
    degrees: Mapping[str, int] | None = None,
    donated: bool = True,
    local: bool = False,
) -> MemEstimate:
    """Predict the per-device resident-byte peak of one train step.

    ``closed`` is the traced step (an fx ``GraphModule``) — pass None
    to get the persistent-state terms only.  ``plan`` may be a real
    :class:`planner.ShardPlan` or an abstract one whose mesh is a plain
    degrees mapping (the tuner's hypothetical-mesh path).
    ``abstract_params``, ``opt_state`` and ``batch`` are at global
    shapes.  ``local``: the trace ran at the plan's per-device shapes
    (the port's ``AutoDistribute.traceable_step``), so its values are
    charged as they are, every output that is not an input's storage
    included (the port's functional optimizer makes the new moments
    beside the old ones).  With ``donated`` (the default) a step traced
    at global shapes has its outputs alias the input state, as the JAX
    package's donated step does, so they are not charged a second time.
    """
    deg = topo_mod.mesh_degrees(degrees if degrees is not None else plan.mesh)
    params_pd, params_total = sharded_tree_bytes(
        abstract_params, plan.param_specs, deg)
    param_mult = params_pd / max(1, params_total)
    opt_pd = 0
    if opt_state is not None:
        # under zero1 the optimizer state follows the plan's dedicated
        # opt_spec_tree (moments sharded over 'data'), not the param
        # specs — this is what makes ML001/ML002 predict the ~DP-fold
        # optimizer-memory cut device-free
        opt_specs = getattr(plan, "opt_spec_tree", None)
        if opt_specs is None:
            opt_specs = plan.param_specs
        fracs = _shape_fracs(abstract_params, opt_specs, deg)
        opt_pd = _matched_tree_bytes(opt_state, fracs)
    ms_pd = sum(_leaf_bytes(leaf) for leaf in _leaves(
        model_state if model_state is not None else {}))
    batch_deg = _batch_degree(getattr(plan, "batch_spec", None), deg)
    batch_pd = int(sum(
        _leaf_bytes(leaf)
        for leaf in _leaves(batch if batch is not None else {})
    ) / batch_deg)
    act_pd = 0
    by_class: dict[str, float] = {}
    if closed is not None:
        graph = _graph_of(closed)
        classify = make_classifier(abstract_params, batch, grad_accum)
        mult = ({c: 1.0 for c in _CLASSES} if local else
                {"param_like": param_mult, "batch": 1.0 / batch_deg,
                 "other": 1.0})
        # the port's step updates its parameters in place (their storage
        # is the input's, persistent already) and makes its new optimizer
        # state beside the old one: under ``local`` no output is donated
        skip = (_output_keys(graph) if donated and not local
                else frozenset())
        peak, by_class = _walk_liveness(
            graph, lambda c: mult[c], classify, skip=skip)
        act_pd = int(peak)
    return MemEstimate(
        params_bytes=params_pd,
        optimizer_bytes=opt_pd,
        model_state_bytes=ms_pd,
        batch_bytes=batch_pd,
        activation_bytes=act_pd,
        peak_bytes=params_pd + opt_pd + ms_pd + batch_pd + act_pd,
        strategy=str(getattr(plan, "strategy", "custom")),
        degrees={a: n for a, n in deg.items() if n > 1},
        grad_accum=int(grad_accum),
        remat=bool(getattr(plan, "remat", False)),
        transient_by_class={k: int(v) for k, v in by_class.items()},
    )


def resolve_budget(
    budget: int | str | None = None, device_kind: str | None = None
) -> int:
    """An HBM budget in bytes: explicit int, a size string ('16GiB'),
    or — when None — the detected chip's ``ChipSpec.hbm_bytes``."""
    if budget is not None:
        if isinstance(budget, str):
            return topo_mod.parse_size(budget)
        return int(budget)
    kind = device_kind or topo_mod.detect().device_kind
    return int(topo_mod.chip_spec(kind).hbm_bytes)


def lint_memory(
    est: MemEstimate,
    *,
    budget_bytes: int,
    headroom: float = DEFAULT_HEADROOM,
    where: str = "<step>",
) -> list[Finding]:
    """ML001 (over budget = predicted OOM), ML002 (inside the headroom
    margin), ML003 (tight + activation-dominated with remat off)."""
    findings: list[Finding] = []
    peak = est.peak_bytes
    budget = int(budget_bytes)
    mesh = "×".join(f"{a}{n}" for a, n in sorted(est.degrees.items())) or "1"
    if peak > budget:
        findings.append(Finding(
            "ML001", ERROR, "mem", where,
            f"predicted per-device peak {_fmt_bytes(peak)} exceeds the "
            f"HBM budget {_fmt_bytes(budget)} (strategy "
            f"{est.strategy!r}, mesh {mesh}: params "
            f"{_fmt_bytes(est.params_bytes)} + optimizer "
            f"{_fmt_bytes(est.optimizer_bytes)} + activations "
            f"{_fmt_bytes(est.activation_bytes)}) — this plan would "
            "OOM; shard more, raise grad_accum, or enable remat",
        ))
    elif peak > (1.0 - headroom) * budget:
        findings.append(Finding(
            "ML002", WARN, "mem", where,
            f"predicted per-device peak {_fmt_bytes(peak)} is within "
            f"{headroom:.0%} of the {_fmt_bytes(budget)} budget "
            f"(strategy {est.strategy!r}, mesh {mesh}) — the static "
            "estimate is coarse; XLA scheduling or fragmentation can "
            "push this over",
        ))
    if (
        findings
        and not est.remat
        and est.activation_bytes >= _ACT_DOMINANT * max(1, peak)
    ):
        findings.append(Finding(
            "ML003", WARN, "mem", where,
            f"activations are {est.activation_bytes / max(1, peak):.0%} "
            "of the predicted peak and remat is off — gradient "
            "checkpointing (remat=True) or a larger grad_accum would "
            "cut the transient term",
        ))
    return findings


# -- the tuner-facing profile ------------------------------------------------


def activation_profile_from_trace(
    closed: Any, abstract_params: Any, batch: Any
) -> dict:
    """Classified liveness peak of one traced step at GLOBAL shapes —
    the reusable half of the estimator the tuner rescales per candidate
    (``tune/space.py``): the batch-proportional term scales with
    items/device ÷ grad_accum, the param-shaped term with the
    candidate's param shard fraction, the rest is charged in full."""
    graph = _graph_of(closed)
    classify = make_classifier(abstract_params, batch, 1)
    peak, by_class = _walk_liveness(
        graph, lambda c: 1.0, classify, skip=_output_keys(graph))
    return {
        "peak_bytes": int(peak),
        "batch_bytes": int(by_class.get("batch", 0)),
        "param_like_bytes": int(by_class.get("param_like", 0)),
        "other_bytes": int(by_class.get("other", 0)),
    }


__all__ = [
    "DEFAULT_HEADROOM",
    "MemEstimate",
    "activation_profile_from_trace",
    "estimate_step_memory",
    "lint_memory",
    "make_classifier",
    "resolve_budget",
    "sharded_tree_bytes",
]
