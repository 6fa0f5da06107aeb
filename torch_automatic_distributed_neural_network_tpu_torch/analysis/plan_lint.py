"""Plan lint: pure checks on ``ShardPlan`` × mesh degrees (PL00x).

Everything here is a function of abstract shapes, PartitionSpecs and a
plain ``{axis: degree}`` mapping (``topology.mesh_degrees`` accepts both
a ``DeviceMesh`` and a mapping), so a bad plan is caught before the
model is wrapped — and is unit-testable with no devices at all.  The
port's spec tree is the planner's flat ``name -> PartitionSpec``
mapping (nested mappings are walked with ``/``-joined paths), its
abstract params any leaves with ``.shape`` and ``.dtype`` (meta or fake
tensors).

What runtime failure each rule front-runs:

- PL001 (divisibility): the wrappers reject the layout with an opaque
  shape error when the model is wrapped, or pad it unevenly.  Caught
  here with the param path and the offending axis degrees.
- PL002/PL003 (duplicate / unknown axis): DeviceMesh resolution raises
  deep inside the wrapper; here it names the leaf.
- PL004 (dead axis): devices sit idle — an N× throughput bug that
  produces no error at all.
- PL005 (large replicated leaf): the silent multi-GB replication that
  only surfaces as an OOM at init.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

from .. import planner as planner_mod
from ..planner import PartitionSpec as P
from .. import topology as topo_mod
from . import ERROR, WARN, Finding

# Fallback PL005 threshold when the rule table carries none — the live
# default is RULES['PL005'].threshold (override per call with
# big_leaf_bytes= / `tadnn check --pl005-bytes`).
BIG_LEAF_BYTES = 64 * 2**20


def _pl005_threshold(big_leaf_bytes: int | None) -> int:
    if big_leaf_bytes is not None:
        return int(big_leaf_bytes)
    from . import RULES

    t = RULES["PL005"].threshold
    return int(t) if t is not None else BIG_LEAF_BYTES

# Axes that legitimately never appear in a *param* spec: they carry
# activations (context parallelism) — not dead just because no leaf or
# batch entry names them.
_ACTIVATION_ONLY_AXES = frozenset({"seq"})

# Strategies whose contract is "large params do not stay replicated".
_SHARDING_STRATEGIES = frozenset(
    {"fsdp", "tp", "tp_fsdp", "ep_fsdp", "ep_tp"}
)


def _leaf_bytes(leaf: Any) -> int:
    shape = tuple(getattr(leaf, "shape", ()))
    return (math.prod(shape) if shape else 1) * planner_mod._itemsize(
        getattr(leaf, "dtype", "float32"))


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a name-keyed tree in key order (the JAX
    package's tree order), a PartitionSpec a leaf; nested mappings join
    their keys with ``/``."""
    if isinstance(tree, P) or not isinstance(tree, Mapping):
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for k, v in sorted(tree.items()):
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _dim_axes(entry: Any) -> tuple[str, ...]:
    """Axis names of one PartitionSpec dim entry (None -> ())."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(a for a in entry if a)
    return (entry,)


def lint_specs(
    param_specs: Any,
    batch_spec: P | None,
    degrees: Mapping[str, int],
    strategy: str,
    abstract_params: Any | None = None,
    *,
    big_leaf_bytes: int | None = None,
) -> list[Finding]:
    """The pure core: lint a spec tree against a degrees mapping.

    ``abstract_params`` (pytree of ``.shape``/``.dtype`` leaves, same
    structure as ``param_specs``) enables the shape-dependent rules
    (PL001 divisibility, PL005 big replicated leaves); without it only
    the shape-free rules run.
    """
    degrees = topo_mod.mesh_degrees(degrees)
    big_leaf_bytes = _pl005_threshold(big_leaf_bytes)
    findings: list[Finding] = []
    flat_specs = _flatten(param_specs)
    leaves_by_path: dict[str, Any] = {}
    if abstract_params is not None:
        leaves_by_path = dict(_flatten(abstract_params))
        if len(leaves_by_path) != len(flat_specs):
            findings.append(Finding(
                "PL001", ERROR, "plan", "<tree>",
                f"param_specs ({len(flat_specs)} leaves) does not match "
                f"abstract_params ({len(leaves_by_path)} leaves)",
            ))
            leaves_by_path = {}

    used_axes: set[str] = set()
    for path, spec in flat_specs:
        if not isinstance(spec, P):
            findings.append(Finding(
                "PL003", ERROR, "plan", path,
                f"param spec is {type(spec).__name__}, not a "
                "PartitionSpec",
            ))
            continue
        seen_in_spec: set[str] = set()
        leaf = leaves_by_path.get(path)
        shape = tuple(getattr(leaf, "shape", ())) if leaf is not None else None
        for d, entry in enumerate(spec):
            axes = _dim_axes(entry)
            for ax in axes:
                if ax in seen_in_spec:
                    findings.append(Finding(
                        "PL002", ERROR, "plan", path,
                        f"mesh axis {ax!r} appears twice in {spec} — "
                        "one device set cannot shard two dims",
                    ))
                if ax not in degrees:
                    findings.append(Finding(
                        "PL003", ERROR, "plan", path,
                        f"spec {spec} names mesh axis {ax!r} but the "
                        f"mesh has only {sorted(degrees)}",
                    ))
                seen_in_spec.add(ax)
                used_axes.add(ax)
            size = math.prod(degrees.get(a, 1) for a in axes)
            if shape is not None and size > 1:
                if d >= len(shape):
                    findings.append(Finding(
                        "PL001", ERROR, "plan", path,
                        f"spec {spec} shards dim {d} but the param has "
                        f"only {len(shape)} dims {shape}",
                    ))
                elif shape[d] % size:
                    findings.append(Finding(
                        "PL001", ERROR, "plan", path,
                        f"dim {d} of shape {shape} is not divisible by "
                        f"{'×'.join(axes)}={size} — pjit will reject "
                        "this sharding at compile time",
                    ))
        if (
            shape is not None
            and strategy in _SHARDING_STRATEGIES
            and not seen_in_spec
            and _leaf_bytes(leaf) > big_leaf_bytes
        ):
            findings.append(Finding(
                "PL005", WARN, "plan", path,
                f"{_leaf_bytes(leaf) / 2**20:.1f} MiB leaf (> threshold "
                f"{big_leaf_bytes / 2**20:.1f} MiB) is fully "
                f"replicated under strategy {strategy!r} — every device "
                "holds a full copy (silent HBM cost); add a sharding "
                "rule or check axis divisibility",
            ))

    if batch_spec is not None:
        for entry in batch_spec:
            for ax in _dim_axes(entry):
                if ax not in degrees:
                    findings.append(Finding(
                        "PL003", ERROR, "plan", "<batch>",
                        f"batch spec {batch_spec} names mesh axis "
                        f"{ax!r} but the mesh has only {sorted(degrees)}",
                    ))
                used_axes.add(ax)

    for ax, n in degrees.items():
        if n > 1 and ax not in used_axes and ax not in _ACTIVATION_ONLY_AXES:
            findings.append(Finding(
                "PL004", WARN, "plan", f"<mesh axis {ax!r}>",
                f"mesh axis {ax!r} has degree {n} but no param or batch "
                "spec ever uses it — those devices replicate everything "
                f"({n}× throughput left on the table)",
            ))
    return findings


def lint_plan(
    plan: planner_mod.ShardPlan,
    abstract_params: Any | None = None,
    *,
    big_leaf_bytes: int | None = None,
) -> list[Finding]:
    """Lint a planner-built (or hand-built) :class:`ShardPlan`."""
    return lint_specs(
        plan.param_specs,
        plan.batch_spec,
        plan.degrees,
        plan.strategy,
        abstract_params,
        big_leaf_bytes=big_leaf_bytes,
    )
