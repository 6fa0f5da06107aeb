"""Graph lint: trace the train step to an fx graph and walk it (GL00x).

Trace only — :func:`trace_step` runs the Python of the step function
under ``make_fx(fn, tracing_mode="fake")``: every tensor is a
``FakeTensor`` (shapes, types and devices, no memory), the hand-written
kernels answer through their fake implementations (one node each,
``tadnn.flash_forward`` …), and nothing runs on any device, so this layer
is cheap enough to run as a preflight on every Trainer start.  The fx
``Graph`` takes the place of the JAX package's closed jaxpr and
``node.meta["val"]`` the place of an aval.

The collective inventory covers the collectives that run in the traced
Python: the ``_c10d_functional.*`` ops (``torch.distributed.
_functional_collectives``) and the ``c10d.*`` ones (``torch.distributed.
all_reduce`` and kin).  The port's traced step (``AutoDistribute.
traceable_step``) runs a plan's data and fsdp traffic that way — the
gradients' all-reduce over the batch axes, fsdp's parameter all-gather
and gradient reduce-scatter — where the real step leaves it to DDP's
C++ reducer and FSDP2's hooks, which a trace would not see (the port's
counterpart of "GSPMD collectives live below the jaxpr").  The
cross-check direction is the JAX package's: any collective over a mesh
axis where the plan's analytic model (``planner.expected_collective_bytes``)
predicts no traffic of that kind is a reshard the planner did not ask
for → GL002.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, Mapping

import torch

from .. import planner as planner_mod
from .. import topology as topo_mod
from . import ERROR, WARN, Finding

# collective op name (namespace and overload dropped) -> the kind the
# allowance table keys on
COLLECTIVE_KINDS: dict[str, str] = {
    "all_gather_into_tensor": "gather",
    "all_gather_into_tensor_coalesced": "gather",
    "allgather_": "gather",
    "_allgather_base_": "gather",
    "allgather_coalesced_": "gather",
    "allgather_into_tensor_coalesced_": "gather",
    "broadcast": "gather",
    "broadcast_": "gather",
    "all_reduce": "reduce",
    "all_reduce_coalesced": "reduce",
    "allreduce_": "reduce",
    "allreduce_coalesced_": "reduce",
    "reduce_": "reduce",
    "reduce_scatter_tensor": "scatter",
    "reduce_scatter_tensor_coalesced": "scatter",
    "reduce_scatter_": "scatter",
    "_reduce_scatter_base_": "scatter",
    "all_to_all_single": "a2a",
    "alltoall_": "a2a",
    "alltoall_base_": "a2a",
    "send": "permute",
    "recv_": "permute",
}

# the namespaces whose ops are collectives
_COLLECTIVE_NS = ("_c10d_functional", "c10d")

# Host syncs: each one is a device->host round trip in the middle of
# the step (the torch counterpart of a jaxpr's debug_callback).  Under
# fake tracing the value does not exist, so :func:`trace_step` records
# the sync and hands the step a stand-in instead.
HOST_EFFECT_OPS = frozenset({"_local_scalar_dense", "is_nonzero", "equal"})


def op_name(node: Any) -> str:
    """The op name of a ``call_function`` node: ``aten.mm.default`` ->
    ``mm``, ``tadnn.flash_forward.default`` -> ``flash_forward``."""
    target = node.target
    name = getattr(target, "__name__", None) or str(target)
    parts = str(target).split(".")
    if len(parts) >= 3 and parts[0] in ("aten", "prims", "tadnn",
                                        "_c10d_functional", "c10d"):
        return parts[1]
    return name.split(".")[0]


def op_namespace(node: Any) -> str:
    """``aten``, ``tadnn``, ``c10d`` … of a ``call_function`` node."""
    return str(node.target).split(".")[0]


class _HostSyncs(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each host sync of the traced Python (``.item()``,
    ``.tolist()``, ``bool(t)``, ``.cpu()`` of a device tensor) and
    answers it with a stand-in so the trace goes on: a data-dependent
    value of a fake tensor would end it."""

    def __init__(self):
        super().__init__()
        self.syncs: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if name in HOST_EFFECT_OPS:
            self.syncs.append(name)
            t = args[0]
            if name == "_local_scalar_dense":
                return (False if t.dtype == torch.bool else
                        0.0 if t.dtype.is_floating_point else 0)
            return False
        if (name == "_to_copy" and isinstance(args[0], torch.Tensor)
                and args[0].device.type != "cpu"
                and torch.device(kwargs.get("device") or args[0].device).type
                == "cpu"):
            self.syncs.append("_to_copy(cpu)")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _eager_checkpointing():
    """Activation checkpointing as it runs eagerly: under a proxy mode
    ``torch.utils.checkpoint`` takes itself to be compiling and saves
    every activation for a compiler's partitioner to decide, so a trace
    would show no recompute; the port's step runs eagerly and recomputes
    (a rematted layer's K1 twice), which is what the trace must hold."""
    import torch.utils.checkpoint as ckpt

    saved = getattr(ckpt, "_is_compiling", None)
    if saved is None:
        yield
        return
    ckpt._is_compiling = lambda *a, **k: False
    try:
        yield
    finally:
        ckpt._is_compiling = saved


def trace_step(fn: Any, *args: Any, **kwargs: Any):
    """Trace ``fn`` to an fx ``GraphModule`` from fake (or real) args —
    the nothing-materialized entry the preflight uses.  Real tensors in
    ``args`` are converted to fake ones (their data is never read); the
    host syncs met on the way are kept in ``gm.meta["host_syncs"]``.
    Activation checkpointing recomputes as it does eagerly."""
    from torch.fx.experimental.proxy_tensor import make_fx

    syncs = _HostSyncs()

    def traced(*a):
        with syncs:
            return fn(*a, **kwargs)

    with _eager_checkpointing():
        gm = make_fx(traced, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
    gm.meta["host_syncs"] = list(syncs.syncs)
    return gm


def _graph_of(obj: Any):
    if isinstance(obj, torch.fx.GraphModule):
        return obj.graph
    if isinstance(obj, torch.fx.Graph):
        return obj
    return None


def iter_eqns(closed: Any) -> Iterator[Any]:
    """Every ``call_function`` node of a traced step, in order (the
    jaxpr's equations; an fx graph from ``make_fx`` is flat)."""
    graph = _graph_of(closed)
    if graph is None:
        return
    for node in graph.nodes:
        if node.op == "call_function":
            yield node


def _val_bytes(val: Any) -> int:
    if isinstance(val, torch.Tensor):
        return (math.prod(val.shape) if val.dim() else 1) * (
            val.element_size())
    if isinstance(val, (list, tuple)):
        return sum(_val_bytes(v) for v in val)
    return 0


def _meta(arg: Any) -> Any:
    if isinstance(arg, torch.fx.Node):
        return arg.meta.get("val")
    if isinstance(arg, (list, tuple)):
        return [_meta(a) for a in arg]
    return None


def _out_bytes(node: Any) -> int:
    """Bytes of a collective's result: its value (functional ops) or its
    output buffer, the first argument (the in-place ``c10d`` ops)."""
    if op_namespace(node) == "c10d":
        return _val_bytes(_meta(node.args[0]))
    return _val_bytes(node.meta.get("val"))


def _group_name(node: Any, gm: Any) -> str | None:
    """The process group's name a collective node runs over."""
    if op_namespace(node) == "_c10d_functional":
        names = [a for a in node.args if isinstance(a, str)]
        return names[-1] if names else None
    for a in node.args:
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            obj = getattr(gm, a.target, None)
            try:  # the trace holds the group as a TorchScript object
                obj = torch.distributed.ProcessGroup.unbox(obj)
            except Exception:  # noqa: BLE001 — a group already, or none
                pass
            name = getattr(obj, "group_name", None)
            if name is not None:
                return str(name)
    return None


def group_axes(mesh: Any) -> dict[str, tuple[str, ...]]:
    """Process-group name -> the mesh axes it spans, for a
    ``DeviceMesh`` (a degrees mapping has no groups): each axis's group,
    and the world's (every axis above 1)."""
    out: dict[str, tuple[str, ...]] = {}
    dist = torch.distributed
    if mesh is None or isinstance(mesh, Mapping):
        degrees = topo_mod.mesh_degrees(mesh) if mesh is not None else {}
    else:
        degrees = topo_mod.mesh_degrees(mesh)
        for ax in mesh.mesh_dim_names:
            out[str(mesh.get_group(ax).group_name)] = (ax,)
    if dist.is_available() and dist.is_initialized():
        live = tuple(a for a, n in degrees.items() if n > 1)
        out.setdefault(str(dist.group.WORLD.group_name), live or ("world",))
    return out


def _axis_names(node: Any, gm: Any, groups: Mapping) -> tuple[str, ...]:
    name = _group_name(node, gm)
    if name is None:
        return ()
    return tuple(groups.get(name, (f"group:{name}",)))


def collective_inventory(closed: Any, mesh: Any = None) -> list[dict]:
    """Aggregate the collectives in a traced step.

    Returns one record per (op, axes) pair: ``{"prim", "kind", "axes",
    "count", "bytes"}`` — ``bytes`` is the summed result-buffer size.
    ``mesh`` (the plan's ``DeviceMesh``) names each op's process group
    by its mesh axes; without one a group is ``group:<name>`` (the
    world's: the live axes, else ``world``)."""
    groups = group_axes(mesh)
    agg: dict[tuple[str, tuple[str, ...]], dict] = {}
    for node in iter_eqns(closed):
        if op_namespace(node) not in _COLLECTIVE_NS:
            continue
        name = op_name(node)
        kind = COLLECTIVE_KINDS.get(name)
        if kind is None:
            continue
        axes = _axis_names(node, closed, groups)
        rec = agg.setdefault(
            (name, axes), {"prim": name, "kind": kind, "axes": axes,
                           "count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += _out_bytes(node)
    return list(agg.values())


def _allowed_axes(plan: planner_mod.ShardPlan,
                  abstract_params: Any | None) -> dict[str, set[str]]:
    """Per-collective-kind mesh axes the plan's analytic comms model
    accounts for (either as param/grad traffic or as a declared
    ``model_dependent`` unknown in ``expected_collective_bytes``)."""
    degrees = topo_mod.mesh_degrees(plan.mesh)

    def live(*axes: str) -> set[str]:
        return {a for a in axes if degrees.get(a, 1) > 1}

    batch_axes = {
        a for a in planner_mod.spec_axes(plan.batch_spec)
        if degrees.get(a, 1) > 1
    }
    param_axes: set[str] = set()
    for spec in plan.param_specs.values():
        param_axes |= planner_mod.spec_axes(spec)
    # ZeRO-3 axes: batch-carrying axes that also shard params — the ones
    # the model predicts param all-gather / grad reduce-scatter over.
    zero3 = {a for a in batch_axes & param_axes if a != "expert"}
    # ZeRO-1 axes: axes the opt_spec_tree shards beyond the param specs —
    # the plan's zero1 RS (grads onto the opt shard) and AG (fresh
    # params) ride these, so they're accounted traffic, not reshards.
    zero1: set[str] = set()
    if plan.zero1 and plan.opt_spec_tree is not None:
        for spec in plan.opt_spec_tree.values():
            zero1 |= planner_mod.spec_axes(spec)
        zero1 = {a for a in zero1 - param_axes if degrees.get(a, 1) > 1}
    tensor = live("tensor")
    seq = live("seq")
    pipe = live("pipe")
    expert = live("expert")
    return {
        "gather": zero3 | zero1 | tensor | seq | pipe,
        "reduce": batch_axes | zero3 | tensor | seq | pipe,
        "scatter": zero3 | zero1 | tensor | seq,
        "a2a": expert | seq,
        "permute": seq | pipe,
    }


def lint_collectives(
    closed: Any,
    plan: planner_mod.ShardPlan,
    abstract_params: Any | None = None,
    *,
    grad_accum: int = 1,
) -> tuple[list[Finding], dict]:
    """GL002 + the crosscheck record joining inventory and estimate."""
    inventory = collective_inventory(closed, plan.mesh)
    estimate = None
    if abstract_params is not None:
        try:
            estimate = planner_mod.expected_collective_bytes(
                plan, abstract_params, grad_accum=grad_accum)
        except Exception as e:  # estimate is advisory, never fatal
            estimate = {"error": f"{type(e).__name__}: {e}"}
    allowed = _allowed_axes(plan, abstract_params)
    findings: list[Finding] = []
    unpredicted: list[dict] = []
    for rec in inventory:
        ok = allowed.get(rec["kind"], set())
        bad = [a for a in rec["axes"] if a not in ok]
        if not bad:
            continue
        unpredicted.append(rec)
        findings.append(Finding(
            "GL002", WARN, "graph",
            f"<{rec['prim']} over {'/'.join(bad)}>",
            f"{rec['count']}× {rec['prim']} over mesh axis "
            f"{'/'.join(repr(a) for a in bad)} "
            f"(~{rec['bytes']} B buffers) is not predicted by the "
            f"plan's analytic comms model (strategy "
            f"{plan.strategy!r}) — an implicit reshard the planner "
            "did not ask for; check the sharding constraints feeding "
            "this op",
        ))
    crosscheck = {
        "inventory": inventory,
        "unpredicted": unpredicted,
        "estimate_total_wire_bytes": (
            estimate.get("total_wire_bytes") if estimate else None),
        "model_dependent": (
            sorted(estimate.get("model_dependent", {}))
            if estimate and "model_dependent" in estimate else []),
    }
    return findings, crosscheck


def _captured_scalars(closed: Any) -> Iterator[tuple[Any, torch.Tensor]]:
    """0-dim tensor constants the traced Python captured from outside
    (``get_attr`` nodes used as they are; one the step made itself with
    ``torch.tensor(..)`` goes through ``lift_fresh_copy``)."""
    graph = _graph_of(closed)
    if graph is None:
        return
    for node in graph.nodes:
        if node.op != "get_attr":
            continue
        val = getattr(closed, node.target, None)
        if not isinstance(val, torch.Tensor) or val.dim() != 0:
            continue
        if all(u.op == "call_function" and op_name(u) == "lift_fresh_copy"
               for u in node.users):
            continue
        yield node, val


def lint_hazards(closed: Any) -> list[Finding]:
    """GL001 host syncs + GL003 captured scalar tensors."""
    findings: list[Finding] = []
    meta = getattr(closed, "meta", {}) or {}
    for name in meta.get("host_syncs", ()):
        findings.append(Finding(
            "GL001", WARN, "graph", f"<{name}>",
            "host side-effect inside the jitted step"
            f" ({name}: .item() / .tolist() / bool() / .cpu() of a "
            "device tensor)"
            " — each call is a device→host sync that stalls the "
            "launch queue; gate it out of production steps",
        ))
    for node, val in _captured_scalars(closed):
        try:
            shown = val.item()
        except Exception:  # a fake constant has no value to show
            shown = node.target
        findings.append(Finding(
            "GL003", WARN, "graph", f"<const {shown!r}>",
            "weak-typed Python scalar captured at trace time — its "
            "value is baked into the compiled step (silently stale "
            "if the Python variable changes; a recompile per value "
            "if hoisted to a static arg); pass it as a traced "
            "argument or wrap in a typed array",
        ))
    return findings


def lint_static_args(static_args: Mapping[str, Any]) -> list[Finding]:
    """GL004: static arguments must be hashable — a step cached on them
    raises a ``TypeError`` deep inside the dispatch path otherwise; this
    names the argument up front."""
    findings: list[Finding] = []
    for name, val in static_args.items():
        try:
            hash(val)
        except TypeError:
            findings.append(Finding(
                "GL004", ERROR, "graph", f"<static arg {name!r}>",
                f"{type(val).__name__} value is unhashable — jit "
                "cannot cache on it; use a hashable config "
                "(frozen dataclass / tuple) or make it a traced arg",
            ))
    return findings


def lint_graph(
    closed: Any,
    *,
    plan: planner_mod.ShardPlan | None = None,
    abstract_params: Any | None = None,
    grad_accum: int = 1,
    static_args: Mapping[str, Any] | None = None,
) -> list[Finding]:
    """All graph-layer rules over one traced step."""
    findings = lint_hazards(closed)
    if plan is not None:
        coll, _ = lint_collectives(
            closed, plan, abstract_params, grad_accum=grad_accum)
        findings += coll
    if static_args:
        findings += lint_static_args(static_args)
    return findings


def kernel_nodes(closed: Any) -> dict[str, int]:
    """Count of each hand-written kernel's node (``tadnn.*`` ops) in a
    traced step."""
    out: dict[str, int] = {}
    for node in iter_eqns(closed):
        if op_namespace(node) == "tadnn":
            name = op_name(node)
            out[name] = out.get(name, 0) + 1
    return out
