"""Partition planner: the JAX package's ``planner.py`` over the port's
parameters.

A pure function ``(abstract params, mesh, policy) -> ShardPlan``, with
no device: ``abstract_params`` maps each parameter's name
(``layers.3.attn.q_proj.weight``) to anything with ``.shape`` and
``.dtype`` (a meta tensor: :func:`abstract_params` of a module built on
``torch.device("meta")``), and a mesh may be a degrees mapping.
``core.AutoDistribute`` applies the plan with ``torch.distributed``
(``executor.py``).

Strategy catalogue:

- ``dp``        replicate params, shard batch on ``data`` (DDP)
- ``fsdp``      ZeRO-3: shard every param's largest divisible dim on the
                ``fsdp`` mesh axis (FSDP2); optimizer state follows
- ``tp``        Megatron column/row splits on attention/MLP weights over
                the ``tensor`` axis, chosen by name-pattern rules
- ``tp_fsdp``   TP rules first, FSDP on what remains
- ``auto``      pick one of the above from model size vs per-device
                memory and the mesh shape

The port's linear weights are ``nn.Linear``'s ``[out, in]``, so the
rules name other dims than the JAX package's ``[in, out]`` kernels, and
a column split of ``q_proj.weight`` ``[H*hd, d]`` splits whole heads
(Megatron's split), where the JAX kernel ``[d, H, hd]`` splits head_dim:
per parameter both give the same mesh axes and per-device sizes, and
:func:`make_plan` checks that ``tensor`` divides the head counts.
"""

from __future__ import annotations

import dataclasses
import math
import re
import warnings
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import topology as topo_mod

Axis = str | tuple[str, ...] | None


class PartitionSpec(tuple):
    """Per dim: a mesh axis name, a tuple of names, or None (unsharded);
    ``P()`` is replicated.  A tuple, so ``P("tensor") == ("tensor",)``."""

    def __new__(cls, *dims: Axis):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}".replace(",)", ")")


P = PartitionSpec


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    """Name-pattern sharding rule: ``pattern`` is a regex searched
    against the parameter's dotted name; ``dim_axes`` assigns mesh axes
    to its *trailing* dims (leading dims unsharded).  First match wins."""

    pattern: str
    dim_axes: tuple[Axis, ...]

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


# Megatron-style transformer rules in ``nn.Linear``'s [out, in] layout:
# column-split the fan-out projections (QKV, MLP up/gate) on dim 0,
# row-split the fan-in projections (attention out, MLP down) on dim 1.
# The embedding [V, d] and the untied head [d, V] split the vocab.
TRANSFORMER_RULES: tuple[Rule, ...] = (
    Rule(r"(q_proj|k_proj|v_proj|qkv|query|key|value|wq|wk|wv)\.weight$",
         ("tensor", None)),
    Rule(r"(o_proj|out_proj|attn_out|wo|proj_out)\.weight$", (None, "tensor")),
    Rule(r"(up_proj|gate_proj|fc1|wi|w1|w3|mlp_in)\.weight$", ("tensor", None)),
    Rule(r"(down_proj|fc2|wo_mlp|w2|mlp_out)\.weight$", (None, "tensor")),
    Rule(r"(^|\.)(embed|embedding|wte|tok_embed)(\.weight)?$", ("tensor", None)),
    Rule(r"(^|\.)(lm_head|output_proj|unembed)$", (None, "tensor")),
    # biases of column-split layers follow the split output dim
    Rule(r"(q_proj|k_proj|v_proj|qkv|up_proj|gate_proj|fc1|wi|w1|w3)\.bias$",
         ("tensor",)),
    # LoRA factors in the matrix view (a [in, r], b [r, out]): a
    # column-split layer's b splits its output dim, a row-split layer's
    # a its input dim, so each rank's delta is its shard of the weight's
    Rule(r"(q_proj|k_proj|v_proj|qkv|up_proj|gate_proj|fc1|wi|w1|w3)"
         r"\.lora_b$", (None, "tensor")),
    Rule(r"(o_proj|out_proj|attn_out|wo|proj_out|down_proj|fc2|wo_mlp|w2|"
         r"mlp_out)\.lora_a$", ("tensor", None)),
    # torch-bridge naming (models/torch_bridge.py): the MHA weights keep
    # torch's [out, in] layout -- the packed [q; k; v] ``in_w`` [3d, d]
    # splits dim 0 (each third alike: ``TorchBridge.tp_packed``), ``out_w``
    # [d, d] its input dim 1 -- and a Linear kernel is [in, out] (lin1
    # fan-out splits dim 1, lin2 fan-in dim 0)
    Rule(r"(sa|ca)\.in_w$", ("tensor", None)),
    Rule(r"(sa|ca)\.in_b$", ("tensor",)),
    Rule(r"(sa|ca)\.out_w$", (None, "tensor")),
    Rule(r"lin1\.kernel$", (None, "tensor")),
    Rule(r"lin1\.bias$", ("tensor",)),
    Rule(r"lin2\.kernel$", ("tensor", None)),
    # norms / scalars replicated
    Rule(r"(norm|ln|layernorm|rmsnorm|scale)", ()),
)

# MoE expert banks [.., E, d, f]: the E dim shards over ``expert``;
# routers replicate.
MOE_RULES: tuple[Rule, ...] = (
    Rule(r"(experts?_(up|gate|down)|expert_bank|moe_w\d)[^.]*$",
         ("expert", None, None)),
    Rule(r"router\.", ()),
)

# ep_tp: experts on ``expert`` and each expert Megatron-split on
# ``tensor`` (fan-in banks [E, f, d] row-split f, fan-out [E, d, f]
# column-split f).
MOE_TP_RULES: tuple[Rule, ...] = (
    Rule(r"(experts?_down|moe_w2)[^.]*$", ("expert", "tensor", None)),
    Rule(r"(experts?_(up|gate)|expert_bank|moe_w[13])[^.]*$",
         ("expert", None, "tensor")),
    Rule(r"moe_w\d[^.]*$", ("expert", None, None)),
    Rule(r"router\.", ()),
)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardPlan:
    """The planner's output.  ``mesh`` is a degrees mapping (every axis
    of ``topology.MESH_AXES``) or, once ``AutoDistribute`` has built it,
    a ``DeviceMesh``; ``param_specs`` and ``opt_spec_tree`` (set when
    ``zero1``: each param's largest still-unsharded divisible dim also
    shards over ``data``, for the optimizer state only) map parameter
    names to :class:`PartitionSpec`."""

    mesh: Any
    strategy: str
    param_specs: dict[str, PartitionSpec] = dataclasses.field(
        default_factory=dict)
    batch_spec: PartitionSpec = dataclasses.field(
        default_factory=lambda: P(None))
    remat: bool = False
    zero1: bool = False
    opt_spec_tree: dict[str, PartitionSpec] | None = None
    # under a pipe axis: the stage that owns each layer's parameter (the
    # JAX plan puts ``pipe`` on the stacked layer dim; the port's layers
    # are separate modules); None without one
    stages: dict[str, int] | None = None

    @property
    def degrees(self) -> dict[str, int]:
        return topo_mod.mesh_degrees(self.mesh)

    def describe(self) -> str:
        strat = self.strategy + ("+zero1" if self.zero1 else "")
        lines = [f"ShardPlan(strategy={strat}, mesh={self.degrees})"]
        for name, spec in self.param_specs.items():
            line = f"  {name}: {spec}"
            if self.opt_spec_tree is not None and (
                    self.opt_spec_tree[name] != spec):
                line += f"  [opt: {self.opt_spec_tree[name]}]"
            if self.stages and name in self.stages:
                line += f"  [stage {self.stages[name]}]"
            lines.append(line)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def abstract_params(module: torch.nn.Module,
                    dtype: torch.dtype | None = None
                    ) -> dict[str, torch.Tensor]:
    """Name -> meta tensor of each parameter's shape (in ``dtype``, else
    its own): the planner's input, with no memory behind it."""
    return {n: torch.empty(p.shape, dtype=dtype or p.dtype, device="meta")
            for n, p in module.named_parameters()}


def _shape(leaf) -> tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _axis_size(axis: Axis, degrees: Mapping[str, int]) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(degrees.get(a, 1) for a in axis)
    return degrees.get(axis, 1)


def _norm_spec(dims: Sequence[Axis]) -> PartitionSpec:
    """Drop trailing unsharded dims so P(None) == P() comparisons hold."""
    dims = list(dims)
    while dims and dims[-1] is None:
        dims.pop()
    return P(*dims)


def _spec_from_rule(rule: Rule, shape: tuple[int, ...],
                    degrees: Mapping[str, int]) -> PartitionSpec | None:
    """A PartitionSpec from a rule, or None if shapes don't divide."""
    n = len(rule.dim_axes)
    if n > len(shape):
        return None
    dims: list[Axis] = [None] * (len(shape) - n) + list(rule.dim_axes)
    for d, ax in enumerate(dims):
        size = _axis_size(ax, degrees)
        if size > 1 and shape[d] % size != 0:
            return None  # indivisible — caller falls back
    return _norm_spec(dims)


def _fsdp_spec(shape: tuple[int, ...], degrees: Mapping[str, int],
               existing: PartitionSpec | None = None,
               fsdp_axes: tuple[str, ...] = ("fsdp",),
               min_degree: int = 2) -> PartitionSpec:
    """Shard the largest still-unsharded, divisible dim over the fsdp
    axes (ties go to the first)."""
    size = math.prod(_axis_size(a, degrees) for a in fsdp_axes)
    if size < min_degree:
        return existing or P()
    used: list[Axis] = (list(existing) if existing is not None
                        else [None] * len(shape))
    while len(used) < len(shape):
        used.append(None)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if used[d] is None and shape[d] % size == 0:
            used[d] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            return _norm_spec(used)
    return _norm_spec(used)  # nothing divisible — stays as-is


def _hbm_bytes(device_kind: str) -> int:
    """Per-device memory of a device kind (the chip table's)."""
    return topo_mod.chip_spec(device_kind).hbm_bytes


def spec_axes(spec: PartitionSpec) -> set[str]:
    """Mesh axis names a PartitionSpec actually uses."""
    out: set[str] = set()
    for entry in spec:
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if ax:
                out.add(ax)
    return out


def _spec_uses_axis(spec: PartitionSpec, axis: str) -> bool:
    return axis in spec_axes(spec)


# ---------------------------------------------------------------------------
# Planner entry points
# ---------------------------------------------------------------------------


# The attention projections' flat head dim ([H*hd] of q/k/v, [.., H*hd]
# of o): the JAX kernels keep H and hd apart, so under tp_fsdp their
# fsdp shard may take the heads while tensor takes head_dim
_HEAD_PARAMS = re.compile(r"(q_proj|k_proj|v_proj|o_proj)\.(weight|bias)$")


def _stack_fsdp_on_heads(path: str, shape: tuple[int, ...],
                         spec: PartitionSpec, degrees: Mapping[str, int],
                         heads: tuple[int, int]) -> PartitionSpec:
    """An attention projection that ``fsdp`` could not shard (its one
    free dim taken, or none left): shard its head dim over
    ``("tensor", "fsdp")`` where the JAX layout shards the heads over
    fsdp (tensor on head_dim, fsdp on a head count it divides): the same
    axes and per-device size in the flat layout."""
    match = _HEAD_PARAMS.search(path)
    fsdp, tensor = degrees.get("fsdp", 1), degrees.get("tensor", 1)
    if match is None or "fsdp" in spec_axes(spec):
        return spec
    dim = next((d for d, e in enumerate(spec) if e == "tensor"), None)
    count = heads[1] if match.group(1) in ("k_proj", "v_proj") else heads[0]
    if dim is None or count % fsdp or shape[dim] % (tensor * fsdp):
        return spec
    dims = list(spec)
    dims[dim] = ("tensor", "fsdp")
    return _norm_spec(dims)


def param_spec_tree(
    abstract_params: Mapping[str, Any],
    mesh: Any,
    strategy: str,
    rules: Sequence[Rule] = TRANSFORMER_RULES,
    fsdp_axes: tuple[str, ...] = ("fsdp",),
    heads: tuple[int, int] | None = None,
    min_degree: int = 2,
) -> dict[str, PartitionSpec]:
    """A PartitionSpec for every parameter by name and shape.  With
    ``heads`` ``(n_heads, kv_heads)``, an attention projection's head
    dim may carry both ``tensor`` and ``fsdp`` (:func:`_stack_fsdp_on_heads`).
    An axis shards parameters from ``min_degree`` on: 2 is the JAX
    planner's rule (an axis of degree 1 shards nothing); 1 gives the
    layout the strategy's wrappers take on a world of one
    (``executor.apply_plan``)."""
    degrees = topo_mod.mesh_degrees(mesh)
    use_tp = (strategy in ("tp", "tp_fsdp", "ep_tp")
              and degrees.get("tensor", 1) >= min_degree)
    use_fsdp = (strategy in ("fsdp", "tp_fsdp", "ep_fsdp")
                and _axis_size(fsdp_axes, degrees) >= min_degree)
    # an expert axis above 1 shards the banks whatever the strategy, as
    # in the JAX planner (the executor runs it only under ep*); one of
    # degree 1 only under an expert strategy's wrappers (min_degree 1)
    expert = degrees.get("expert", 1)
    use_ep = expert > 1 or (strategy.startswith("ep")
                            and expert >= min_degree)

    def assign(path: str, leaf) -> PartitionSpec:
        shape = _shape(leaf)
        spec: PartitionSpec | None = None
        if use_ep:
            for rule in (MOE_TP_RULES if use_tp else MOE_RULES):
                if rule.matches(path):
                    spec = _spec_from_rule(rule, shape, degrees)
                    break
        if spec is None and use_tp:
            for rule in rules:
                if rule.matches(path):
                    spec = _spec_from_rule(rule, shape, degrees)
                    break
        if use_fsdp and len(shape) >= 1:
            spec = _fsdp_spec(shape, degrees, existing=spec,
                              fsdp_axes=fsdp_axes, min_degree=min_degree)
            if use_tp and heads is not None and fsdp_axes == ("fsdp",):
                spec = _stack_fsdp_on_heads(path, shape, spec, degrees, heads)
        return spec if spec is not None else P()

    tree = {path: assign(path, leaf) for path, leaf in abstract_params.items()}
    if use_tp and min_degree > 1 and not any(_spec_uses_axis(s, "tensor") for s in tree.values()):
        warnings.warn(
            f"strategy {strategy!r} requests tensor parallelism but ZERO "
            "parameters matched a tensor rule: the 'tensor' mesh axis "
            "will sit unused and every parameter is replicated across it. "
            "Models with nonstandard parameter names need custom rules: "
            "pass AutoDistribute(..., rules=(planner.Rule(r'my_proj\\."
            "weight$', ('tensor', None)), ...)) (see "
            "planner.TRANSFORMER_RULES).", stacklevel=2)
    return tree


def zero1_spec_tree(abstract_params: Mapping[str, Any], mesh: Any,
                    param_specs: Mapping[str, PartitionSpec]
                    ) -> dict[str, PartitionSpec]:
    """ZeRO-1 optimizer-state specs (arxiv 2004.13336): per param, the
    largest still-unsharded divisible dim also shards over ``data``;
    indivisible and scalar leaves keep the param spec."""
    degrees = topo_mod.mesh_degrees(mesh)
    if degrees.get("data", 1) <= 1:
        return dict(param_specs)  # no data replicas — nothing to shard over
    if len(param_specs) != len(abstract_params):
        raise ValueError(
            f"param_specs ({len(param_specs)} leaves) does not match "
            f"abstract_params ({len(abstract_params)} leaves)")
    out = {}
    for name, leaf in abstract_params.items():
        shape, spec = _shape(leaf), param_specs[name]
        out[name] = spec if not shape else _fsdp_spec(
            shape, degrees, existing=spec, fsdp_axes=("data",))
    return out


def batch_partition_spec(mesh: Any) -> PartitionSpec:
    """Batch dim sharded over every data-carrying axis of the mesh
    (``expert`` groups double as data ranks)."""
    degrees = topo_mod.mesh_degrees(mesh)
    axes = tuple(a for a in ("data", "fsdp", "expert")
                 if degrees.get(a, 1) > 1)
    return P(axes) if axes else P(None)


def tree_bytes(abstract_params: Mapping[str, Any]) -> int:
    total = 0
    for leaf in abstract_params.values():
        shape = _shape(leaf)
        size = _itemsize(getattr(leaf, "dtype", np.float32))
        total += math.prod(shape) * size if shape else size
    return total


def _expert_banks(abstract_params: Mapping[str, Any]) -> list[tuple[str, Any]]:
    return [(path, leaf) for path, leaf in abstract_params.items()
            if len(_shape(leaf)) >= 3
            and re.search(MOE_RULES[0].pattern, path)]


def detect_expert_count(abstract_params: Mapping[str, Any]) -> int | None:
    """Number of experts E if the model has MoE expert banks, else None."""
    banks = _expert_banks(abstract_params)
    return int(_shape(banks[0][1])[-3]) if banks else None


def tp_applicable(abstract_params: Mapping[str, Any],
                  rules: Sequence[Rule]) -> bool:
    """True if any rule would shard a dim of this model's params on the
    'tensor' axis (replication/bias rules don't count)."""
    tp_rules = [r for r in rules if any(
        ax == "tensor" or (isinstance(ax, tuple) and "tensor" in ax)
        for ax in r.dim_axes)]
    return any(r.matches(p) for p in abstract_params for r in tp_rules)


def choose_strategy(
    abstract_params: Mapping[str, Any],
    topo: topo_mod.Topology,
    rules: Sequence[Rule] = TRANSFORMER_RULES,
    state_factor: float = 4.0,
) -> tuple[str, dict[str, int]]:
    """Auto policy: (strategy, mesh axis degrees) from model size vs
    per-device memory and whether TP rules apply.

    - 1 device -> no-op DP
    - params + grads + Adam state (``state_factor`` x param bytes) in
      60% of one device's memory -> plain DP
    - else, if a TP rule matches and a tensor degree <= 8 divides the
      device count -> tp_fsdp (TP inside, FSDP across)
    - else -> FSDP over all devices
    """
    n = topo.num_devices
    if n == 1:
        return "dp", {"data": 1}
    hbm = topo.chip.hbm_bytes
    pbytes = tree_bytes(abstract_params)
    train_state_bytes = state_factor * pbytes
    e_count = detect_expert_count(abstract_params)
    if e_count:
        e = math.gcd(n, e_count)
        if e > 1:
            rest = n // e
            expert_b = sum(math.prod(_shape(leaf))
                           * _itemsize(getattr(leaf, "dtype", np.float32))
                           for _, leaf in _expert_banks(abstract_params))
            dense_b = pbytes - expert_b
            per_device = state_factor * (dense_b + expert_b / e)
            if per_device < 0.6 * hbm:
                return "ep", {"expert": e, "data": rest}
            if n // e < 2:
                e = max(d for d in range(1, e) if e % d == 0)
            if e > 1:
                return "ep_fsdp", {"expert": e, "fsdp": n // e}
    if train_state_bytes < 0.6 * hbm:
        return "dp", {"data": n}
    if tp_applicable(abstract_params, rules):
        for t in (8, 4, 2):
            if n % t == 0 and n // t >= 2:
                return "tp_fsdp", {"fsdp": n // t, "tensor": t}
    return "fsdp", {"fsdp": n}


# ---------------------------------------------------------------------------
# Shard slicing (the sharded-checkpoint math)
# ---------------------------------------------------------------------------


def spec_to_json(spec: PartitionSpec) -> list:
    """A PartitionSpec as a JSON-serializable list."""
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def spec_from_json(dims: Sequence[Any]) -> PartitionSpec:
    """Inverse of :func:`spec_to_json`."""
    return P(*[tuple(d) if isinstance(d, list) else d for d in dims])


def leaf_shard_slices(shape: Sequence[int], spec: PartitionSpec,
                      degrees: Mapping[str, int]
                      ) -> list[tuple[tuple[int, int], ...]]:
    """The unique shard slices of one leaf under ``spec`` on a mesh of
    ``degrees``: per-dim ``(start, stop)`` tuples that tile the global
    shape (replicas collapsed).  A dim whose degree does not divide it
    counts as unsharded, as in the planner's rules."""
    per_dim: list[list[tuple[int, int]]] = []
    for d, size in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        deg = _axis_size(axes, degrees) if axes else 1
        if deg <= 1 or size % deg != 0:
            per_dim.append([(0, int(size))])
            continue
        chunk = size // deg
        per_dim.append([(i * chunk, (i + 1) * chunk) for i in range(deg)])
    out: list[tuple[tuple[int, int], ...]] = [()]
    for choices in per_dim:
        out = [prefix + (c,) for prefix in out for c in choices]
    return sorted(out)


def expected_collective_bytes(plan: ShardPlan,
                              abstract_params: Mapping[str, Any], *,
                              grad_dtype: Any = np.float32,
                              grad_accum: int = 1) -> dict:
    """Analytic per-device, per-step collective traffic of a plan's
    parameter and gradient path, from the abstract shapes alone:
    ``grad_allreduce`` (replicated grads over a batch axis),
    ``param_allgather`` (ZeRO-3 params gathered twice a step) and
    ``grad_reduce_scatter``; with ``plan.zero1`` the grad all-reduce over
    the optimizer shard's axes becomes ``zero1_grad_reduce_scatter``
    plus one ``zero1_param_allgather`` per optimizer step.  Ring
    formulas (allreduce 2(n-1)/n, gather/scatter (n-1)/n of payload);
    everything but the zero1 all-gather repeats per accumulation slice.
    Activation traffic (tp, ep, pipe, cp) is model-dependent and listed
    as unknown."""
    degrees = topo_mod.mesh_degrees(plan.mesh)
    batch_axes = [a for a in spec_axes(plan.batch_spec)
                  if degrees.get(a, 1) > 1]
    grad_itemsize = _itemsize(grad_dtype)
    if len(plan.param_specs) != len(abstract_params):
        raise ValueError(
            f"param_specs ({len(plan.param_specs)} leaves) does not match "
            f"abstract_params ({len(abstract_params)} leaves)")
    opt_specs = None
    if plan.zero1 and plan.opt_spec_tree is not None:
        opt_specs = plan.opt_spec_tree
    cats = {name: {"payload_bytes": 0.0, "wire_bytes": 0.0}
            for name in ("grad_allreduce", "param_allgather",
                         "grad_reduce_scatter")}
    if opt_specs is not None:
        for name in ("zero1_grad_reduce_scatter", "zero1_param_allgather"):
            cats[name] = {"payload_bytes": 0.0, "wire_bytes": 0.0}
    for name, leaf in abstract_params.items():
        spec = plan.param_specs[name]
        shape = _shape(leaf)
        count = math.prod(shape) if shape else 1
        p_itemsize = _itemsize(getattr(leaf, "dtype", np.float32))
        axes_used = spec_axes(spec)
        z1_axes = (spec_axes(opt_specs[name]) - axes_used
                   if opt_specs is not None else set())
        z1_deg = math.prod(degrees.get(a, 1) for a in z1_axes)
        f_other = 1.0
        for a in axes_used:
            if a not in batch_axes:
                f_other /= degrees.get(a, 1)
        reduce_deg = zero3_deg = 1
        for a in batch_axes:
            if a == "expert" and a in axes_used:
                continue
            if a in axes_used:
                zero3_deg *= degrees[a]
            elif a not in z1_axes:
                reduce_deg *= degrees[a]
        grad_payload = count * f_other / max(1, zero3_deg) * grad_itemsize
        if z1_deg > 1:
            c = cats["zero1_grad_reduce_scatter"]
            c["payload_bytes"] += grad_payload
            c["wire_bytes"] += (z1_deg - 1) / z1_deg * grad_payload
            ag = count * f_other / max(1, zero3_deg) * p_itemsize
            c = cats["zero1_param_allgather"]
            c["payload_bytes"] += ag
            c["wire_bytes"] += (z1_deg - 1) / z1_deg * ag
        if reduce_deg > 1:
            payload = grad_payload / z1_deg
            c = cats["grad_allreduce"]
            c["payload_bytes"] += payload
            c["wire_bytes"] += 2 * (reduce_deg - 1) / reduce_deg * payload
        if zero3_deg > 1:
            ag = count * f_other * p_itemsize * 2  # fwd + bwd re-gather
            rs = count * f_other * grad_itemsize
            c = cats["param_allgather"]
            c["payload_bytes"] += ag
            c["wire_bytes"] += (zero3_deg - 1) / zero3_deg * ag
            c = cats["grad_reduce_scatter"]
            c["payload_bytes"] += rs
            c["wire_bytes"] += (zero3_deg - 1) / zero3_deg * rs
    for name, c in cats.items():
        k = 1 if name == "zero1_param_allgather" else grad_accum
        c["payload_bytes"] = int(c["payload_bytes"] * k)
        c["wire_bytes"] = int(c["wire_bytes"] * k)
    model_dependent = {}
    for axis, what in (("tensor", "tp_activation_allreduce"),
                       ("expert", "ep_dispatch_all_to_all"),
                       ("pipe", "pipe_stage_p2p"), ("seq", "cp_kv_exchange")):
        if degrees.get(axis, 1) > 1:
            model_dependent[what] = None
    return {
        "strategy": plan.strategy,
        "mesh": dict(degrees),
        "grad_accum": grad_accum,
        "grad_dtype": _dtype_name(grad_dtype),
        "per_device": cats,
        "total_wire_bytes": int(sum(c["wire_bytes"] for c in cats.values())),
        "model_dependent": model_dependent,
        "assumptions": [
            "ring collectives: allreduce 2(n-1)/n, gather/scatter (n-1)/n",
            "ZeRO-3 params all-gathered twice per step (fwd + bwd)",
            "gradient-path collectives repeat per grad_accum slice",
            "activation-shaped traffic (tp/ep/pipe/cp) is model-dependent"
            " and reported as unknown, not zero",
        ],
    }


def _check_heads(heads: tuple[int, int] | None, tensor: int) -> None:
    """The port's column split takes whole heads: ``tensor`` must divide
    the query and the key/value head counts."""
    if heads is None or tensor <= 1:
        return
    n_heads, kv_heads = heads
    if n_heads % tensor or kv_heads % tensor:
        raise ValueError(
            f"tensor degree {tensor} does not divide the head counts "
            f"(n_heads={n_heads}, kv_heads={kv_heads}): the port splits "
            f"q/k/v by whole heads (the JAX package splits head_dim)")


KNOWN_STRATEGIES = ("auto", "tuned", "dp", "fsdp", "tp", "tp_fsdp", "ep",
                    "ep_fsdp", "ep_tp")


def make_plan(
    abstract_params: Mapping[str, Any],
    *,
    mesh: Any = None,
    strategy: str = "auto",
    rules: Sequence[Rule] = TRANSFORMER_RULES,
    topology: topo_mod.Topology | None = None,
    remat: bool | None = None,
    seq: int = 1,
    pipe: int = 1,
    state_factor: float = 4.0,
    zero1: bool = False,
    heads: tuple[int, int] | None = None,
    pipe_virtual: int = 1,
    tune_policy: Any = None,
) -> ShardPlan:
    """The planner: abstract params + topology -> :class:`ShardPlan`.

    ``topology`` defaults to :func:`topology.detect` (the process
    group's world); a :func:`topology.parse_topology` fleet plans for
    devices this process does not have.  With ``mesh`` (a ``DeviceMesh``
    or a degrees mapping) the strategy applies on it as it is; without,
    the degrees come from the strategy and the plan's mesh is their
    mapping over every axis.  ``zero1`` shards the optimizer state over
    ``data`` (a no-op without a nontrivial ``data`` axis).  ``heads``
    ``(n_heads, kv_heads)`` checks that a tensor degree divides them.

    ``seq`` > 1 adds a context-parallel axis and ``pipe`` > 1 a pipeline
    axis, each taken out of the device count before the strategy's
    degrees (JAX's composition rules: neither beside the other, no
    pipeline beside an expert strategy).  Under a pipe axis the plan's
    ``stages`` name the stage that owns each layer's parameters: layer
    ``i`` of ``L`` on stage ``i // (L / pipe)``, or, with
    ``pipe_virtual`` V > 1 (the interleaved schedules), the
    ``(v pipe + s)``-th run of ``L / (pipe V)`` layers on stage ``s``;
    the layers keep their tensor and fsdp specs.

    ``strategy='tuned'`` hands the choice to the tune/ subsystem
    (enumerate candidate factorizations, rank by the analytic cost
    model, cache the decision) on the devices left after ``seq`` and
    ``pipe``; ``tune_policy`` is an optional ``tune.TunePolicy`` refining
    the search (batch size, grad-accum choices, cache on/off).  It falls
    back to the ``auto`` heuristic when the candidate space is
    degenerate (one device), and the tuner may pick a ZeRO-1 variant
    itself."""
    if strategy not in KNOWN_STRATEGIES:
        raise ValueError(f"Unknown strategy {strategy!r}; expected one of "
                         f"{KNOWN_STRATEGIES}")
    if pipe > 1 and strategy in ("ep", "ep_fsdp", "ep_tp"):
        raise ValueError(
            "pipeline parallelism composes with dp/fsdp/tp; strategy "
            f"{strategy!r} + pipe={pipe} is not supported")
    topo = topology if topology is not None else topo_mod.detect()
    resolved = strategy
    if mesh is None:
        n_all = n = topo.num_devices
        if seq > 1 and pipe > 1:
            raise ValueError(
                "seq-parallel + pipeline in one plan is a design "
                "constraint (both are manual-collective regions); raise "
                "microbatches for per-stage memory, or use seq without "
                "pipe — README strategy-composition matrix")
        for axis, deg in (("pipeline", pipe), ("seq-parallel", seq)):
            if deg > 1:
                if n % deg:
                    raise ValueError(f"{axis} degree {deg} does not divide "
                                     f"{n} devices")
                n //= deg
        if strategy in ("auto", "tuned"):
            sub_topo = dataclasses.replace(topo, num_devices=n)
            if strategy == "tuned":
                from . import tune as tune_mod

                result = tune_mod.tune(
                    abstract_params, sub_topo, rules=rules,
                    policy=tune_policy
                    or tune_mod.TunePolicy(state_factor=state_factor),
                    heads=heads)
                resolved, degrees = result.strategy, dict(result.degrees)
                zero1 = zero1 or bool(result.zero1)
            else:
                resolved, degrees = choose_strategy(
                    abstract_params, sub_topo, rules,
                    state_factor=state_factor)
            if pipe > 1 and resolved in ("ep", "ep_fsdp"):
                warnings.warn(
                    f"{strategy} strategy chose {resolved!r} but pipeline "
                    f"parallelism does not compose with expert parallelism; "
                    f"falling back to 'fsdp'", stacklevel=2)
                resolved, degrees = "fsdp", {"fsdp": n}
        elif strategy == "dp":
            degrees = {"data": n}
        elif strategy == "fsdp":
            degrees = {"fsdp": n}
        elif strategy == "tp":
            degrees = {"tensor": n}
        elif strategy == "tp_fsdp":
            t = min(8, n)
            while n % t:
                t //= 2
            # keep both axes nontrivial when possible (8 devs -> 4x2)
            while t > 2 and n // t < 2:
                t //= 2
            degrees = {"fsdp": n // t, "tensor": t}
        else:  # ep, ep_fsdp, ep_tp
            e_count = detect_expert_count(abstract_params)
            if not e_count:
                raise ValueError(
                    "strategy 'ep' needs MoE expert banks (parameters "
                    "matching MOE_RULES, e.g. experts_up); none found in "
                    "this model")
            e = math.gcd(n, e_count)
            if e == 1 and n > 1:
                raise ValueError(
                    f"strategy {strategy!r}: gcd(n_devices={n}, "
                    f"n_experts={e_count}) == 1 — no expert axis is "
                    "possible on this device count")
            if strategy == "ep_tp":
                rem = n // e
                while rem < 2 and e > 1 and e % 2 == 0:
                    e //= 2
                    rem = n // e
                t = min(8, rem)
                while rem % t:
                    t //= 2
                degrees = {"expert": e, "tensor": t, "data": rem // t}
            else:
                degrees = {"expert": e,
                           ("data" if strategy == "ep" else "fsdp"): n // e}
        degrees = {**degrees, **({"seq": seq} if seq > 1 else {}),
                   **({"pipe": pipe} if pipe > 1 else {})}
        mesh = topo_mod._resolve_degrees(n_all, degrees)
    else:
        have = topo_mod.mesh_degrees(mesh)
        for axis, deg, arg in (("pipe", pipe, "pipe"),
                               ("seq", seq, "seq_parallel")):
            if deg > 1 and have.get(axis, 1) != deg:
                raise ValueError(
                    f"{arg}={deg} conflicts with the explicit mesh (its "
                    f"{axis!r} axis is {have.get(axis, 1)})")
    if mesh is not None and resolved in ("auto", "tuned"):
        # an explicit mesh fixes every degree — nothing to tune
        d = topo_mod.mesh_degrees(mesh)
        if d.get("expert", 1) > 1:
            if d.get("tensor", 1) > 1:
                resolved = "ep_tp"
            else:
                resolved = "ep_fsdp" if d.get("fsdp", 1) > 1 else "ep"
        elif d.get("tensor", 1) > 1 and d.get("fsdp", 1) > 1:
            resolved = "tp_fsdp"
        elif d.get("tensor", 1) > 1:
            resolved = "tp"
        elif d.get("fsdp", 1) > 1:
            resolved = "fsdp"
        else:
            resolved = "dp"
    degrees_final = topo_mod.mesh_degrees(mesh)
    if degrees_final.get("seq", 1) > 1 and degrees_final.get("pipe", 1) > 1:
        raise ValueError("a plan cannot hold both a seq and a pipe axis "
                         "above 1 (README strategy-composition matrix)")
    if degrees_final.get("pipe", 1) > 1 and resolved.startswith("ep"):
        raise ValueError(
            "pipeline parallelism composes with dp/fsdp/tp; strategy "
            f"{resolved!r} + pipe={degrees_final['pipe']} is not supported")
    stages = _pipe_stages(abstract_params, degrees_final.get("pipe", 1),
                          pipe_virtual)
    if resolved in ("tp", "tp_fsdp", "ep_tp"):
        _check_heads(heads, degrees_final.get("tensor", 1))
    param_specs = param_spec_tree(abstract_params, mesh, resolved, rules,
                                  heads=heads)
    if resolved in ("tp", "tp_fsdp", "ep_tp") and degrees_final.get(
            "tensor", 1) > 1 and not any(
                _spec_uses_axis(s, "tensor") for s in param_specs.values()):
        warnings.warn(
            f"Strategy {resolved!r} requested a tensor axis of "
            f"{degrees_final['tensor']} but no parameter matched any TP "
            "rule — the model will run unsharded on that axis. Pass "
            "custom rules= matching your parameter names.", stacklevel=2)
    if remat is None:
        remat = resolved in ("fsdp", "tp_fsdp", "ep_fsdp")
        if not remat:
            # replicated params: checkpoint when the per-device train
            # state (after tensor/expert sharding) eats half the memory
            pb = tree_bytes(abstract_params)
            e_deg = degrees_final.get("expert", 1)
            if e_deg > 1:
                eb = sum(math.prod(_shape(leaf))
                         * _itemsize(getattr(leaf, "dtype", np.float32))
                         for _, leaf in _expert_banks(abstract_params))
                pb = (pb - eb) + eb // e_deg
            pb //= max(1, degrees_final.get("tensor", 1))
            pb //= max(1, degrees_final.get("pipe", 1))
            remat = state_factor * pb > 0.5 * topo.chip.hbm_bytes
    opt_spec_tree = None
    if zero1:
        if degrees_final.get("data", 1) <= 1:
            zero1 = False  # no data axis to shard over: an honest no-op
        else:
            opt_spec_tree = zero1_spec_tree(abstract_params, mesh,
                                            param_specs)
    return ShardPlan(mesh=mesh, strategy=resolved, param_specs=param_specs,
                     batch_spec=batch_partition_spec(mesh), remat=remat,
                     zero1=zero1, opt_spec_tree=opt_spec_tree, stages=stages)


_LAYER = re.compile(r"(?:^|\.)layers\.(\d+)\.")


def _pipe_stages(abstract_params: Mapping[str, Any], pipe: int,
                 virtual: int) -> dict[str, int] | None:
    """Each layer parameter's stage under a pipe axis (see
    :func:`make_plan`; empty for a model without a layer stack, which
    ``AutoDistribute`` refuses), or None without one."""
    if pipe <= 1:
        return None
    from .parallel.pipeline import stage_of_layer

    index = {name: int(m.group(1)) for name in abstract_params
             if (m := _LAYER.search(name))}
    n_layers = max(index.values(), default=-1) + 1
    if n_layers % (pipe * virtual):
        raise ValueError(f"n_layers={n_layers} not divisible by {pipe} "
                         f"stages x {virtual} virtual")
    return {name: stage_of_layer(i, n_layers, pipe, virtual)
            for name, i in index.items()}
