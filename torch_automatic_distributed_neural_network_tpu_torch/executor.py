"""A :class:`~.planner.ShardPlan` applied with ``torch.distributed``:
the port's counterpart of the JAX package's plan shardings
(``AutoDistribute.state_shardings`` and the jitted step's in/out
shardings), where GSPMD inserts the collectives.

One process drives one device, and :func:`apply_plan` wraps the model
in place by the plan's strategy, even at degree 1:

- ``dp``: ``DistributedDataParallel`` over the ``data`` group (none
  under ZeRO-1, whose update reduce-scatters the gradients itself:
  ``training/optim.py::zero1_update``);
- ``tp``: ``parallelize_module`` on ``mesh["tensor"]``, with a
  ``ColwiseParallel`` for each linear layer whose weight the plan splits
  on dim 0 and a ``RowwiseParallel`` for dim 1; a bare parameter the
  plan splits (the embedding, the untied head) becomes a ``DTensor``
  that the model all-gathers at use.  Local outputs, so the attention
  kernels see plain local tensors;
- ``fsdp``: FSDP2 ``fully_shard`` per decoder layer and at the root on
  ``mesh["fsdp"]``, each parameter's shard on the dim its spec names; a
  parameter the plan leaves unsharded stays out of FSDP
  (``ignored_params``), never padded;
- ``tp_fsdp``: the TP wrappers, then ``fully_shard`` on ``mesh["fsdp"]``.

Gradients come out as the mean over the batch axes: DDP and FSDP2
average over their groups, and :meth:`Execution.reduce_grads` averages
what no wrapper reduced (the parameters FSDP ignores).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from .planner import (
    TRANSFORMER_RULES,
    ShardPlan,
    abstract_params,
    param_spec_tree,
)
from .training.lora import FACTOR_NAMES
from .utils.device import is_dtensor

EXECUTABLE = ("dp", "fsdp", "tp", "tp_fsdp")
_AXIS_ITEMS = {"expert": "6", "seq": "5", "pipe": "5"}


def check_executable(plan: ShardPlan) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a plan
    this module cannot apply; never run another strategy instead."""
    if plan.strategy.startswith("ep"):
        raise NotImplementedError(
            f"strategy {plan.strategy!r}: expert parallelism is not ported "
            f"to the PyTorch package yet (ROADMAP Queue 1 item 6)")
    if plan.strategy not in EXECUTABLE:
        raise ValueError(f"unknown strategy {plan.strategy!r}")
    degrees = plan.degrees
    for axis, item in _AXIS_ITEMS.items():
        if degrees.get(axis, 1) > 1:
            raise NotImplementedError(
                f"a {axis} mesh axis of {degrees[axis]} is not ported to "
                f"the PyTorch package yet (ROADMAP Queue 1 item {item})")
    if plan.strategy != "dp" and degrees.get("data", 1) > 1:
        raise NotImplementedError(
            f"strategy {plan.strategy!r} on a mesh with a data axis of "
            f"{degrees['data']} (a hybrid of replicas and shards) is not "
            f"ported to the PyTorch package yet (ROADMAP Queue 1 item 3b)")


def _dim_of(spec, axis: str) -> int | None:
    """The dim of ``spec`` sharded over ``axis`` (alone or with others)."""
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


class _DDP(nn.parallel.DistributedDataParallel):
    """DDP that reads the wrapped model's attributes (``cfg``, ``embed``)
    through, so a loss function takes it in the model's place."""

    def __getattr__(self, name: str):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.module, name)


def _set_param(model: nn.Module, name: str, value: torch.Tensor,
               requires_grad: bool = True) -> None:
    owner_name, _, attr = name.rpartition(".")
    owner = model.get_submodule(owner_name) if owner_name else model
    owner.register_parameter(attr, nn.Parameter(value, requires_grad))


def _apply_tp(model: nn.Module, layout: dict, mesh) -> None:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    tp_mesh = mesh["tensor"]
    styles, in_modules, factors = {}, set(), {}
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        in_modules.update(f"{mod_name}.{p}" for p, _ in
                          mod.named_parameters(recurse=False))
        # LoRA factors stay out of the Linear styles (which would split
        # every parameter of the module like its weight): they take the
        # plan's own split below
        for f in FACTOR_NAMES:
            if f in mod._parameters:
                factors[f"{mod_name}.{f}"] = mod._parameters.pop(f)
        dim = _dim_of(layout[f"{mod_name}.weight"], "tensor")
        if dim is not None:
            styles[mod_name] = ColwiseParallel() if dim == 0 else (
                RowwiseParallel())
    if styles:
        parallelize_module(model, tp_mesh, styles)
    for name, p in factors.items():
        dim = _dim_of(layout[name], "tensor")
        _set_param(model, name, distribute_tensor(
            p.data, tp_mesh, [Replicate() if dim is None else Shard(dim)],
            src_data_rank=None), p.requires_grad)
    for name, p in list(model.named_parameters()):
        dim = _dim_of(layout[name], "tensor")
        if name not in in_modules and dim is not None:
            _set_param(model, name, distribute_tensor(
                p.data, tp_mesh, [Shard(dim)], src_data_rank=None),
                p.requires_grad)
    for name, p in model.named_parameters():
        dim = _dim_of(layout[name], "tensor")
        got = (p.placements[0].dim if is_dtensor(p)
               and p.placements[0].is_shard() else None)
        if got != dim:
            raise ValueError(
                f"{name}: the plan splits dim {dim} over tensor, the TP "
                f"wrappers split {got}")


def _apply_fsdp(model: nn.Module, layout: dict, mesh) -> set[str]:
    """``fully_shard`` per layer and at the root; returns the names of
    the parameters FSDP manages."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    named = dict(model.named_parameters())
    dims = {id(p): _dim_of(layout[n], "fsdp")
            for n, p in named.items()}
    ignored = {p for p in named.values() if dims[id(p)] is None}
    kw = dict(mesh=mesh["fsdp"], ignored_params=ignored,
              shard_placement_fn=lambda p: Shard(dims[id(p)]))
    for layer in getattr(model, "layers", ()):
        fully_shard(layer, **kw)
    fully_shard(model, **kw)
    return {n for n, p in named.items() if p not in ignored}


@dataclasses.dataclass
class Execution:
    """A model wrapped by a plan.  ``module`` is what the loss calls (the
    DDP wrapper, or the model sharded in place); ``reduced`` names, per
    parameter, the batch axes a wrapper averages its gradient over."""

    plan: ShardPlan
    mesh: Any
    model: nn.Module
    module: nn.Module
    reduced: dict[str, set[str]]

    @property
    def batch_axes(self) -> list[tuple[str, int]]:
        """(axis, degree) of each batch axis of degree > 1, in the batch
        spec's (data-major) order."""
        degrees = self.plan.degrees
        order = [a for e in self.plan.batch_spec if e
                 for a in (e if isinstance(e, tuple) else (e,))]
        return [(a, degrees[a]) for a in order if degrees.get(a, 1) > 1]

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch: its coordinate on the batch
        axes, data-major (the JAX batch spec's order); every tensor rank
        holds the same rows."""
        axes = self.batch_axes
        if not axes:
            return batch
        n = math.prod(d for _, d in axes)
        idx = 0
        for axis, deg in axes:
            idx = idx * deg + self.mesh.get_local_rank(axis)
        out = {}
        for key, v in batch.items():
            if v.ndim:
                rows = v.shape[0] // n
                v = v[idx * rows:(idx + 1) * rows]
            out[key] = v
        return out

    @contextlib.contextmanager
    def sync(self, sync: bool):
        """Gradient reduction on (``sync``) or held back (the accumulation
        slices before the last)."""
        if isinstance(self.module, nn.parallel.DistributedDataParallel):
            with (contextlib.nullcontext() if sync else self.module.no_sync()):
                yield
            return
        if self.plan.strategy in ("fsdp", "tp_fsdp"):
            self.model.set_requires_gradient_sync(sync)
        yield

    def _mean(self, t: torch.Tensor, axis: str, deg: int) -> None:
        dist.all_reduce(t, group=self.mesh.get_group(axis))
        t.div_(deg)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Average over the batch axes what no wrapper averaged."""
        for name, p in self.model.named_parameters():
            if p.grad is None:
                continue
            local = p.grad.to_local() if is_dtensor(p.grad) else p.grad
            for axis, deg in self.batch_axes:
                if axis not in self.reduced[name]:
                    self._mean(local, axis, deg)

    @torch.no_grad()
    def reduce_metrics(self, loss: torch.Tensor, aux: dict) -> tuple:
        """The global batch's loss (the mean over the batch axes) and aux
        (``tokens``, ``items`` and ``*_count`` summed, the rest averaged)."""
        loss = loss.clone()
        aux = {k: v.clone() for k, v in aux.items()}
        for axis, deg in self.batch_axes:
            self._mean(loss, axis, deg)
            for key, v in aux.items():
                if key in ("tokens", "items") or key.endswith("_count"):
                    dist.all_reduce(v, group=self.mesh.get_group(axis))
                else:
                    self._mean(v, axis, deg)
        return loss, aux


def apply_plan(model: nn.Module, plan: ShardPlan, mesh,
               device: torch.device, *, rules=TRANSFORMER_RULES,
               heads: tuple[int, int] | None = None) -> Execution:
    """Wrap ``model`` (on ``device``, in the dtypes it trains in) by the
    plan's strategy on the ``DeviceMesh`` ``mesh``.  The wrappers take
    the plan's layout with every axis of the strategy applied, degree 1
    included (``param_spec_tree(min_degree=1)``): where an axis has a
    degree above 1 that is the plan's own spec, and an axis of degree 1
    shards nothing."""
    check_executable(plan)
    layout = param_spec_tree(abstract_params(model), plan.degrees,
                             plan.strategy, rules, heads=heads, min_degree=1)
    names = [n for n, _ in model.named_parameters()]
    reduced: dict[str, set[str]] = {n: set() for n in names}
    module = model
    if plan.strategy in ("tp", "tp_fsdp"):
        _apply_tp(model, layout, mesh)
    if plan.strategy in ("fsdp", "tp_fsdp"):
        for name in _apply_fsdp(model, layout, mesh):
            reduced[name].add("fsdp")
    if plan.strategy == "dp":
        # ZeRO-1's update reduces over data itself
        for name in names:
            reduced[name].add("data")
        if not plan.zero1:
            module = _DDP(model, process_group=mesh.get_group("data"),
                          device_ids=([device.index or 0]
                                      if device.type == "cuda" else None))
    return Execution(plan=plan, mesh=mesh, model=model, module=module,
                     reduced=reduced)


def like(full: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``param``: a ``DTensor`` with its mesh and
    placements (the fp32 masters of a sharded ``mixed`` plan), else
    ``full`` itself."""
    if not is_dtensor(param):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full, param.device_mesh, param.placements,
                             src_data_rank=None)
