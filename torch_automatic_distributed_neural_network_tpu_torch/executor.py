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
  kernels see plain local tensors.  With ``megatron_sp`` (the default)
  a dense decoder backbone and its layers are marked for Megatron-SP
  (``parallel/context.py``): whenever the active context splits the
  stream, its attention and MLP blocks all-gather their input at the
  entry and its o and MLP-down projections reduce-scatter their outputs
  over the sequence (``_seq_styles``), and its norms' gradients, each
  rank's from its slice, are summed over ``tensor`` in one flat
  all-reduce;
- ``fsdp``: FSDP2 ``fully_shard`` per decoder layer and at the root on
  ``mesh["fsdp"]``, each parameter's shard on the dim its spec names; a
  parameter the plan leaves unsharded stays out of FSDP
  (``ignored_params``), never padded;
- ``tp_fsdp``: the TP wrappers, then ``fully_shard`` on ``mesh["fsdp"]``;
- ``ep``, ``ep_fsdp``, ``ep_tp``: each expert bank (``experts_*``)
  becomes a ``DTensor``, ``Shard(0)`` over ``mesh["expert"]`` (under
  ``ep_tp`` over ``mesh["expert", "tensor"]``, the hidden dim also split
  on ``tensor`` as ``MOE_TP_RULES`` say), and every ``MoEMlp`` gets the
  mesh, so it exchanges its dispatched slots over the expert group
  (``parallel/expert.py``), at degree 1 too; the rest of the model
  takes ``ep_tp``'s TP wrappers, or ``ep_fsdp``'s FSDP2 (on top of the
  ``DTensor`` banks as on top of TP's); ``ep`` adds no wrapper.

Hybrid meshes, a ``data`` axis beside the others: under ``fsdp`` and
``tp_fsdp`` FSDP2 shards on the 2-D ``mesh["data", "fsdp"]`` (HSDP:
replicas over data, shards over fsdp); under ``tp`` the TP wrappers sit
on ``mesh["tensor"]`` and the gradients are averaged over ``data``; with
``zero1`` the optimizer state also shards over ``data``
(``training/optim.py::zero1_update``, beside the tensor shards).

Gradients come out as the mean over the batch axes: DDP and FSDP2
average over their groups, and :meth:`Execution.reduce_grads` averages
what no wrapper reduced (the parameters FSDP ignores, every gradient
over ``data`` beside tensor parallelism, and over ``data`` and
``expert`` under the expert strategies).  An expert bank's gradient is
the exception on ``expert``: the backward exchange has already summed
its experts' contributions from every rank of the expert group, so it
is divided by that degree, never all-reduced (that would add different
experts' gradients together).

Buffers (BatchNorm's running statistics) stay whole on every rank: each
module that declares ``stat_groups`` (BatchNorm) gets the groups of the
batch axes (``data`` and ``fsdp``, at any degree) there and sums its
statistics over them,
so every rank computes the global batch's and commits the same
buffers; DDP therefore broadcasts none (``broadcast_buffers=False``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import re
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

EXECUTABLE = ("dp", "fsdp", "tp", "tp_fsdp", "ep", "ep_fsdp", "ep_tp")


def check_executable(plan: ShardPlan) -> None:
    """Raise ``ValueError`` for a plan this module cannot apply: an
    unknown strategy, an expert axis above 1 under a strategy that does
    not shard the expert banks, a pipe axis beside an expert strategy
    or beside a seq axis; never run another strategy instead."""
    if plan.strategy not in EXECUTABLE:
        raise ValueError(f"unknown strategy {plan.strategy!r}")
    degrees = plan.degrees
    if degrees.get("expert", 1) > 1 and not plan.strategy.startswith("ep"):
        raise ValueError(
            f"an expert mesh axis of {degrees['expert']} needs an expert "
            f"strategy (ep, ep_fsdp, ep_tp), not {plan.strategy!r}")
    if degrees.get("pipe", 1) > 1 and (plan.strategy.startswith("ep")
                                       or degrees.get("seq", 1) > 1):
        raise ValueError(f"a pipe axis composes with dp/fsdp/tp only, not "
                         f"{plan.strategy!r} with mesh {degrees}")


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


def _apply_ep(model: nn.Module, layout: dict, mesh) -> set[str]:
    """Each expert bank a ``DTensor`` by its layout over ``expert`` (and
    ``tensor``), and the mesh on every ``MoEMlp``; returns the banks'
    names."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    named = dict(model.named_parameters())
    banks = {n for n in named if _dim_of(layout[n], "expert") is not None}
    if not banks:
        raise ValueError("an expert strategy needs MoE expert banks "
                         "(parameters matching MOE_RULES); none found")
    axes = ("expert", "tensor") if any(
        _dim_of(layout[n], "tensor") is not None for n in banks) else (
        "expert",)
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    for name in banks:
        p = named[name]
        placements = []
        for axis in axes:
            dim = _dim_of(layout[name], axis)
            placements.append(Replicate() if dim is None else Shard(dim))
        _set_param(model, name, distribute_tensor(
            p.data, sub, placements, src_data_rank=None), p.requires_grad)
    for mod in model.modules():
        if hasattr(mod, "expert_mesh"):
            mod.expert_mesh = mesh
            mod.expert_tensor_axis = "tensor" if len(axes) > 1 else None
    return banks


def _sp_backbones(model: nn.Module) -> list[nn.Module]:
    """The decoder backbones whose layer stack Megatron-SP may split:
    dense decoder layers only (an MoE stack stays whole: its routing
    groups are whole rows)."""
    from .models.transformer_core import DecoderLayer, DecoderLM

    return [mod for mod in model.modules()
            if isinstance(mod, DecoderLM) and mod.layer_cls is DecoderLayer]


@functools.cache
def _seq_styles() -> tuple[type, type]:
    """Megatron-SP's two ``ParallelStyle``s, each acting only while the
    active context splits the stream (``parallel/context.py``) and as
    plain TP otherwise (a decode step, a forward outside a step):

    - ``_SeqGather`` on a block (attention, MLP): its input, this rank's
      slice of the sequence, all-gathered at the entry, once for every
      column-split projection inside;
    - ``_SeqRowwise``: ``RowwiseParallel`` whose partial sums are
      reduce-scattered over the sequence (dim 1) instead of
      all-reduced."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (
        ParallelStyle,
        RowwiseParallel,
    )

    from .parallel.collectives import gather_whole, reduce_scatter_slices
    from .parallel.context import sequence_parallel

    class _SeqGather(ParallelStyle):
        def _apply(self, module, device_mesh):
            group = device_mesh.get_group()

            def gather(mod, args):
                if sequence_parallel() is None:
                    return None
                return (gather_whole(args[0], group), *args[1:])

            module.register_forward_pre_hook(gather)
            return module

    class _SeqRowwise(RowwiseParallel):
        @staticmethod
        def _prepare_output_fn(output_layouts, use_local_output, mod,
                               outputs, device_mesh):
            if sequence_parallel() is None:
                return RowwiseParallel._prepare_output_fn(
                    output_layouts, use_local_output, mod, outputs,
                    device_mesh)
            # the partial sums' gradient is the whole one on every rank
            local = outputs.to_local(grad_placements=(Replicate(),))
            return reduce_scatter_slices(local, device_mesh.get_group())

    return _SeqGather, _SeqRowwise


def _apply_tp(model: nn.Module, layout: dict, mesh,
              skip: set[str] = frozenset(),
              megatron_sp: bool = False) -> set[str]:
    """The TP wrappers; returns the names of the norm parameters of the
    layers marked for Megatron-SP (empty without it)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )
    from torch.distributed.tensor.placement_types import _StridedShard

    tp_mesh = mesh["tensor"]
    sp_styles, sp_norms = {}, set()
    if megatron_sp:
        gather_style, rowwise_style = _seq_styles()
        names = {id(m): n for n, m in model.named_modules()}
        for backbone in _sp_backbones(model):
            backbone.seq_parallel = True
            for layer in backbone.layers:
                layer.seq_parallel = True
                for block in (layer.attn, layer.mlp):
                    sp_styles[names[id(block)]] = gather_style()
                for lin in (layer.attn.o_proj, layer.mlp.down_proj):
                    sp_styles[names[id(lin)]] = rowwise_style()
                for norm in (layer.attn_norm, layer.mlp_norm):
                    sp_norms.update(f"{names[id(norm)]}.{p}" for p, _ in
                                    norm.named_parameters())
    styles, in_modules, factors = {}, set(), {}
    # the expert banks (``skip``) are laid out by ``_apply_ep``
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear) or f"{mod_name}.weight" in skip:
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
    styles.update(sp_styles)
    if styles:
        parallelize_module(model, tp_mesh, styles)
    for name, p in factors.items():
        dim = _dim_of(layout[name], "tensor")
        _set_param(model, name, distribute_tensor(
            p.data, tp_mesh, [Replicate() if dim is None else Shard(dim)],
            src_data_rank=None), p.requires_grad)
    packed = getattr(model, "tp_packed", {})
    for name, p in list(model.named_parameters()):
        dim = _dim_of(layout[name], "tensor")
        if name not in in_modules and name not in skip and dim is not None:
            # a packed projection ([q; k; v]) splits each of its parts
            # alike, so that each rank holds whole heads of every part
            parts = next((n for pat, n in packed.items()
                          if re.search(pat, name)), 1)
            place = Shard(dim) if parts == 1 else _StridedShard(
                dim, split_factor=parts)
            _set_param(model, name, distribute_tensor(
                p.data, tp_mesh, [place], src_data_rank=None),
                p.requires_grad)
    for mod in model.modules():
        if hasattr(mod, "tensor_group"):
            mod.tensor_group = tp_mesh.get_group()
    for name, p in model.named_parameters():
        if name in skip:
            continue
        dim = _dim_of(layout[name], "tensor")
        got = getattr(p.placements[0], "dim", None) if is_dtensor(p) else (
            None)
        if got != dim:
            raise ValueError(
                f"{name}: the plan splits dim {dim} over tensor, the TP "
                f"wrappers split {got}")
    return sp_norms


def _apply_fsdp(model: nn.Module, layout: dict, mesh,
                skip: set[str] = frozenset()) -> set[str]:
    """``fully_shard`` per layer and at the root (HSDP on
    ``mesh["data", "fsdp"]`` beside a data axis); returns the names of
    the parameters FSDP manages.  The parameters in ``skip`` (another
    pipeline stage's layers) stay out."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    named = dict(model.named_parameters())
    dims = {id(p): _dim_of(layout[n], "fsdp")
            for n, p in named.items()}
    ignored = {p for n, p in named.items()
               if dims[id(p)] is None or n in skip}
    hybrid = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"] > 1
    kw = dict(mesh=mesh["data", "fsdp"] if hybrid else mesh["fsdp"],
              ignored_params=ignored,
              shard_placement_fn=lambda p: Shard(dims[id(p)]))
    for layer in getattr(model, "layers", ()):
        if not any(p not in ignored for p in layer.parameters()):
            continue
        fully_shard(layer, **kw)
    fully_shard(model, **kw)
    return {n for n, p in named.items() if p not in ignored}


@dataclasses.dataclass
class Execution:
    """A model wrapped by a plan.  ``module`` is what the loss calls (the
    DDP wrapper, or the model sharded in place); ``reduced`` names, per
    parameter, the batch axes a wrapper averages its gradient over;
    ``banks``, the expert banks under an expert strategy (their
    gradient divided by the ``expert`` degree, not averaged over it)."""

    plan: ShardPlan
    mesh: Any
    model: nn.Module
    module: nn.Module
    reduced: dict[str, set[str]]
    banks: set[str] = dataclasses.field(default_factory=set)
    # under a pipe axis: this rank's stage, and the parameters of the
    # other stages' layers (meta tensors here: their owners hold them)
    stage: int = 0
    foreign: set[str] = dataclasses.field(default_factory=set)
    # Megatron-SP: the norm parameters each rank trains on its slice of
    # the sequence (their gradients summed over ``tensor``)
    sp_norms: set[str] = dataclasses.field(default_factory=set)

    @property
    def batch_axes(self) -> list[tuple[str, int]]:
        """(axis, degree) of each batch axis of degree > 1, in the batch
        spec's (data-major) order."""
        degrees = self.plan.degrees
        order = [a for e in self.plan.batch_spec if e
                 for a in (e if isinstance(e, tuple) else (e,))]
        return [(a, degrees[a]) for a in order if degrees.get(a, 1) > 1]

    def degree(self, axis: str) -> int:
        return self.plan.degrees.get(axis, 1)

    def local_rows(self, batch: dict, rows: bool = True) -> dict:
        """This rank's rows of a global batch (``rows``: a
        ``HostBatch`` holds them already): its coordinate on the batch
        axes, data-major (the JAX batch spec's order); every tensor rank
        holds the same rows.  Under a ``seq`` axis also its slice of the
        sequence (:meth:`seq_slice`)."""
        axes = self.batch_axes if rows else []
        n = math.prod(d for _, d in axes)
        idx = 0
        for axis, deg in axes:
            idx = idx * deg + self.mesh.get_local_rank(axis)
        out = {}
        for key, v in batch.items():
            if v.ndim and n > 1:
                r = v.shape[0] // n
                v = v[idx * r:(idx + 1) * r]
            out[key] = v
        # a HostBatch stays one: a step given it back keeps its rows
        return type(batch)(self.seq_slice(out))

    def seq_slice(self, batch: dict) -> dict:
        """This ``seq`` rank's slice of a causal-LM batch: of the
        ``S + 1`` tokens, ``[r S/cp, (r + 1) S/cp + 1)``, the one token of
        overlap giving the loss its label across the boundary; every
        leaf whose dim 1 is the tokens' length is sliced alike."""
        cp = self.degree("seq")
        tokens = batch.get("input_ids", batch.get("tokens"))
        if cp <= 1 or tokens is None:
            return batch
        length = tokens.shape[1]
        width = (length - 1) // cp
        r = self.mesh.get_local_rank("seq")
        return {k: v[:, r * width:(r + 1) * width + 1]
                if v.ndim >= 2 and v.shape[1] == length else v
                for k, v in batch.items()}

    @contextlib.contextmanager
    def sync(self, sync: bool):
        """Gradient reduction on (``sync``) or held back (the accumulation
        slices before the last)."""
        if isinstance(self.module, nn.parallel.DistributedDataParallel):
            with (contextlib.nullcontext() if sync else self.module.no_sync()):
                yield
            return
        if self.plan.strategy in ("fsdp", "tp_fsdp", "ep_fsdp"):
            self.model.set_requires_gradient_sync(sync)
        yield

    def _mean(self, t: torch.Tensor, axis: str, deg: int) -> None:
        dist.all_reduce(t, group=self.mesh.get_group(axis))
        t.div_(deg)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Average over the batch axes what no wrapper averaged; an
        expert bank's gradient, summed over ``expert`` by the backward
        exchange, divided by that degree.  Over ``seq`` every gradient
        is summed: each rank's loss already carries its share of the
        global token count (``core.AutoDistribute``); under Megatron-SP
        a split layer's norm gradients are summed over ``tensor``."""
        seq = self.degree("seq")
        split = []
        for name, p in self.model.named_parameters():
            if p.grad is None:
                continue
            local = p.grad.to_local() if is_dtensor(p.grad) else p.grad
            for axis, deg in self.batch_axes:
                if axis == "expert" and name in self.banks:
                    local.div_(deg)
                elif axis not in self.reduced[name]:
                    self._mean(local, axis, deg)
            if seq > 1:
                dist.all_reduce(local, group=self.mesh.get_group("seq"))
            if name in self.sp_norms:
                split.append(local)
        if split and self.degree("tensor") > 1:
            # one flat all-reduce for all of them
            flat = torch.cat([g.reshape(-1) for g in split])
            dist.all_reduce(flat, group=self.mesh.get_group("tensor"))
            for g, part in zip(split, flat.split([g.numel() for g in split])):
                g.copy_(part.view_as(g))

    @torch.no_grad()
    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``name`` whole on this rank: a ``DTensor``
        gathered and, under a pipe axis, a layer's parameter broadcast
        from the stage that owns it (every pipe rank calls this for the
        same names in the same order)."""
        from .models.transformer_core import gathered
        from .parallel.collectives import broadcast_from

        stages = self.plan.stages or {}
        if name not in stages:
            return gathered(t).detach()
        owner = stages[name]
        mine = owner == self.stage
        return broadcast_from(
            gathered(t).detach() if mine else None, owner,
            self.mesh.get_group("pipe"), shape=t.shape, dtype=t.dtype,
            device=self.device)

    @property
    def device(self) -> torch.device:
        return next(p.device for p in self.model.parameters()
                    if p.device.type != "meta")

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
               heads: tuple[int, int] | None = None,
               megatron_sp: bool = True) -> Execution:
    """Wrap ``model`` (on ``device``, in the dtypes it trains in) by the
    plan's strategy on the ``DeviceMesh`` ``mesh``.  The wrappers take
    the plan's layout with every axis of the strategy applied, degree 1
    included (``param_spec_tree(min_degree=1)``): where an axis has a
    degree above 1 that is the plan's own spec, and an axis of degree 1
    shards nothing.  ``megatron_sp``: mark a decoder backbone for
    Megatron-SP under a tensor axis above 1 outside a pipeline."""
    check_executable(plan)
    stage = mesh.get_local_rank("pipe") if plan.degrees.get("pipe", 1) > 1 \
        else 0
    foreign = {n for n, s in (plan.stages or {}).items() if s != stage}
    for name, p in list(model.named_parameters()):
        if name in foreign:
            # another stage's layer: its owner holds it
            _set_param(model, name, torch.empty(
                p.shape, dtype=p.dtype, device="meta"), p.requires_grad)
    groups = tuple(mesh.get_group(axis) for axis in ("data", "fsdp"))
    for mod in model.modules():
        if hasattr(mod, "stat_groups"):
            mod.stat_groups = groups
    layout = param_spec_tree(abstract_params(model), plan.degrees,
                             plan.strategy, rules, heads=heads, min_degree=1)
    names = [n for n, _ in model.named_parameters()]
    reduced: dict[str, set[str]] = {n: set() for n in names}
    module = model
    banks: set[str] = set()
    if plan.strategy.startswith("ep"):
        banks = _apply_ep(model, layout, mesh)
    sp_norms: set[str] = set()
    if plan.strategy in ("tp", "tp_fsdp", "ep_tp"):
        sp = (megatron_sp and plan.degrees.get("tensor", 1) > 1
              and plan.degrees.get("pipe", 1) == 1)
        sp_norms = _apply_tp(model, layout, mesh, skip=banks | foreign,
                             megatron_sp=sp)
    if plan.strategy in ("fsdp", "tp_fsdp", "ep_fsdp"):
        for name in _apply_fsdp(model, layout, mesh, skip=foreign):
            # HSDP averages over data too
            reduced[name].update(("fsdp", "data"))
    # under a pipe axis no DDP: the schedule runs M microbatches before
    # the last backward, and reduce_grads averages over data once, after
    if plan.zero1 or (plan.strategy == "dp" and not foreign):
        # DDP averages over data, and ZeRO-1's update reduces over it
        for name in names:
            reduced[name].add("data")
        if plan.strategy == "dp" and not plan.zero1:
            module = _DDP(model, process_group=mesh.get_group("data"),
                          device_ids=([device.index or 0]
                                      if device.type == "cuda" else None),
                          broadcast_buffers=False)
    return Execution(plan=plan, mesh=mesh, model=model, module=module,
                     reduced=reduced, banks=banks, stage=stage,
                     foreign=foreign, sp_norms=sp_norms)


def like(full: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``param``: a ``DTensor`` with its mesh and
    placements (the fp32 masters of a sharded ``mixed`` plan), else
    ``full`` itself."""
    if param.device.type == "meta":
        # another pipeline stage holds it
        return torch.empty(full.shape, dtype=full.dtype, device="meta")
    if not is_dtensor(param):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full, param.device_mesh, param.placements,
                             src_data_rank=None)
