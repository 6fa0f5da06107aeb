"""``AutoDistribute``: the JAX package's ``core.py`` on PyTorch.

    model = GPT2("small")      # or Bert, ViT, TransformerMT, MoE, MLP
    ad = AutoDistribute(model, optimizer=adamw(1e-3),
                        loss_fn=next_token_loss)  # its family's loss
    state = ad.init(torch.Generator("cuda").manual_seed(0), batch)
    for batch in data:
        state, metrics = ad.step(state, batch)

``ad(state, x)`` is the forward pass with the state's weights (JAX's
``__call__``); ``autodistribute(model, ...)`` is JAX's functional alias.

``loss_fn(model, batch, generator) -> (loss, aux_dict)``
(``training/losses.py``): the loss reads its family's batch keys
(``input_ids``, ``x``/``label``, ``src``/``tgt``, ``labels``) and the
model's outputs (MoE's ``(logits, aux)``), so the step takes any
family's batches and models; a model draws its own weights with
``init_weights(generator)``.  ``init_fn(model, generator)`` (optional)
prepares the model once before it is planned, e.g. LoRA's
``lora_init_fn(base, spec)``, which loads the base weights, freezes them
and adds the factors; only the parameters that train
(``requires_grad``) get gradients, optimizer state and ``mixed``'s fp32
masters, and a frozen parameter stays bitwise as it was.  ``build_plan`` runs the planner
(``planner.make_plan``) on the model's abstract shapes and the
topology (``topology.detect``): strategy, mesh degrees, activation
checkpointing, ZeRO-1.  One process drives one device.  Without a
``torch.distributed`` process group the plan has one device and the
step is the single-device one.  With a group up (``tadnn launch``,
``torchrun``, then ``topology.initialize_distributed()``) the plan's
mesh becomes a ``DeviceMesh`` over the world and
``executor.apply_plan`` wraps the model by the plan's strategy, even at
degree 1: ``dp`` (DDP, or ZeRO-1's sharded update), ``fsdp`` (FSDP2;
HSDP beside a data axis), ``tp`` (``parallelize_module``; beside a data
axis its gradients averaged over it), ``tp_fsdp``, or the expert
strategies ``ep``, ``ep_fsdp`` and ``ep_tp`` (the banks sharded over
``expert``, the dispatched slots exchanged by ``all_to_all``).  Every
rank takes the global batch and keeps its rows (``shard_batch``), or
its own rows only (a ``data.HostBatch`` from ``data.shard_for_host``);
the step returns the global batch's loss.  ``generate`` decodes with
the plan's wrapped model, its weights sharded as trained (each rank its
rows of the batch and, under ``tensor``, its kv heads), in bf16 or
int8, an MoE model densely or routed (``moe_decode``).
``strategy='tuned'`` plans through ``tune.tune`` (the cost-model search,
with the sample batch's items, the configured ``grad_accum``, the
precision's state factor and the liveness profile of the traced step,
:meth:`AutoDistribute.activation_profile`).  ``strategy='search'``
walks JAX's escalation ladder and takes the first rung whose measured
per-device peak (:meth:`AutoDistribute.compile_report`) fits
:meth:`AutoDistribute.hbm_fit_budget`.

The export cache (``export_cache=``, ``export/``): ``init`` goes
cache-first on what the step's cold start compiles — the ``nvcc`` build
of the kernels it launches on the card (K1-K3's libraries).  A warm
entry installs the cached libraries (no ``nvcc`` runs); a miss builds
and stores them for the next start; :meth:`AutoDistribute.export_step`
fills the cache ahead of a run (``tadnn export``, the launcher's
prewarm).

Nothing-materialized views of the step (the JAX package's
``jax.eval_shape`` / ``make_jaxpr`` / AOT compile):
:meth:`AutoDistribute.traceable_step` is a function of ``(params,
opt_state, model_state, batch, generator)`` that does what ``step``
does on the plan's local shapes (``torch.func.functional_call``,
``torch.autograd.grad`` and the functional optimizer), running the
plan's data and fsdp traffic as functional collectives;
:meth:`AutoDistribute.abstract_state` makes its arguments as fake
tensors.  ``analysis.graph_lint.trace_step`` traces it to an fx graph
(the lints' input); :meth:`AutoDistribute.compile_report` runs it once
under ``FakeTensorMode`` with a live-storage tracker and
``FlopCounterMode``'s formulas.

Pipeline parallelism (``pipeline_stages=S``, ``microbatches``,
``pipeline_schedule``, ``pipeline_virtual``): each rank of the ``pipe``
axis keeps, trains and holds optimizer state for its stage's layers
only (the other stages' are meta tensors on it), and the loss runs on a
stand-in for the model whose layer stack is the schedule
(``parallel/pipeline.py``).  Context parallelism (``seq_parallel=n``,
``seq_impl``): each rank of the ``seq`` axis takes its slice of every
row's tokens, attention runs ring or Ulysses over the axis
(``parallel/context.py``), each rank's loss counts by its share of the
global token count, and the gradients are summed over ``seq``.

The step updates the state in place (the JAX step donates its input
state): ``step`` returns a new :class:`TrainState` whose ``params`` and
optimizer tensors are the ones it was given, updated.

A stateful model (``ResNet``'s BatchNorm) keeps its running statistics
in ``TrainState.model_state``, its buffers by name: a ``*_mutable``
loss returns the new ones in ``aux["model_state"]`` and the step
commits them into the buffers after each batch slice, so the slices of
``grad_accum`` thread them in order, a forward that activation
checkpointing re-runs moves them once, and ``eval_step`` (batch
statistics, as JAX evaluates) moves them not at all.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import math
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from . import executor as executor_mod
from . import planner as planner_mod
from . import topology as topo_mod
from .models.transformer_core import gathered
from .models.transformer_core import remat as remat_fn
from .obs import journal as obs_journal
from .parallel import context as pctx
from .planner import ShardPlan
from .topology import mesh_degrees
from .training import optim as optim_mod
from .training import precision as precision_mod
from .training.optim import (
    GradientTransformation,
    adamw,
    apply_updates,
    zero1_shards,
    zero1_update,
)
from .data.loader import HostBatch
from .utils.device import (
    group_up,
    is_dtensor,
    process_count,
    process_index,
    resolve_device,
)

LossFn = Callable[[nn.Module, dict, "torch.Generator | None"],
                  "tuple[torch.Tensor, dict]"]

__all__ = ["AutoDistribute", "NamedSharding", "ShardPlan", "TrainState",
           "autodistribute", "mesh_degrees"]


@dataclasses.dataclass
class TrainState:
    """The train state: the step count, the trained parameters by name
    (in ``precision.param_dtype``), the optimizer state, the seed the
    per-step dropout generators are drawn from (the JAX state's rng) and
    ``model_state``, the module's buffers by name (BatchNorm's running
    statistics, always fp32; empty for a stateless model), JAX's
    non-trained variable collections."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: Any
    seed: int
    model_state: dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a state tensor lives under a plan (JAX's ``NamedSharding``):
    the plan's mesh, the tensor's ``PartitionSpec`` and its
    ``torch.distributed.tensor`` placements, one per mesh axis."""

    mesh: Any
    spec: Any
    placements: tuple


def _placements(spec, axes: tuple[str, ...]) -> tuple:
    """Per mesh axis: ``Shard(d)`` where ``spec`` puts the axis on dim
    ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {ax: d for d, entry in enumerate(spec or ())
            for ax in _entry_axes(entry)}
    return tuple(Shard(dims[ax]) if ax in dims else Replicate()
                 for ax in axes)


class AutoDistribute:
    """A model trained by a plan, with the JAX ``AutoDistribute``'s
    semantics: ``strategy`` ('auto', 'tuned', 'search', 'dp', 'fsdp',
    'tp', 'tp_fsdp', 'ep', 'ep_fsdp', 'ep_tp'),
    ``mesh`` (a ``DeviceMesh`` from ``topology.build_mesh`` or a degrees
    mapping), ``rules`` (the planner's name rules), ``seq_parallel`` and
    ``seq_impl`` ('auto', 'ring' or 'ulysses'), ``megatron_sp`` (the JAX
    context's field, on by default: under a tensor axis above 1 a
    decoder's residual stream carries each rank's slice of the sequence
    between the blocks, ``parallel/context.py``), ``pipeline_stages``,
    ``microbatches``, ``pipeline_schedule`` ('cond', 'dense', '1f1b',
    'interleaved', 'interleaved_1f1b') and ``pipeline_virtual`` (V >= 2
    for the interleaved ones), ``zero1`` (the
    optimizer state sharded over ``data``), ``precision`` ('fp32',
    'mixed', 'bf16' or a ``Precision``), ``grad_accum`` (sequential
    batch slices, gradients averaged in the compute dtype,
    ``tokens``/``items``/``*_count`` aux summed and the rest averaged)
    and ``remat`` (None: the planner's rule).  ``init_fn(model,
    generator)``: called once, before the plan, in place of drawing the
    weights (``training/lora.py::lora_init_fn``).  ``export_cache`` and
    ``export_tags``: the export cache (module docstring; a path or True
    enables, False disables, None defers to ``TADNN_EXPORT_CACHE``; the
    tags join the key).  ``device``: where this
    process runs, ``cuda`` (``cuda:LOCAL_RANK`` under a process group)
    unless the caller asks for the CPU; ``devices``: one a process, in
    rank order."""

    def __init__(
        self,
        model: nn.Module,
        *,
        optimizer: GradientTransformation | None = None,
        loss_fn: LossFn | None = None,
        strategy: str = "auto",
        mesh: Any = None,
        rules=planner_mod.TRANSFORMER_RULES,
        remat: bool | None = None,
        devices=None,
        seq_parallel: int = 1,
        seq_impl: str = "auto",
        megatron_sp: bool = True,
        pipeline_stages: int = 1,
        microbatches: int = 8,
        pipeline_schedule: str = "cond",
        pipeline_virtual: int = 1,
        precision: str | precision_mod.Precision = "fp32",
        grad_accum: int = 1,
        zero1: bool = False,
        export_cache: Any = None,
        export_tags: Mapping | None = None,
        init_fn: Callable | None = None,
        device=None,
    ):
        if strategy not in (*planner_mod.KNOWN_STRATEGIES, "search"):
            raise ValueError(f"Unknown strategy {strategy!r}; expected one "
                             f"of {(*planner_mod.KNOWN_STRATEGIES, 'search')}")
        if mesh is not None and not isinstance(mesh, Mapping) and not (
                hasattr(mesh, "mesh_dim_names")):
            raise TypeError(f"mesh must be a DeviceMesh "
                            f"(topology.build_mesh) or a degrees mapping, "
                            f"got {type(mesh).__name__}")
        if seq_impl not in ("auto", "ring", "ulysses"):
            raise ValueError(f"seq_impl must be 'auto', 'ring' or "
                             f"'ulysses', got {seq_impl!r}")
        if pipeline_stages > 1 and seq_parallel > 1:
            raise ValueError(
                "pipeline_stages > 1 cannot be combined with seq_parallel "
                "> 1: context parallelism (ring/Ulysses) and the pipeline "
                "trunk are both manual-collective regions. For long "
                "sequences under a pipeline, raise `microbatches` (bounds "
                "per-stage activation memory the same way CP would) or "
                "drop the pipeline and use seq_parallel with fsdp/tensor. "
                "See the strategy-composition matrix in README.md.")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if devices is not None:
            devices = list(devices)
            if len(devices) != process_count():
                # a deliberate difference from the JAX package, whose
                # process drives all of its host's devices
                raise ValueError(
                    f"{len(devices)} devices in {process_count()} "
                    f"process(es): the port drives one device a process; "
                    f"start one process a device (tadnn launch, torchrun) "
                    f"and pass one device a process, in rank order")
            if device is None:
                device = devices[process_index()]
        self.device = resolve_device(device)
        self.model = model
        self.precision = precision_mod.resolve(precision)
        self.optimizer = precision_mod.wrap_optimizer(
            optimizer or adamw(1e-3), self.precision)
        self._loss_fn = loss_fn
        self._strategy = strategy
        self._mesh_arg = mesh
        self._rules = tuple(rules)
        self._zero1 = zero1
        self._remat_arg = remat
        self.remat: bool | None = None  # decided by build_plan
        self.plan: ShardPlan | None = None
        self.comm_profile: dict | None = None
        self._exec: executor_mod.Execution | None = None
        self._grad_accum = grad_accum
        self._seq_parallel, self._seq_impl = seq_parallel, seq_impl
        self._megatron_sp = bool(megatron_sp)
        self._pipeline_stages = pipeline_stages
        self._microbatches = microbatches
        self._pipeline_schedule = pipeline_schedule
        self._pipeline_virtual = pipeline_virtual
        self._pipelined = None  # the loss's stand-in model under a pipeline
        self._ctx: pctx.ParallelContext | None = None
        self._masters_apart = False
        self._init_fn = init_fn
        self._prepared = init_fn is None
        # names of the parameters that train, fixed at init
        self._trainable: frozenset[str] = frozenset()
        self.search_report: list = []  # strategy='search' measurements
        self.last_compile_error: str | None = None
        # the export cache (export/): a path/True enables, False
        # disables, None defers to TADNN_EXPORT_CACHE in the environment,
        # so launcher workers inherit cache-first starts through their env
        self._export_cache_spec = export_cache
        self._export_tags = dict(export_tags or {})
        self._export_info: dict | None = None  # last export outcome
        self._params_sig: str | None = None  # the planner's input, keyed
        # a prewarm's world (export_step(world=)): the topology planned
        # for in place of this process's
        self._topology: topo_mod.Topology | None = None

    # -- planning -------------------------------------------------------------

    @property
    def mesh(self):
        assert self.plan is not None, "call init() or build_plan() first"
        return self.plan.mesh

    def build_plan(self, rng: torch.Generator | None = None,
                   sample_batch: dict | None = None) -> ShardPlan:
        """The planner on the model's abstract shapes (in the precision's
        storage dtype) and the topology; with a process group up, the
        plan's mesh as a ``DeviceMesh`` over the world.  ``rng`` is
        accepted for the JAX signature; the module's shapes need no
        trace.  ``strategy='search'`` measures candidates
        (:meth:`_search_plan`)."""
        if self._strategy == "search":
            return self._search_plan(rng, sample_batch)
        from .tune import cache as tune_cache

        self._prepare(rng)
        prec = self.precision
        abstract = planner_mod.abstract_params(self.model, prec.param_dtype)
        self._params_sig = tune_cache.params_signature(abstract)
        state_factor = prec.bytes_per_param / prec.param_dtype.itemsize
        tune_policy = None
        if self._strategy == "tuned":
            # the tuner sees the real batch (tokens/items per step), the
            # configured accumulation, and a liveness activation profile
            # of the traced step, so its memory/cost estimates match what
            # this AutoDistribute will actually run
            from . import tune as tune_mod

            act_profile = None
            n = (math.prod(mesh_degrees(self._mesh_arg).values())
                 if self._mesh_arg is not None
                 else self._topology.num_devices if self._topology
                 else process_count())
            # one device: the tuner falls back to 'auto' and reads no
            # profile, so none is traced
            if n // (self._seq_parallel * self._pipeline_stages) > 1:
                try:
                    act_profile = self.activation_profile(rng, sample_batch)
                except Exception as e:  # profile is advisory, never fatal
                    obs_journal.event(
                        "tune.profile_skipped",
                        error=f"{type(e).__name__}: {e}")
            tune_policy = tune_mod.TunePolicy(
                batch_items=(tune_mod.estimate_batch_items(sample_batch)
                             if sample_batch is not None else None),
                grad_accums=(self._grad_accum,),
                state_factor=state_factor,
                act_profile=act_profile,
            )
        plan = planner_mod.make_plan(
            abstract, mesh=self._mesh_arg, strategy=self._strategy,
            rules=self._rules, remat=self._remat_arg,
            state_factor=state_factor, tune_policy=tune_policy,
            zero1=self._zero1, topology=self._topology,
            heads=_heads(self.model), seq=self._seq_parallel,
            pipe=self._pipeline_stages,
            pipe_virtual=(self._pipeline_virtual if self._pipeline_schedule
                          in ("interleaved", "interleaved_1f1b") else 1))
        if plan.degrees.get("pipe", 1) > 1:
            self._check_pipeline(plan)
        if group_up():
            executor_mod.check_executable(plan)
            if isinstance(plan.mesh, Mapping):
                plan.mesh = topo_mod.build_mesh(device_type=self.device.type,
                                                **plan.degrees)
        elif math.prod(plan.degrees.values()) > 1 and self._topology is None:
            raise RuntimeError(
                f"the plan's mesh {plan.degrees} spans several devices but "
                f"no process group is up: run one process a device "
                f"(torchrun) and call topology.initialize_distributed()")
        self.plan = plan
        self.remat = plan.remat
        self._journal_plan(abstract)
        if sample_batch is not None:
            self._check_batch(sample_batch)
        return plan

    def _check_pipeline(self, plan: ShardPlan) -> None:
        """JAX's refusals under a pipe axis; the loss-level remat off (each
        stage recomputes its own layers)."""
        from .models.transformer_core import DecoderLayer, DecoderLM
        from .parallel.pipeline import check_schedule

        model = self.model
        if getattr(model, "stateful", False):
            raise ValueError("pipeline parallelism does not support "
                             "stateful models (batch stats) yet")
        if getattr(self._loss_fn, "requires_features", False):
            raise ValueError(
                "blockwise_next_token_loss cannot run under pipeline "
                "parallelism: the pipelined apply applies the lm_head "
                "itself and has no return_features path — use "
                "next_token_loss (the [B,S,V] logits are per-microbatch "
                "there, already 1/M the size)")
        if not isinstance(model, DecoderLM) or model.layer_cls is not (
                DecoderLayer):
            raise TypeError(f"pipeline parallelism needs a DecoderLM-family "
                            f"model (GPT2/Llama); got {type(model).__name__}")
        check_schedule(model.cfg.n_layers, plan.degrees["pipe"],
                       self._microbatches, self._pipeline_schedule,
                       self._pipeline_virtual)
        plan.remat = False

    def _prepare(self, generator) -> None:
        """Run ``init_fn`` on the model, once."""
        if not self._prepared:
            self._init_fn(self.model, generator)
            self._prepared = True

    def _trained(self, tree: dict) -> dict:
        """The entries of a name-keyed ``tree`` that train."""
        return {n: v for n, v in tree.items() if n in self._trainable}

    def _journal_plan(self, abstract_params) -> None:
        """Journal the plan and its expected collective traffic."""
        plan = self.plan
        obs_journal.event(
            "plan", strategy=plan.strategy, mesh=plan.degrees,
            remat=plan.remat,
            precision=planner_mod._dtype_name(self.precision.param_dtype),
            grad_accum=self._grad_accum, zero1=plan.zero1)
        est = planner_mod.expected_collective_bytes(
            plan, abstract_params, grad_dtype=self.precision.compute_dtype,
            grad_accum=self._grad_accum)
        self.comm_profile = est
        obs_journal.event(
            "comms.estimate", strategy=est["strategy"], mesh=est["mesh"],
            total_wire_bytes=est["total_wire_bytes"],
            per_device={k: v["payload_bytes"]
                        for k, v in est["per_device"].items()},
            model_dependent=sorted(est["model_dependent"]))
        if plan.zero1:
            per_dev = est["per_device"]
            obs_journal.event(
                "plan.zero1", data_degree=plan.degrees.get("data", 1),
                predicted_reduce_scatter_bytes=per_dev[
                    "zero1_grad_reduce_scatter"]["wire_bytes"],
                predicted_allgather_bytes=per_dev[
                    "zero1_param_allgather"]["wire_bytes"],
                compiled_bytes=None)

    # -- the measured search ---------------------------------------------------

    # Escalation ladders for strategy='search': cheapest collectives
    # first, sharded + remat last.  (strategy, outer_remat) pairs.
    _SEARCH_LADDER_DENSE = (
        ("dp", None), ("fsdp", None), ("tp_fsdp", None), ("tp_fsdp", True),
    )
    _SEARCH_LADDER_MOE = (
        ("ep", None), ("ep_fsdp", None), ("fsdp", None), ("fsdp", True),
    )
    _SEARCH_SAFETY = 0.92  # accept a plan at <= this fraction of HBM

    @staticmethod
    def hbm_fit_budget(device_kind: str) -> float:
        """The byte budget a measured plan must fit (search ladder and
        `tadnn fit` both compare against this): the per-chip memory table
        entry scaled by the safety margin."""
        return AutoDistribute._SEARCH_SAFETY * planner_mod._hbm_bytes(
            device_kind)

    @property
    def device_kind(self) -> str:
        """This process's device kind: the card's name, or ``cpu``."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def _search_plan(self, rng, sample_batch) -> ShardPlan:
        """Measurement-validated strategy selection (``strategy='search'``).

        The analytic auto policy (planner.choose_strategy) predicts
        persistent-state bytes but can only guess activations; this path
        walks an escalation ladder and accepts the first candidate whose
        **measured** per-device peak (:meth:`compile_report` — the step
        run once on fake tensors, nothing materialized) fits within
        ``_SEARCH_SAFETY`` of the device's memory.  Every candidate's
        measurement lands in ``self.search_report`` for observability.
        Falls back to the analytic ``'auto'`` policy when no peak can be
        had.
        """
        import warnings

        self.search_report = []
        orig_remat = self._remat_arg
        if self._mesh_arg is not None:
            n_devices = math.prod(mesh_degrees(self._mesh_arg).values())
        else:
            n_devices = process_count()
        if n_devices == 1:
            self._strategy = "dp"  # no-op path; nothing to search
            return self.build_plan(rng, sample_batch)
        self._prepare(rng)
        abstract = planner_mod.abstract_params(self.model)
        ladder = (self._SEARCH_LADDER_MOE
                  if planner_mod.detect_expert_count(abstract)
                  else self._SEARCH_LADDER_DENSE)
        budget = self.hbm_fit_budget(self.device_kind)
        if orig_remat is not None:
            # an explicit user remat= overrides the ladder's escalation
            # dimension: measure every rung with the user's setting
            seen = set()
            ladder = tuple((s, orig_remat) for s, _ in ladder
                           if not (s in seen or seen.add(s)))
        last_built = None  # last (strategy, remat) that produced a plan

        def reset(strategy, remat):
            self.plan = None
            self._strategy, self._remat_arg = strategy, remat

        try:
            for strat, remat in ladder:
                reset(strat, remat)
                try:
                    report = self.compile_report(rng, sample_batch)
                except ValueError as e:
                    # candidate inapplicable (axis degrees don't divide,
                    # no TP-matching params, ...): record and escalate
                    self.search_report.append(
                        {"strategy": strat, "remat": remat,
                         "peak_bytes": None, "budget_bytes": int(budget),
                         "fits": False, "flops": None, "error": str(e)})
                    continue
                if report is None:
                    # a per-candidate failure of the measured run: record
                    # the reason compile_report kept, escalate
                    self.search_report.append(
                        {"strategy": strat, "remat": remat,
                         "peak_bytes": None, "budget_bytes": int(budget),
                         "fits": False, "flops": None,
                         "error": ("lower/compile failed: "
                                   f"{self.last_compile_error}"
                                   if self.last_compile_error
                                   else "lower/compile failed (see logs)")})
                    continue
                if not report.get("per_device_peak_bytes"):
                    warnings.warn(
                        "strategy='search': backend exposes no memory "
                        "analysis; falling back to the analytic 'auto' "
                        "policy", stacklevel=2)
                    reset("auto", orig_remat)
                    return self.build_plan(rng, sample_batch)
                peak = report["per_device_peak_bytes"]
                entry = {
                    "strategy": strat, "remat": remat, "peak_bytes": peak,
                    "budget_bytes": int(budget), "fits": peak <= budget,
                    "flops": report.get("flops"),
                }
                self.search_report.append(entry)
                last_built = (strat, remat)
                if entry["fits"]:
                    return self.plan
        except Exception:
            # unexpected failure mid-search: leave the object
            # re-searchable instead of stuck on a ladder rung
            reset("search", orig_remat)
            raise
        if last_built is None:
            self._strategy, self._remat_arg = "search", orig_remat
            errs = {e.get("error") for e in self.search_report}
            if len(errs) == 1:
                # every rung failed identically -> a strategy-independent
                # config error (e.g. batch vs grad_accum); surface it
                # verbatim rather than as a topology-sounding failure
                raise ValueError(errs.pop())
            raise ValueError(
                f"strategy='search': no ladder candidate was applicable "
                f"to this model/topology: {self.search_report}")
        if (self._strategy, self._remat_arg) != last_built:
            # the last candidate errored; rebuild the last one that
            # actually produced a plan
            reset(*last_built)
            self.build_plan(rng, sample_batch)
        warnings.warn(
            f"strategy='search': no candidate fit "
            f"{budget / 2**30:.1f} GiB "
            f"(measured peaks: "
            f"{[(e['strategy'], e.get('peak_bytes')) for e in self.search_report]}); "
            f"keeping the most aggressive candidate "
            f"{self._strategy!r} remat={self._remat_arg} — expect OOM at "
            f"init unless the budget table underestimates this chip",
            stacklevel=2)
        return self.plan

    # -- the step on fake tensors ---------------------------------------------

    def _trace_plan(self, meshless: bool):
        """(degrees, param specs, opt specs, batch axes, mesh) the traced
        step lays its tensors out by: the plan's, or, ``meshless``, one
        device's.  Raises ValueError for an axis it does not model."""
        if meshless:
            return {}, {}, None, [], None
        plan = self.plan
        deg = plan.degrees
        for ax in ("tensor", "expert", "pipe", "seq"):
            if deg.get(ax, 1) > 1:
                raise ValueError(
                    f"the traced step does not model a {ax!r} axis above 1 "
                    f"yet (mesh {deg}; ROADMAP Queue 1 item 7)")
        batch_axes = [a for a in planner_mod.spec_axes(plan.batch_spec)
                      if deg.get(a, 1) > 1]
        opt = plan.opt_spec_tree if plan.zero1 else None
        mesh = None if isinstance(plan.mesh, Mapping) else plan.mesh
        return deg, plan.param_specs, opt, batch_axes, mesh

    def abstract_state(self, sample_batch: dict, *, meshless: bool = False,
                       mode=None) -> tuple:
        """Fake ``(params, opt_state, model_state, batch)`` for
        :meth:`traceable_step`, on this device at the plan's local shapes
        (``meshless``: one device's, the global shapes): each parameter's
        shard by its spec in the precision's storage dtype, the optimizer
        state of the trained ones (by the ZeRO-1 specs under ``zero1``),
        the module's buffers, and this rank's rows of ``sample_batch``.
        Made under ``mode`` (a new ``FakeTensorMode`` by default):
        nothing is allocated on any device."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        if sample_batch is None:
            raise ValueError("the traced step needs a sample batch")
        if not meshless and self.plan is None:
            raise RuntimeError("call init() or build_plan() first")
        deg, specs, opt_specs, batch_axes, _ = self._trace_plan(meshless)
        mode = mode or FakeTensorMode(allow_non_fake_inputs=True)
        prec = self.precision
        dp = math.prod(deg.get(a, 1) for a in batch_axes)
        trainable = {n for n, p in self.model.named_parameters()
                     if p.requires_grad}

        def local(shape, spec):
            return _local_shape(shape, spec, deg)

        with mode:
            params = {n: torch.empty(local(p.shape, specs.get(n)),
                                     dtype=prec.param_dtype,
                                     device=self.device)
                      for n, p in self.model.named_parameters()}
            trained = {n: p for n, p in params.items() if n in trainable}
            if opt_specs is not None:
                trained = {n: torch.empty(
                    _local_shape(self.model.get_parameter(n).shape,
                                 opt_specs[n], deg),
                    dtype=prec.param_dtype, device=self.device)
                    for n in trained}
            opt_state = self.optimizer.init(trained)
            model_state = {n: torch.empty(b.shape, dtype=b.dtype,
                                          device=self.device)
                           for n, b in self.model.named_buffers()}
            batch = {}
            for key, v in sample_batch.items():
                shape = tuple(np.shape(v))
                if shape and dp > 1 and not isinstance(sample_batch,
                                                       HostBatch):
                    shape = (shape[0] // dp, *shape[1:])
                batch[key] = torch.empty(shape, dtype=_torch_dtype(v),
                                         device=self.device)
        return params, opt_state, model_state, batch

    def traceable_step(self, *, meshless: bool = False,
                       remat: bool | None = None) -> Callable:
        """``fn(params, opt_state, model_state, batch, generator) ->
        (loss, params, opt_state)``: what :meth:`step` does, as a function
        of its state, on this rank's local shapes — the JAX package's
        ``_step_fn_raw``, the input of the graph, memory and dtype lints
        and of :meth:`compile_report`.

        ``batch`` is this rank's rows; ``grad_accum`` slices them in
        turn.  Each slice runs the loss through ``torch.func.
        functional_call`` on the parameters whole (fsdp's shards
        all-gathered, as FSDP2 gathers them), the ``remat`` of the plan
        (or the given one) around it, and ``torch.autograd.grad``; under
        ``mixed`` the loss sees the compute-dtype copies of the masters.
        The summed gradients are averaged over the batch axes (fsdp's
        reduce-scattered onto their shards, ZeRO-1's onto the optimizer's
        shards, the rest all-reduced: the traffic DDP's and FSDP2's hooks
        carry in the real step, here functional collectives a trace
        records), the functional optimizer updates the parameters in
        place and returns the new optimizer state.  The loss is this
        rank's (the mean over its rows): :meth:`step` reports its mean
        over the batch axes, a metric all-reduce the trace leaves out,
        as the plan's collective model does.  ``meshless``: one
        device at the global shapes, no collective (the tuner's
        profile).  Raises ValueError under a tensor, expert, pipe or seq
        axis above 1, which it does not model yet."""
        if self._loss_fn is None:
            raise ValueError("AutoDistribute needs a loss_fn to train")
        deg, specs, opt_specs, batch_axes, mesh = self._trace_plan(meshless)
        if remat is None:
            remat = bool(self.plan.remat if self.plan is not None
                         else self._remat_arg)
        k = self._grad_accum
        prec = self.precision
        cast = prec.compute_dtype != prec.param_dtype
        dp = math.prod(deg.get(a, 1) for a in batch_axes)
        trainable = frozenset(n for n, p in self.model.named_parameters()
                              if p.requires_grad)
        loss_mod = _StepLoss(self._trace_model(), self._loss_fn, remat)

        def group(axis):
            if mesh is not None:
                return mesh.get_group(axis)
            return torch.distributed.group.WORLD

        def gather(t, spec):
            from torch.distributed import _functional_collectives as fc

            for d, axes in enumerate(spec or ()):
                for ax in reversed(_entry_axes(axes)):
                    if deg.get(ax, 1) > 1:
                        t = fc.all_gather_tensor(t, d, group(ax))
            return t

        def sync(g, spec):
            """The gradient averaged over the batch axes and cut to
            ``spec``'s shard."""
            from torch.distributed import _functional_collectives as fc

            dims = {ax: d for d, axes in enumerate(spec or ())
                    for ax in _entry_axes(axes)}
            for ax in batch_axes:
                if ax in dims:
                    g = fc.reduce_scatter_tensor(g, "sum", dims[ax],
                                                 group(ax))
                else:
                    g = fc.all_reduce(g, "sum", group(ax))
            return g / dp if dp > 1 else g

        def step(params, opt_state, model_state, batch, generator):
            loss, grads, auxes = None, None, []
            for i in range(k):
                mb = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
                      if v.ndim and k > 1 else v for key, v in batch.items()}
                full = {n: gather(p, specs.get(n)) for n, p in params.items()}
                leaves = {n: (t.to(prec.compute_dtype) if cast else t)
                          .detach().requires_grad_(True)
                          for n, t in full.items() if n in trainable}
                tree = {f"model.{n}": leaves.get(n, t)
                        for n, t in full.items()}
                tree.update({f"model.{n}": t
                             for n, t in model_state.items()})
                with torch.enable_grad():
                    loss_i, aux_i, g_i = torch.func.functional_call(
                        loss_mod, tree, (mb, generator, list(
                            leaves.values())), strict=False)
                g_i = {n: torch.zeros_like(t) if g is None else g
                       for (n, t), g in zip(leaves.items(), g_i)}
                with torch.no_grad():
                    for name, t in (aux_i.pop("model_state", None)
                                    or {}).items():
                        model_state[name].copy_(t)
                loss = loss_i if loss is None else loss + loss_i
                grads = g_i if grads is None else {
                    n: grads[n] + g for n, g in g_i.items()}
                auxes.append(aux_i)
            with torch.no_grad():
                grads = {n: sync(g / k if k > 1 else g,
                                 (opt_specs or specs).get(n))
                         for n, g in grads.items()}
                trained = {n: params[n] for n in grads}
                if opt_specs is not None:
                    # ZeRO-1: the update on the optimizer's shard, the
                    # fresh values all-gathered back to the param layout
                    trained = {n: _shard_of(params[n], opt_specs[n],
                                            specs.get(n), deg)
                               for n in grads}
                deltas, new_opt = self.optimizer.update(
                    grads, opt_state, trained)
                if opt_specs is not None:
                    deltas = {n: _regather(d, opt_specs[n], specs.get(n),
                                           deg, gather)
                              for n, d in deltas.items()}
                apply_updates(params, deltas)
            return loss / k if k > 1 else loss, params, new_opt

        return step

    def _trace_model(self) -> nn.Module:
        """The module the traced step computes with: the model itself, or,
        once a plan has wrapped it (FSDP2's hooks would gather its real
        shards), an empty copy on the meta device (``interop._like``):
        ``functional_call`` gives it the fake state either way."""
        if self._exec is None or getattr(self.model, "lora_spec", None):
            return self.model
        from .interop import _like

        try:
            return _like(self.model, device="meta")
        except Exception:  # a family _like cannot rebuild
            return self.model

    def compile_report(self, rng=None, sample_batch: dict | None = None
                       ) -> dict | None:
        """The train step's per-device cost from ABSTRACT shapes only —
        no parameters, optimizer state, or activations are ever
        materialized: :meth:`traceable_step` runs once under
        ``FakeTensorMode`` on :meth:`abstract_state`, a live-storage
        tracker (``utils.profiling.LiveBytes``) counting the bytes alive
        at each op and ``FlopCounterMode``'s formulas the FLOPs
        (``utils.profiling.Flops``; K1-K3 by their registered formulas).  The port has no compiler whose buffer
        assignment could be read: the tracker's peak takes its place.

        Returns the JAX dict: ``{'flops': float|None, 'memory':
        {'argument_size', 'temp_size', 'output_size', 'alias_size'},
        'per_device_peak_bytes': int}`` — the arguments are the state
        and this rank's batch; the parameters, updated in place, are
        their own alias; ``temp_size`` is the peak above the arguments
        and the new optimizer state, so ``argument + temp + output -
        alias`` is the measured peak.  ``None`` when the run fails (the
        reason in ``self.last_compile_error``); a plan this layout cannot
        take raises ValueError."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from .analysis.graph_lint import _eager_checkpointing
        from .utils.profiling import Flops, LiveBytes

        if self.plan is None:
            self.build_plan(rng, sample_batch)
        if sample_batch is None:
            raise ValueError("compile_report needs a sample batch")
        self._check_batch(sample_batch)
        fn = self.traceable_step()
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        args = self.abstract_state(sample_batch, mode=mode)
        tracker, flops = LiveBytes(), Flops()
        try:
            with mode, _eager_checkpointing(), flops:
                arg_keys = tracker.track(args)
                argument = tracker.current
                with tracker:
                    loss, params, opt_state = fn(
                        *args, torch.Generator().manual_seed(0))
                out_keys = tracker.keys((loss, params, opt_state))
        except Exception as e:  # the measured run failed: keep why
            self.last_compile_error = f"{type(e).__name__}: {e}"
            return None
        self.last_compile_error = None
        sizes = tracker.live
        output = sum(sizes.get(key, 0) for key in out_keys)
        alias = sum(sizes.get(key, 0) for key in out_keys & arg_keys)
        peak = int(tracker.peak)
        return {
            "flops": float(flops.total) or None,
            "memory": {"argument_size": int(argument),
                       "temp_size": int(max(0, peak - argument
                                                - (output - alias))),
                       "output_size": int(output),
                       "alias_size": int(alias)},
            "per_device_peak_bytes": peak,
        }

    def activation_profile(self, rng=None, sample_batch: dict | None = None
                           ) -> dict | None:
        """Global-shape liveness activation profile of this model's
        train step — the tuner's memory-pruning input (``tune/space.py``
        via ``analysis.mem_lint``).

        Traced meshless (:meth:`traceable_step` at one device's shapes,
        ``analysis.graph_lint.trace_step`` on fake tensors): no plan,
        mesh, or devices needed, so it runs BEFORE the tuner picks one.
        Two variants (remat on/off) let the tuner charge each candidate
        the transient footprint its strategy would actually see.  Returns
        None for stateful models, as JAX's does."""
        from . import tune as tune_mod
        from .analysis import graph_lint, mem_lint

        if sample_batch is None:
            raise ValueError("activation_profile needs a sample batch")
        self._prepare(rng)
        if any(True for _ in self.model.buffers()):
            return None
        abstract = planner_mod.abstract_params(self.model,
                                               self.precision.param_dtype)
        profile: dict = {
            "batch_items": tune_mod.estimate_batch_items(sample_batch)}
        for name, remat in (("noremat", False), ("remat", True)):
            args = self.abstract_state(sample_batch, meshless=True)
            gm = graph_lint.trace_step(
                self.traceable_step(meshless=True, remat=remat), *args,
                torch.Generator())
            profile[name] = mem_lint.activation_profile_from_trace(
                gm, abstract, args[3])
        return profile

    # -- the export cache (export/) --------------------------------------------

    def _export_libraries(self) -> list[str]:
        """The kernel sources the step launches on the card: K1-K3's two
        libraries (``ops.flash_attention`` loads both) for a model with
        attention; none on the CPU, where the plain versions run."""
        if self.device.type != "cuda" or _heads(self.model) is None:
            return []
        return ["flash_attention", "flash_attention_sm90"]

    def _batch_signature(self, sample_batch) -> str | None:
        """The global batch's shapes and dtypes, JAX's ``_signature_str``
        (a ``HostBatch``'s rows scaled back to the global batch)."""
        if sample_batch is None:
            return None
        dp = math.prod(self.plan.degrees.get(a, 1)
                       for a in planner_mod.spec_axes(self.plan.batch_spec))
        sig = []
        for key in sorted(sample_batch):
            v = sample_batch[key]
            shape = list(np.shape(v))
            if shape and isinstance(sample_batch, HostBatch):
                shape[0] *= dp
            sig.append(f"{shape}:{str(_torch_dtype(v)).split('.')[-1]}")
        return ",".join(sig)

    def _export_key(self, sample_batch) -> str:
        """The entry's key: params signature x topology fingerprint x
        everything that shapes the step (the plan, the batch signature,
        accumulation, precision, pipeline and sequence settings)."""
        from .export import cache as export_cache_mod
        from .tune import cache as tune_cache

        plan = self.plan
        assert plan is not None
        prec = self.precision
        program = {
            "plan": export_cache_mod.plan_blob(plan),
            "batch": self._batch_signature(sample_batch),
            "grad_accum": self._grad_accum,
            "precision": [str(prec.param_dtype).split(".")[-1],
                          str(prec.compute_dtype).split(".")[-1],
                          float(prec.bytes_per_param)],
            "pipeline": [self._pipeline_stages, self._microbatches,
                         self._pipeline_schedule, self._pipeline_virtual],
            "seq": [self._seq_parallel, self._seq_impl],
        }
        return export_cache_mod.executable_key(
            "train_step", self._params_sig,
            tune_cache.topology_fingerprint(self._topology
                                            or topo_mod.detect()),
            program, tags=self._export_tags)

    def _maybe_export_step(self, sample_batch) -> dict | None:
        """Cache-first kernel build when the export cache is enabled
        (constructor spec or ``TADNN_EXPORT_CACHE``); a silent no-op
        otherwise — the kernels build at their first launch."""
        from .export import cache as export_cache_mod

        cache = export_cache_mod.resolve(self._export_cache_spec)
        if cache is None:
            return None
        return self._export_attach(cache, sample_batch)

    def _export_attach(self, cache, sample_batch) -> dict:
        """Install-or-build the step's kernel libraries and record the
        outcome in ``_export_info``.  A fresh build is journaled as the
        step's ``compile`` event (its kernels' ``nvcc`` wall), so goodput
        accounting sees what a cold start paid."""
        from .export import aot as aot_mod

        key = self._export_key(sample_batch)
        res = aot_mod.cached_compile(self._export_libraries(), cache=cache,
                                     kind="train_step", key=key)
        if res is None:  # the build failed: the kernels build at launch
            self._export_info = {"key": key, "kind": "train_step",
                                 "source": "error"}
            return self._export_info
        if res.source == "compile":
            obs_journal.event("compile", fn="train_step",
                              dur_s=res.compile_s,
                              signature=self._batch_signature(sample_batch)
                              or "")
        self._export_info = {"kind": "train_step", **res.to_json()}
        return self._export_info

    def export_step(self, rng, sample_batch: dict, *, cache: Any = None,
                    world: int | None = None) -> dict:
        """Build the step's kernel libraries and store them in the export
        cache (a warm key just validates and installs them).

        The ``tadnn export`` / launcher-prewarm entry point: every later
        ``init()`` with the same config on the same fingerprint then
        starts with no ``nvcc`` build.  ``world``: plan and key for a
        world of that many processes of this kind (this process's card,
        or gloo on the CPU for ``device="cpu"``) without being in one —
        the key a real run of that world looks up.  Returns the export
        info dict (key, source, build/install wall, payload bytes)."""
        from .export import cache as export_cache_mod

        spec = cache if cache is not None else self._export_cache_spec
        resolved = export_cache_mod.resolve(True if spec is None else spec)
        if resolved is None:
            raise ValueError(
                "export cache disabled (export_cache=False) — pass a "
                "cache path or set TADNN_EXPORT_CACHE")
        if world is not None and not group_up():
            self._topology = topo_mod.detect(
                world=world,
                backend="nccl" if self.device.type == "cuda" else "gloo")
            self.plan = None
        if self.plan is None:
            self.build_plan(rng, sample_batch)
        self._check_batch(sample_batch)
        return self._export_attach(resolved, sample_batch)

    def _abstract_step_args(self, rng, sample_batch: dict) -> tuple:
        """Fake ``(params, opt_state, model_state, batch)`` of the traced
        step at the plan's local shapes (:meth:`abstract_state`): the
        inputs shared by :meth:`compiled_step_text` and the lints.
        Builds the plan first if none has been built."""
        if self.plan is None:
            self.build_plan(rng, sample_batch)
        self._check_batch(sample_batch)
        return self.abstract_state(sample_batch)

    def compiled_step_text(self, rng, sample_batch: dict) -> str | None:
        """The text of the traced train step: the fx graph that
        ``analysis.graph_lint.trace_step`` makes of
        :meth:`traceable_step` at the plan's local shapes, each node
        annotated with its result's dtype and shape
        (``GraphModule.print_readable``).  The JAX package returns the
        compiled per-device HLO here; the port compiles no program, so
        this is what ``obs.trace.hlo_collective_bytes`` reads: the
        plan's collectives as they appear in the step.  Nothing is
        materialized.  None when the trace fails (an axis the traced
        step does not model yet)."""
        from .analysis import graph_lint

        try:
            args = self._abstract_step_args(rng, sample_batch)
            gm = graph_lint.trace_step(self.traceable_step(), *args,
                                       torch.Generator())
            return gm.print_readable(print_output=False)
        except Exception:
            return None

    def state_shardings(self, state: TrainState) -> TrainState:
        """A :class:`NamedSharding` for each tensor of ``state`` by the
        plan's specs: its mesh and, per mesh axis, ``Shard(dim)`` where
        the spec puts the axis on ``dim``, else ``Replicate()``.  The
        optimizer state's follow :func:`training.optim.
        opt_state_spec_tree` (ZeRO-1's specs under ``zero1``); the step,
        the seed and ``model_state`` are replicated."""
        plan = self.plan
        assert plan is not None, "call init() or build_plan() first"
        mesh = plan.mesh
        axes = tuple(plan.degrees)

        def ns(spec):
            return NamedSharding(mesh, spec, _placements(spec, axes))

        def tree_ns(tree):  # a PartitionSpec is a tuple: a leaf here
            if isinstance(tree, planner_mod.P):
                return ns(tree)
            if isinstance(tree, dict):
                return {k: tree_ns(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(tree_ns(v) for v in tree)
            return tree

        opt_specs = optim_mod.opt_state_spec_tree(
            state.opt_state, state.params,
            plan.opt_spec_tree if plan.opt_spec_tree is not None
            else plan.param_specs)
        replicated = ns(planner_mod.P())
        return TrainState(
            step=replicated,
            params={n: ns(plan.param_specs.get(n, planner_mod.P()))
                    for n in state.params},
            opt_state=tree_ns(opt_specs),
            seed=replicated,
            model_state={n: replicated for n in state.model_state})

    # -- init -----------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None,
             sample_batch: dict | None = None) -> TrainState:
        """The initial state.  With a ``generator`` (on the model's
        device) the weights are drawn anew (``DecoderLM.init_weights``),
        or ``init_fn`` prepares them; without either the model keeps the
        weights it holds, e.g. weights carried from JAX
        (``interop.decoder_from_jax_params``).  Under a
        process group the model is then wrapped by the plan, once: every
        rank draws the same weights from the same generator and keeps
        its shards."""
        if self.plan is None:
            self.build_plan(generator, sample_batch)
        elif sample_batch is not None:
            self._check_batch(sample_batch)
        if self._exec is not None:
            raise RuntimeError("init() already wrapped the model by the "
                               "plan; make a new AutoDistribute")
        self._prepare(generator)
        model = self.model.to(self.device)
        if generator is not None and self._init_fn is None:
            model.init_weights(generator)
        prec = self.precision
        self._trainable = frozenset(n for n, p in model.named_parameters()
                                    if p.requires_grad)
        # the module holds the compute-dtype copy the loss differentiates;
        # under 'mixed' the fp32 masters live apart in the state.  A
        # frozen parameter stays in the storage dtype and is its own
        # state entry (the forward casts it at use)
        self._masters_apart = prec.compute_dtype != prec.param_dtype
        masters = {}
        for name, p in model.named_parameters():
            if self._masters_apart and name in self._trainable:
                masters[name] = p.detach().to(prec.param_dtype, copy=True)
                p.data = p.data.to(prec.compute_dtype)
            else:
                p.data = p.data.to(prec.param_dtype)
        if group_up():
            self._exec = executor_mod.apply_plan(
                model, self.plan, self.plan.mesh, self.device,
                rules=self._rules, heads=_heads(model),
                megatron_sp=self._megatron_sp)
            self._ctx = pctx.ParallelContext(mesh=self.plan.mesh,
                                             seq_impl=self._seq_impl,
                                             megatron_sp=self._megatron_sp)
            if self._exec.degree("pipe") > 1:
                from .parallel.pipeline import Pipeline, PipelinedModel

                self._pipelined = PipelinedModel(model, Pipeline(
                    model, self.plan.mesh, n_microbatches=self._microbatches,
                    schedule=self._pipeline_schedule,
                    virtual=self._pipeline_virtual, remat=self._remat_arg))
        params = {name: executor_mod.like(masters[name], p)
                  if name in masters else p
                  for name, p in model.named_parameters()}
        seed = 0
        if generator is not None:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device))
        opt_params = self._trained(params)
        if self.plan.zero1 and self._exec is not None:
            opt_params = zero1_shards(params, **self._zero1_kw())
        state = TrainState(step=0, params=params,
                           opt_state=self.optimizer.init(opt_params),
                           seed=seed, model_state=dict(model.named_buffers()))
        self._mark_writers(state)
        self._maybe_export_step(sample_batch)
        return state

    def _mark_writers(self, state: TrainState) -> None:
        """Under a pipe axis, mark each held leaf of ``state`` with
        whether this process persists it in a ``ShardedCheckpoint``
        (``_tadnn_persist``): a layer's leaves on the stage that owns
        them, the replicated ones on stage 0, a plain tensor by the
        process whose other mesh coordinates are all 0 (a ``DTensor``'s
        replica-0 shards by each process holding one)."""
        ex = self._exec
        if ex is None or ex.degree("pipe") <= 1:
            return
        from .training import resilience
        from .utils.device import is_dtensor

        stages = self.plan.stages
        mesh = self.plan.mesh
        corner = all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names
                     if a != "pipe")
        for path, leaf in resilience.flatten_state(state).items():
            if not isinstance(leaf, torch.Tensor) or leaf.is_meta:
                continue
            owner = next((stages[k] for k in path.split("/") if k in stages),
                         0)
            leaf._tadnn_persist = owner == ex.stage and (
                corner or is_dtensor(leaf))

    def _zero1_kw(self) -> dict:
        plan = self.plan
        return dict(mesh=plan.mesh, opt_specs=plan.opt_spec_tree,
                    param_specs=plan.param_specs)

    @torch.no_grad()
    def adopt_state(self, state: TrainState) -> None:
        """Make the module compute with ``state``'s parameters after
        something wrote into them (a checkpoint restore): under
        ``mixed`` the module holds a compute-dtype copy of the fp32
        masters; otherwise the state's parameters are the module's."""
        self._copy_masters(state)

    def _check_batch(self, batch) -> None:
        """A readable error when the global batch does not divide over
        the accumulation slices and the batch axes."""
        k = self._grad_accum
        dp = math.prod(self.plan.degrees.get(a, 1)
                       for a in planner_mod.spec_axes(self.plan.batch_spec))
        for leaf in batch.values():
            n = np.shape(leaf)[0] if np.ndim(leaf) else None
            if n is None:
                continue
            if isinstance(batch, HostBatch):
                n *= dp  # this rank's rows of the global batch
            if k > 1 and n % k:
                raise ValueError(f"Global batch size {n} is not divisible "
                                 f"by grad_accum={k}.")
            if (n // k) % dp:
                raise ValueError(
                    f"Global batch size {n}"
                    + (f" / grad_accum={k} = {n // k}" if k > 1 else "")
                    + f" is not divisible by the data-parallel degree {dp} "
                    f"(mesh {self.plan.degrees}).")
            if (self.plan.degrees.get("pipe", 1) > 1
                    and (n // k // dp) % self._microbatches):
                raise ValueError(
                    f"Per-device batch {n // k // dp} is not divisible by "
                    f"microbatches={self._microbatches} (pipeline). Adjust "
                    f"batch size or microbatches.")
        cp = self.plan.degrees.get("seq", 1)
        tokens = batch.get("input_ids", batch.get("tokens"))
        if cp > 1 and tokens is not None and (np.shape(tokens)[1] - 1) % cp:
            raise ValueError(
                f"sequence length {np.shape(tokens)[1] - 1} is not divisible "
                f"by seq_parallel={cp}")

    # -- the train step -------------------------------------------------------

    def _to_device(self, batch: dict) -> dict:
        out = {k: torch.as_tensor(v).to(self.device)
               for k, v in batch.items()}
        return HostBatch(out) if isinstance(batch, HostBatch) else out

    def _local_rows(self, batch: dict) -> dict:
        """This rank's rows (a ``HostBatch`` holds them already) and,
        under a ``seq`` axis, its slice of the sequence."""
        if self._exec is None:
            return batch
        return self._exec.local_rows(batch,
                                     rows=not isinstance(batch, HostBatch))

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch, on its device: its
        coordinate on the batch axes picks them (data-major, the JAX
        batch spec's order); one device keeps the whole batch, and a
        ``HostBatch`` (``data.shard_for_host``) is this rank's rows
        already, as the JAX step takes a host's slice under several
        processes."""
        return self._local_rows(self._to_device(batch))

    def _value_and_grad(self, batch, generator):
        if self._loss_fn is None:
            raise ValueError("AutoDistribute needs a loss_fn to train")
        names, params = zip(*self._trained(
            dict(self.model.named_parameters())).items())
        with torch.enable_grad():
            if self.remat:
                loss, aux = remat_fn(self._loss_fn, self.model, batch,
                                     generator)
            else:
                loss, aux = self._loss_fn(self.model, batch, generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, params, grads)}
        return loss.detach(), _detached(aux), grads

    @staticmethod
    def _generator(state: TrainState, i: int) -> torch.Generator:
        """The dropout generator of slice ``i`` of this step."""
        seq = np.random.SeedSequence([state.seed, state.step, i])
        return torch.Generator().manual_seed(int(seq.generate_state(1)[0]))

    def step(self, state: TrainState, batch: dict
             ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One optimizer step on the global ``batch`` (numpy arrays or
        tensors), or on this rank's rows of it (a ``HostBatch``).
        Returns the updated state and ``{"loss": ..., **aux}`` of the
        global batch."""
        if self.remat is None:
            raise RuntimeError("call init() first")
        if self._exec is not None:
            return self._sharded_step(state, batch)
        batch = self._to_device(batch)
        k = self._grad_accum
        if k == 1:
            loss, aux, grads = self._value_and_grad(
                batch, self._generator(state, 0))
            updates = aux.pop("model_state", None)
        else:
            self._check_batch(batch)
            loss, grads, auxes = None, None, []
            for i in range(k):
                mb = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
                      if v.ndim else v for key, v in batch.items()}
                loss_i, aux_i, g_i = self._value_and_grad(
                    mb, self._generator(state, i))
                # the next slice starts from this one's statistics
                _commit(state, aux_i.pop("model_state", None))
                loss = loss_i if loss is None else loss + loss_i
                grads = g_i if grads is None else {
                    n: grads[n] + g for n, g in g_i.items()}
                auxes.append(aux_i)
            grads = {n: g / k for n, g in grads.items()}
            loss = loss / k
            aux = _merge_aux(auxes)
            updates = None
        with torch.no_grad():
            deltas, opt_state = self.optimizer.update(
                grads, state.opt_state, self._trained(state.params))
            apply_updates(state.params, deltas)
            self._copy_masters(state)
        _commit(state, updates)
        new_state = dataclasses.replace(state, step=state.step + 1,
                                        opt_state=opt_state)
        return new_state, {"loss": loss, **aux}

    def _norm_reduce(self):
        """Under a pipe axis, the global squared norm from this rank's
        per-leaf ones (``training/optim.py::norm_over``): the stage's own
        layers summed over ``pipe``, the replicated leaves once, the
        other stages' (meta here) left out; None otherwise."""
        ex = self._exec
        if ex is None or ex.degree("pipe") <= 1:
            return None
        stages, group = self.plan.stages, ex.mesh.get_group("pipe")

        def total(sq: dict) -> torch.Tensor:
            own = [v for n, v in sq.items() if n in stages]
            rest = [v for n, v in sq.items() if n not in stages]
            s_own = torch.stack(own).sum() if own else torch.zeros(
                (), device=self.device)
            torch.distributed.all_reduce(s_own, group=group)
            return s_own + (torch.stack(rest).sum() if rest else 0.0)

        return total

    @torch.no_grad()
    def _copy_masters(self, state: TrainState) -> None:
        """The module's compute-dtype copies of the trained parameters
        from the state's masters (``mixed``)."""
        if self._masters_apart:
            for name, p in self._trained(
                    dict(self.model.named_parameters())).items():
                p.copy_(state.params[name])

    def _sharded_step(self, state: TrainState, batch: dict):
        """The step under a plan: each slice's loss through the wrapped
        module and ``backward`` (DDP's and FSDP2's gradient hooks fire
        there), the wrappers' reduction held back on all slices but the
        last; the optimizer on the (sharded) gradients, or ZeRO-1's
        sharded update."""
        if self._loss_fn is None:
            raise ValueError("AutoDistribute needs a loss_fn to train")
        ex = self._exec
        batch = self._to_device(batch)
        self._check_batch(batch)
        k = self._grad_accum
        loss, auxes = None, []
        for i in range(k):
            mb = self._local_rows(type(batch)(
                {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
                 if v.ndim else v for key, v in batch.items()}))
            gen = self._generator(state, i)
            module = self._pipelined or ex.module
            if self._pipelined is not None:
                self._pipelined.pipeline.sync = i == k - 1
            with ex.sync(i == k - 1), torch.enable_grad(), \
                    pctx.use(self._ctx):
                if self.remat:
                    loss_i, aux_i = remat_fn(self._loss_fn, module, mb, gen)
                else:
                    loss_i, aux_i = self._loss_fn(module, mb, gen)
                share = self._seq_share(aux_i)
                (loss_i if share is None else loss_i * share).backward()
            loss_i, aux_i = self._seq_reduce(loss_i.detach(), share,
                                             _detached(aux_i))
            loss = loss_i if loss is None else loss + loss_i
            # every rank computed the same global statistics
            _commit(state, aux_i.pop("model_state", None))
            auxes.append(aux_i)
        ex.reduce_grads()
        with torch.no_grad(), optim_mod.norm_over(self._norm_reduce()):
            grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                     / k for n, p in self._trained(
                         dict(self.model.named_parameters())).items()}
            if self.plan.zero1:
                _, opt_state = zero1_update(
                    self.optimizer, grads, state.opt_state,
                    self._trained(state.params), **self._zero1_kw())
            else:
                updates, opt_state = self.optimizer.update(
                    grads, state.opt_state, self._trained(state.params))
                apply_updates(state.params, updates)
            self._copy_masters(state)
            for p in self.model.parameters():
                p.grad = None
        loss, aux = ex.reduce_metrics(loss / k, _merge_aux(auxes))
        new_state = dataclasses.replace(state, step=state.step + 1,
                                        opt_state=opt_state)
        self._mark_writers(new_state)
        return new_state, {"loss": loss, **aux}

    def _seq_share(self, aux: dict) -> torch.Tensor | None:
        """Under a ``seq`` axis, this rank's share of the global token
        count (``aux["tokens"]``, summed over the axis; an equal share
        when the loss counts none), so that the weighted losses sum to
        the global mean whatever a mask leaves on each slice; None
        without one."""
        ex = self._exec
        if ex is None or ex.degree("seq") <= 1:
            return None
        cp = ex.degree("seq")
        if "tokens" not in aux:
            return torch.tensor(1.0 / cp, device=self.device)
        n = aux["tokens"].detach().to(torch.float32)
        total = n.clone()
        torch.distributed.all_reduce(total, group=ex.mesh.get_group("seq"))
        return n / total

    def _seq_reduce(self, loss, share, aux) -> tuple:
        """The loss and aux of the whole sequence from each ``seq``
        rank's: the weighted losses summed, ``tokens`` and counts summed,
        the rest averaged."""
        if share is None:
            return loss, aux
        ex = self._exec
        group, cp = ex.mesh.get_group("seq"), ex.degree("seq")
        loss = loss * share
        torch.distributed.all_reduce(loss, group=group)
        out = {}
        for key, v in aux.items():
            if isinstance(v, dict):
                out[key] = v
                continue
            v = v.clone()
            torch.distributed.all_reduce(v, group=group)
            out[key] = v if key in ("tokens", "items") or key.endswith(
                "_count") else v / cp
        return loss, out

    # -- inference ------------------------------------------------------------

    @staticmethod
    def _tree(state_or_params) -> dict[str, torch.Tensor]:
        """Name -> tensor: a state's parameters and model state, or a bare
        mapping."""
        if isinstance(state_or_params, TrainState):
            return {**state_or_params.params, **state_or_params.model_state}
        return dict(state_or_params)

    def _own(self) -> dict[str, torch.Tensor]:
        """The module's parameters and buffers by name."""
        return {**dict(self.model.named_parameters()),
                **dict(self.model.named_buffers())}

    def _decode_model(self, state_or_params) -> nn.Module:
        """The model holding ``state_or_params``'s weights: the module
        itself when they are its own, else an unwrapped copy loaded with
        them (the fp32 masters of a ``mixed`` state, a bare name -> tensor
        mapping, the module's own tensors where it names none; under a
        plan gathered whole on this rank, as they always are under a
        pipeline, where each rank holds its stage's layers only)."""
        from .interop import _like

        tree, own = self._tree(state_or_params), self._own()
        if self._exec is None and all(tree.get(n, t) is t
                                      for n, t in own.items()):
            return self.model
        spec = getattr(self.model, "lora_spec", None)
        if spec is not None:
            # a plain decoder holding the merged weights
            from .training.lora import factor_site, is_lora_name, merge_lora

            full = {n: self._whole(n, p) for n, p in tree.items()}
            lora = {factor_site(n): {"a": full[n], "b": full[n[:-1] + "b"]}
                    for n in full if n.endswith("lora_a")}
            tree = merge_lora({n: t for n, t in full.items()
                               if not is_lora_name(n)}, lora, spec)
        full = {**own, **tree}
        model = _like(self.model, device=self.device)
        with torch.no_grad():
            for name, t in model.state_dict(keep_vars=True).items():
                t.data = self._whole(name, full[name]).to(self.device)
        return model

    @torch.no_grad()
    def gathered_params(self, state_or_params) -> dict[str, torch.Tensor]:
        """Every parameter of ``state_or_params`` (a ``TrainState`` or a
        name -> tensor mapping) whole on this rank: gathered over the
        plan's shards and, under a pipeline, from the stage that holds
        it.  A collective under a plan: every rank calls it."""
        if isinstance(state_or_params, TrainState):
            state_or_params = state_or_params.params
        return {n: self._whole(n, t) for n, t in state_or_params.items()}

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` whole on this rank: gathered over the plan's shards and,
        under a pipe axis, from the stage that holds it."""
        if self._exec is None:
            return gathered(t).detach()
        return self._exec.full(name, t)

    def _sharded_decode_model(self, state_or_params):
        """The plan's wrapped model holding ``state_or_params``'s weights,
        sharded as trained: the module itself when they are its own (LoRA
        factors included: the adapted modules merge them in their
        forward), else a copy that the same plan wraps while it is empty
        (on the meta device) and each rank then fills with its own shards
        of them (the fp32 masters of a ``mixed`` state, a bare mapping,
        the module's own tensors where it names none): no weight is
        gathered whole.  None under a pipeline, without a plan, or where
        the plan shards no parameter (data parallelism: each rank holds
        every weight whole already)."""
        from .executor import apply_plan, like
        from .interop import _like

        ex = self._exec
        if ex is None or ex.degree("pipe") > 1:
            return None
        tree, own = self._tree(state_or_params), self._own()
        if all(tree.get(n, t) is t for n, t in own.items()):
            return ex.model
        if not any(is_dtensor(p) for p in ex.model.parameters()):
            return None
        model = _like(self.model, device="meta")
        spec = getattr(self.model, "lora_spec", None)
        if spec is not None:
            from .training.lora import apply_lora, factor_site, is_lora_name

            lora: dict = {}
            for n, t in own.items():
                if is_lora_name(n):
                    lora.setdefault(factor_site(n), {})[n[-1]] = torch.empty(
                        t.shape, device="meta")
            apply_lora(model, spec, lora)
        mine = dict(model.named_parameters())
        mine.update(model.named_buffers())
        for name, t in mine.items():
            t.data = t.data.to(tree.get(name, own[name]).dtype)
        apply_plan(model, self.plan, ex.mesh, self.device,
                   rules=self._rules, heads=_heads(model))
        model.to_empty(device=self.device)
        with torch.no_grad():
            for name, t in itertools.chain(model.named_parameters(),
                                           model.named_buffers()):
                src = tree.get(name, own[name])
                t.copy_(src if is_dtensor(src) or not is_dtensor(t)
                        else like(src.to(self.device), t))
        return model

    def _sharded_int8_model(self, state_or_params):
        """The int8 decode model of ``state_or_params``'s weights sharded
        as trained: an empty copy laid out by the plan's tensor-parallel
        wrappers alone (no FSDP wrapper: the int8 payloads keep their
        fsdp shards and are gathered at use), filled by
        ``quant.quantize_sharded``.  None where ``generate`` quantizes a
        whole copy: without a plan that shards a parameter, under a
        pipeline, an expert strategy or LoRA factors."""
        from .inference.quant import quantize_sharded
        from .interop import _like

        ex = self._exec
        if (ex is None or ex.degree("pipe") > 1
                or self.plan.strategy not in ("fsdp", "tp", "tp_fsdp")
                or getattr(self.model, "lora_spec", None) is not None
                or not any(is_dtensor(p) for p in ex.model.parameters())):
            return None
        tree, own = self._tree(state_or_params), self._own()
        source = {n: tree.get(n, t) for n, t in own.items()}
        model = _like(self.model, device="meta")
        for name, t in itertools.chain(model.named_parameters(),
                                       model.named_buffers()):
            t.data = t.data.to(source[name].dtype)
        if self.plan.strategy != "fsdp":
            layout = planner_mod.param_spec_tree(
                planner_mod.abstract_params(model), self.plan.degrees, "tp",
                self._rules, heads=_heads(model), min_degree=1)
            executor_mod._apply_tp(model, layout, ex.mesh)
        return quantize_sharded(model, source, self.device)

    @torch.no_grad()
    def generate(self, state_or_params, prompt, *, max_new_tokens: int,
                 sample=None, generator: torch.Generator | None = None,
                 cache_dtype=torch.bfloat16, eos_id: int | None = None,
                 moe_decode: str = "dense", moe_capacity: int | None = None,
                 quant: str | None = None):
        """Autoregressive generation with the trained weights
        (``inference/decode.py::generate``): ``prompt`` [B, P] -> [B, P +
        max_new_tokens] int32.  An MoE model decodes by ``moe_decode``
        ('dense' or 'routed', with ``moe_capacity`` pinning the
        prefill's slots).

        Under a plan (a collective: every rank calls it with the same
        prompt) the decode runs on the plan's wrapped model, its weights
        sharded as trained (``tp`` col/row, FSDP, the expert banks over
        ``expert``), each rank its rows of the batch and, under
        ``tensor``, its kv heads (``decode.cache_partition_spec``), as
        the JAX ``generate`` runs under the plan's shardings; every rank
        returns the whole batch.  Weights that are not the module's own
        (the fp32 masters of a ``mixed`` state, a bare mapping) go into a
        copy that the same plan wraps empty, each rank copying in only its
        shards; LoRA factors stay factors, merged in the adapted modules'
        forward.  Under a pipeline, and under plain data parallelism, a
        copy with the weights whole decodes on every rank.

        ``quant="int8"`` decodes with int8 weights
        (``quantize_for_decode``), quantized anew on each call as the JAX
        package's jitted program does; under a plan that shards them
        (``fsdp``, ``tp``, ``tp_fsdp``) each rank quantizes its own
        shards (``inference.quant.quantize_sharded``: a row-split
        weight's channel maxima taken over ``tensor``), otherwise a copy
        with the weights whole is quantized.  A long-lived server
        quantizes once and calls ``inference.decode.generate`` itself.
        ``sample`` defaults to greedy; a sampled run draws from
        ``generator``."""
        from .inference import decode
        from .inference.quant import quantize_for_decode

        if self.plan is None:
            raise RuntimeError("call init() or build_plan() first")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant={quant!r}; supported: 'int8'")
        if quant is None:
            model = self._sharded_decode_model(state_or_params)
        else:
            model = self._sharded_int8_model(state_or_params)
        mesh = None if model is None else self._exec.mesh
        if model is None:
            model = self._decode_model(state_or_params)
            if quant == "int8":
                model = quantize_for_decode(model)
        return decode.generate(
            model, prompt, max_new_tokens=max_new_tokens, sample=sample,
            generator=generator, cache_dtype=cache_dtype, eos_id=eos_id,
            moe_decode=moe_decode, moe_capacity=moe_capacity, mesh=mesh)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict
                  ) -> dict[str, torch.Tensor]:
        """The training loss and aux of the global batch with no dropout
        and no update.  A stateful model evaluates with its batch's
        statistics, as JAX's ``eval_step`` does, and its running ones stay
        as they were."""
        if self.remat is None:
            raise RuntimeError("call init() first")
        if self._exec is None:
            loss, aux = self._loss_fn(self.model, self._to_device(batch),
                                      None)
            aux.pop("model_state", None)
            return {"loss": loss, **aux}
        with pctx.use(self._ctx):
            loss, aux = self._loss_fn(self._pipelined or self._exec.module,
                                      self.shard_batch(batch), None)
            aux.pop("model_state", None)
            loss, aux = self._seq_reduce(loss, self._seq_share(aux), aux)
        loss, aux = self._exec.reduce_metrics(loss, aux)
        return {"loss": loss, **aux}

    @torch.no_grad()
    def __call__(self, state_or_params, *args, **kwargs):
        """The forward pass with the weights of ``state_or_params``: a
        ``TrainState`` (its ``params`` and ``model_state``) or a bare name
        -> tensor mapping (parameters, and buffers where it has them), as
        JAX's ``ad(state_or_params, x)``.  Array arguments go to this
        device; ``train=`` reaches a model whose forward takes it (ResNet:
        ``train=False`` normalizes with the running statistics) and is
        dropped for one that has no such mode.

        The module's own tensors stay untouched: where the weights are
        not the module's, ``torch.func.functional_call`` computes with
        them.  Under a plan the wrapped module computes the whole batch
        on every rank when the weights are its own; other weights are
        gathered into an unwrapped copy of the model, as they always are
        under a pipeline (each rank holds its stage's layers only); the
        whole sequence runs on every rank under context parallelism."""
        if self.plan is None:
            raise RuntimeError("call init() or build_plan() first")
        tree = self._tree(state_or_params)
        if "train" in kwargs and "train" not in inspect.signature(
                self.model.forward).parameters:
            kwargs.pop("train")
        args = tuple(torch.as_tensor(a).to(self.device)
                     if isinstance(a, (np.ndarray, torch.Tensor)) else a
                     for a in args)
        if self._pipelined is None and all(
                tree.get(n, t) is t for n, t in self._own().items()):
            module = self.model if self._exec is None else self._exec.module
            return module(*args, **kwargs)
        if self._exec is None:
            return torch.func.functional_call(self.model, tree, args, kwargs,
                                              strict=False)
        return self._decode_model(tree)(*args, **kwargs)


def _heads(model: nn.Module) -> tuple[int, int] | None:
    """``(n_heads, kv_heads)`` of a model's transformer config (ViT's
    ``cfg.core``; the MT config's heads are all query and key heads), or
    None for a model without attention (the MLP)."""
    cfg = getattr(model, "cfg", None)
    cfg = getattr(cfg, "core", cfg)
    if cfg is None or not hasattr(cfg, "n_heads"):
        return None
    return cfg.n_heads, getattr(cfg, "kv_heads", cfg.n_heads)


def _entry_axes(entry) -> tuple[str, ...]:
    """Axis names of one PartitionSpec dim entry (None -> ())."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(a for a in entry if a)
    return (entry,)


def _local_shape(shape, spec, degrees) -> tuple[int, ...]:
    """A parameter's shard shape under ``spec`` (a dim split by the
    product of its axes' degrees; None: the whole shape)."""
    out = [int(n) for n in shape]
    for d, entry in enumerate(spec or ()):
        for ax in _entry_axes(entry):
            out[d] //= max(1, int(degrees.get(ax, 1)))
    return tuple(out)


def _shard_of(t, opt_spec, spec, degrees):
    """ZeRO-1: this rank's slice of a parameter laid out by ``spec``
    along the axes ``opt_spec`` adds (the first shard: on fake tensors
    only its shape matters)."""
    want = _local_shape(t.shape, opt_spec, {
        ax: n for ax, n in degrees.items()
        if not any(ax in _entry_axes(e) for e in (spec or ()))})
    return t[tuple(slice(0, n) for n in want)]


def _regather(d, opt_spec, spec, degrees, gather):
    """ZeRO-1: a shard's update all-gathered over the axes the optimizer
    specs add, back to the parameter's own layout."""
    extra = tuple(
        tuple(a for a in _entry_axes(e)
              if not any(a in _entry_axes(f) for f in (spec or ())))
        for e in opt_spec)
    return gather(d, tuple(axes or None for axes in extra))


def _torch_dtype(v) -> torch.dtype:
    """The torch dtype of a batch leaf (a tensor, an array or a
    scalar)."""
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.zeros(0, dtype=np.asarray(v).dtype)).dtype


class _StepLoss(nn.Module):
    """The loss and its gradients as one module call, so that
    ``torch.func.functional_call`` keeps the substituted parameters in
    place through the backward: a checkpointed layer recomputes its
    forward there and must see them, not the module's own."""

    def __init__(self, model: nn.Module, loss_fn, remat: bool):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn
        self.remat = remat

    def forward(self, batch, generator, leaves):
        if self.remat:
            loss, aux = remat_fn(self.loss_fn, self.model, batch, generator)
        else:
            loss, aux = self.loss_fn(self.model, batch, generator)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), _detached(aux), grads


def autodistribute(model: nn.Module | None = None, **kwargs
                   ) -> AutoDistribute:
    """Functional alias: ``autodistribute(model, optimizer=...,
    loss_fn=...)``."""
    return AutoDistribute(model, **kwargs)


def _detached(aux: dict) -> dict:
    """``aux`` detached, the ``model_state`` mapping entry by entry."""
    return {k: ({n: t.detach() for n, t in v.items()} if isinstance(v, dict)
                else v.detach()) for k, v in aux.items()}


@torch.no_grad()
def _commit(state: TrainState, updates: dict | None) -> None:
    """A loss's new running statistics into the state's buffers (the
    module's own), in place."""
    for name, t in (updates or {}).items():
        state.model_state[name].copy_(t)


def _merge_aux(auxes: list[dict]) -> dict:
    """Accumulation slices' aux: counts keep full-batch semantics
    (summed), ratios average."""
    if len(auxes) == 1:
        return auxes[0]
    return {key: torch.stack([a[key] for a in auxes]).sum(0)
            if key in ("tokens", "items") or key.endswith("_count")
            else torch.stack([a[key] for a in auxes]).mean(0)
            for key in auxes[0]}
