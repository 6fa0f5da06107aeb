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
the step returns the global batch's loss.  ``generate`` gathers the
full weights on each rank and decodes there, in bf16 or int8, an MoE
model densely or routed (``moe_decode``).  The tuned and searched
strategies and the export cache raise ``NotImplementedError`` naming
their ROADMAP item.

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
    process_count,
    process_index,
    resolve_device,
)

LossFn = Callable[[nn.Module, dict, "torch.Generator | None"],
                  "tuple[torch.Tensor, dict]"]

__all__ = ["AutoDistribute", "ShardPlan", "TrainState", "autodistribute",
           "mesh_degrees"]


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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 "
        f"item {item})")


class AutoDistribute:
    """A model trained by a plan, with the JAX ``AutoDistribute``'s
    semantics: ``strategy`` ('auto', 'dp', 'fsdp', 'tp', 'tp_fsdp', 'ep',
    'ep_fsdp', 'ep_tp'),
    ``mesh`` (a ``DeviceMesh`` from ``topology.build_mesh`` or a degrees
    mapping), ``rules`` (the planner's name rules), ``seq_parallel`` and
    ``seq_impl`` ('auto', 'ring' or 'ulysses'), ``pipeline_stages``,
    ``microbatches``, ``pipeline_schedule`` ('cond', 'dense', '1f1b',
    'interleaved', 'interleaved_1f1b') and ``pipeline_virtual`` (V >= 2
    for the interleaved ones), ``zero1`` (the
    optimizer state sharded over ``data``), ``precision`` ('fp32',
    'mixed', 'bf16' or a ``Precision``), ``grad_accum`` (sequential
    batch slices, gradients averaged in the compute dtype,
    ``tokens``/``items``/``*_count`` aux summed and the rest averaged)
    and ``remat`` (None: the planner's rule).  ``init_fn(model,
    generator)``: called once, before the plan, in place of drawing the
    weights (``training/lora.py::lora_init_fn``).  ``device``: where this
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
        pipeline_stages: int = 1,
        microbatches: int = 8,
        pipeline_schedule: str = "cond",
        pipeline_virtual: int = 1,
        precision: str | precision_mod.Precision = "fp32",
        grad_accum: int = 1,
        zero1: bool = False,
        export_cache: Any = None,
        init_fn: Callable | None = None,
        device=None,
    ):
        if strategy in ("tuned", "search"):
            raise _not_ported(f"strategy={strategy!r} (the tune/ cost-model "
                              f"and measured searches)", "7")
        if strategy not in planner_mod.KNOWN_STRATEGIES:
            raise ValueError(f"Unknown strategy {strategy!r}; expected one "
                             f"of {planner_mod.KNOWN_STRATEGIES}")
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
        if export_cache:
            raise _not_ported("export_cache", "4")
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
        trace."""
        self._prepare(rng)
        prec = self.precision
        abstract = planner_mod.abstract_params(self.model, prec.param_dtype)
        plan = planner_mod.make_plan(
            abstract, mesh=self._mesh_arg, strategy=self._strategy,
            rules=self._rules, remat=self._remat_arg,
            state_factor=prec.bytes_per_param / prec.param_dtype.itemsize,
            zero1=self._zero1,
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
        elif math.prod(plan.degrees.values()) > 1:
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
        if plan.zero1:
            raise NotImplementedError(
                "zero1 beside pipeline_stages > 1 is not ported to the "
                "PyTorch package")
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
                rules=self._rules, heads=_heads(model))
            self._ctx = pctx.ParallelContext(mesh=self.plan.mesh,
                                             seq_impl=self._seq_impl)
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
        mapping, the module's own tensors where it names none, or under
        a plan the full weights gathered on this rank, as the JAX
        ``generate`` replicates them)."""
        from .interop import _like

        tree, own = self._tree(state_or_params), self._own()
        if self._exec is None and all(tree.get(n, t) is t
                                      for n, t in own.items()):
            return self.model
        spec = getattr(self.model, "lora_spec", None)
        if spec is not None:
            # a plain decoder holding the merged weights
            from .training.lora import is_lora_name, merge_lora

            full = {n: self._whole(n, p) for n, p in tree.items()}
            lora = {n[:-len(".lora_a")] + ".weight":
                    {"a": full[n], "b": full[n[:-1] + "b"]}
                    for n in full if n.endswith(".lora_a")}
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

    @torch.no_grad()
    def generate(self, state_or_params, prompt, *, max_new_tokens: int,
                 sample=None, generator: torch.Generator | None = None,
                 cache_dtype=torch.bfloat16, eos_id: int | None = None,
                 moe_decode: str = "dense", moe_capacity: int | None = None,
                 quant: str | None = None):
        """Autoregressive generation with the trained weights
        (``inference/decode.py::generate``) on this device: ``prompt``
        [B, P] -> [B, P + max_new_tokens] int32.  An MoE model decodes
        by ``moe_decode`` ('dense' or 'routed', with ``moe_capacity``
        pinning the prefill's slots) from its banks gathered whole.

        ``quant="int8"`` decodes with int8 weights
        (``quantize_for_decode``), quantized anew on each call as the JAX
        package's jitted program does; a long-lived server quantizes once
        and calls ``inference.decode.generate`` itself.  ``sample``
        defaults to greedy; a sampled run draws from ``generator``."""
        from .inference import decode
        from .inference.quant import quantize_for_decode

        if self.plan is None:
            raise RuntimeError("call init() or build_plan() first")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant={quant!r}; supported: 'int8'")
        model = self._decode_model(state_or_params)
        if quant == "int8":
            model = quantize_for_decode(model)
        return decode.generate(
            model, prompt, max_new_tokens=max_new_tokens, sample=sample,
            generator=generator, cache_dtype=cache_dtype, eos_id=eos_id,
            moe_decode=moe_decode, moe_capacity=moe_capacity)

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
