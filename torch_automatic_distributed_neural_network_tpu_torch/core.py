"""``AutoDistribute`` on one device: the JAX package's ``core.py`` for a
single card.

    model = GPT2("small")
    ad = AutoDistribute(model, optimizer=adamw(1e-3),
                        loss_fn=next_token_loss)
    state = ad.init(torch.Generator("cuda").manual_seed(0), batch)
    for batch in data:
        state, metrics = ad.step(state, batch)

``loss_fn(model, batch, generator) -> (loss, aux_dict)``
(``training/losses.py``).  On one device the JAX planner's plan is the
identity (:class:`ShardPlan`): data parallelism of degree 1 on the mesh
``{"data": 1}``, with the loss-level activation checkpoint on only when
the train state would take half the card's memory
(``planner.make_plan``'s single-device rule); ``generate`` decodes with
the trained weights, in bf16 or int8.  Every other
strategy, a mesh, several devices, sequence or pipeline parallelism,
ZeRO-1 and the export cache raise ``NotImplementedError`` (ROADMAP
Queue 1 items 3-5).

The step updates the state in place (the JAX step donates its input
state): ``step`` returns a new :class:`TrainState` whose ``params`` and
optimizer tensors are the ones it was given, updated.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from .models.transformer_core import remat as remat_fn
from .training import precision as precision_mod
from .training.optim import GradientTransformation, adamw, apply_updates
from .utils.device import resolve_device

LossFn = Callable[[nn.Module, dict, "torch.Generator | None"],
                  "tuple[torch.Tensor, dict]"]

# the JAX planner's memory for a device kind it does not know
_DEFAULT_DEVICE_BYTES = 16 * 2**30


@dataclasses.dataclass
class ShardPlan:
    """The planner's output on one device: ``strategy`` ``"dp"`` over
    the mesh ``{"data": 1}`` (axis name -> degree), and whether the loss
    is wrapped in an activation checkpoint (``remat``)."""

    mesh: dict[str, int]
    strategy: str
    remat: bool = False


def mesh_degrees(mesh) -> dict[str, int]:
    """Axis name -> degree of a plan's mesh (a degrees mapping on one
    device)."""
    return {ax: int(n) for ax, n in dict(mesh).items()}


@dataclasses.dataclass
class TrainState:
    """The train state: the step count, the trained parameters by name
    (in ``precision.param_dtype``), the optimizer state, and the seed the
    per-step dropout generators are drawn from (the JAX state's rng)."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: Any
    seed: int


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 "
        f"item {item}); AutoDistribute runs on one device")


class AutoDistribute:
    """One-device training step with the JAX ``AutoDistribute``'s
    semantics: ``precision`` ('fp32', 'mixed', 'bf16' or a
    ``Precision``), ``grad_accum`` (sequential batch slices, gradients
    averaged in the compute dtype, ``tokens``/``items``/``*_count`` aux
    summed and the rest averaged) and ``remat`` (None: the planner's
    single-device rule).  ``device``: where it runs, ``cuda`` unless
    the caller asks for the CPU."""

    def __init__(
        self,
        model: nn.Module,
        *,
        optimizer: GradientTransformation | None = None,
        loss_fn: LossFn | None = None,
        strategy: str = "auto",
        mesh: Any = None,
        remat: bool | None = None,
        devices=None,
        seq_parallel: int = 1,
        pipeline_stages: int = 1,
        precision: str | precision_mod.Precision = "fp32",
        grad_accum: int = 1,
        zero1: bool = False,
        export_cache: Any = None,
        device=None,
    ):
        if strategy not in ("auto", "dp"):
            raise _not_ported(f"strategy={strategy!r}", "3")
        if mesh is not None:
            raise _not_ported("mesh=", "3")
        if devices is not None and len(devices) > 1:
            raise _not_ported(f"{len(devices)} devices", "3")
        if seq_parallel > 1:
            raise _not_ported("seq_parallel > 1", "5")
        if pipeline_stages > 1:
            raise _not_ported("pipeline_stages > 1", "5")
        if zero1:
            raise _not_ported("zero1", "3")
        if export_cache:
            raise _not_ported("export_cache", "4")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if device is None and devices:
            device = devices[0]
        self.device = resolve_device(device)
        self.model = model
        self.precision = precision_mod.resolve(precision)
        self.optimizer = precision_mod.wrap_optimizer(
            optimizer or adamw(1e-3), self.precision)
        self._loss_fn = loss_fn
        self._remat_arg = remat
        self.remat: bool | None = None  # decided by build_plan
        self.plan: ShardPlan | None = None
        self._grad_accum = grad_accum
        self._masters_apart = False

    # -- init -----------------------------------------------------------------

    def _device_bytes(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).total_memory
        return _DEFAULT_DEVICE_BYTES

    def build_plan(self, rng: torch.Generator | None = None,
                   sample_batch: dict | None = None) -> ShardPlan:
        """The one-device plan: ``dp`` on ``{"data": 1}``, and ``remat``
        as given, else the planner's rule (params, grads and two moments,
        as ``state_factor`` times the bytes of the parameters as built,
        above half the device's memory).  ``rng`` is accepted for the
        JAX signature; the module's shapes need no trace."""
        if sample_batch is not None:
            self._check_batch(sample_batch)
        if self._remat_arg is not None:
            remat = self._remat_arg
        else:
            prec = self.precision
            state_bytes = (prec.bytes_per_param / prec.param_dtype.itemsize
                           * sum(p.numel() * p.element_size()
                                 for p in self.model.parameters()))
            remat = state_bytes > 0.5 * self._device_bytes()
        self.remat = remat
        self.plan = ShardPlan(mesh={"data": 1}, strategy="dp", remat=remat)
        return self.plan

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None,
             sample_batch: dict | None = None) -> TrainState:
        """The initial state.  With a ``generator`` (on the model's
        device) the weights are drawn anew (``DecoderLM.init_weights``);
        without one the model keeps the weights it holds, e.g. weights
        carried from JAX (``interop.decoder_from_jax_params``)."""
        if self.plan is None:
            self.build_plan(generator, sample_batch)
        elif sample_batch is not None:
            self._check_batch(sample_batch)
        model = self.model.to(self.device)
        if generator is not None:
            model.init_weights(generator)
        prec = self.precision
        # the module holds the compute-dtype copy the loss differentiates;
        # under 'mixed' the fp32 masters live apart in the state
        self._masters_apart = prec.compute_dtype != prec.param_dtype
        params = {}
        for name, p in model.named_parameters():
            if self._masters_apart:
                params[name] = p.detach().to(prec.param_dtype, copy=True)
                p.data = p.data.to(prec.compute_dtype)
            else:
                p.data = p.data.to(prec.param_dtype)
                params[name] = p
        seed = 0
        if generator is not None:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device))
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params), seed=seed)

    @torch.no_grad()
    def adopt_state(self, state: TrainState) -> None:
        """Make the module compute with ``state``'s parameters after
        something wrote into them (a checkpoint restore): under
        ``mixed`` the module holds a compute-dtype copy of the fp32
        masters; otherwise the state's parameters are the module's."""
        if self._masters_apart:
            for name, p in self.model.named_parameters():
                p.copy_(state.params[name])

    def _check_batch(self, batch) -> None:
        k = self._grad_accum
        for leaf in batch.values():
            n = np.shape(leaf)[0] if np.ndim(leaf) else None
            if n is not None and k > 1 and n % k:
                raise ValueError(f"Global batch size {n} is not divisible "
                                 f"by grad_accum={k}.")

    # -- the train step -------------------------------------------------------

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _value_and_grad(self, batch, generator):
        if self._loss_fn is None:
            raise ValueError("AutoDistribute needs a loss_fn to train")
        names, params = zip(*self.model.named_parameters())
        with torch.enable_grad():
            if self.remat:
                loss, aux = remat_fn(self._loss_fn, self.model, batch,
                                     generator)
            else:
                loss, aux = self._loss_fn(self.model, batch, generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, params, grads)}
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    @staticmethod
    def _generator(state: TrainState, i: int) -> torch.Generator:
        """The dropout generator of slice ``i`` of this step."""
        seq = np.random.SeedSequence([state.seed, state.step, i])
        return torch.Generator().manual_seed(int(seq.generate_state(1)[0]))

    def step(self, state: TrainState, batch: dict
             ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (numpy arrays or tensors).
        Returns the updated state and ``{"loss": ..., **aux}``."""
        if self.remat is None:
            raise RuntimeError("call init() first")
        batch = self._to_device(batch)
        k = self._grad_accum
        if k == 1:
            loss, aux, grads = self._value_and_grad(
                batch, self._generator(state, 0))
        else:
            self._check_batch(batch)
            loss, grads, auxes = None, None, []
            for i in range(k):
                mb = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
                      if v.ndim else v for key, v in batch.items()}
                loss_i, aux_i, g_i = self._value_and_grad(
                    mb, self._generator(state, i))
                loss = loss_i if loss is None else loss + loss_i
                grads = g_i if grads is None else {
                    n: grads[n] + g for n, g in g_i.items()}
                auxes.append(aux_i)
            grads = {n: g / k for n, g in grads.items()}
            loss = loss / k
            # counts keep full-batch semantics (summed), ratios average
            aux = {key: torch.stack([a[key] for a in auxes]).sum(0)
                   if key in ("tokens", "items") or key.endswith("_count")
                   else torch.stack([a[key] for a in auxes]).mean(0)
                   for key in auxes[0]}
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, state.params)
            apply_updates(state.params, updates)
            if self._masters_apart:
                for name, p in self.model.named_parameters():
                    p.copy_(state.params[name])
        new_state = dataclasses.replace(state, step=state.step + 1,
                                        opt_state=opt_state)
        return new_state, {"loss": loss, **aux}

    # -- inference ------------------------------------------------------------

    def _decode_model(self, state_or_params) -> nn.Module:
        """The decoder holding ``state_or_params``'s weights: the module
        itself when they are its parameters, else a copy loaded with them
        (the fp32 masters of a ``mixed`` state, or a bare name -> tensor
        mapping)."""
        params = (state_or_params.params
                  if isinstance(state_or_params, TrainState)
                  else state_or_params)
        own = dict(self.model.named_parameters())
        if all(params.get(n) is p for n, p in own.items()):
            return self.model
        model = copy.deepcopy(self.model)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.data = params[name].detach().to(self.device)
        return model

    @torch.no_grad()
    def generate(self, state_or_params, prompt, *, max_new_tokens: int,
                 sample=None, generator: torch.Generator | None = None,
                 cache_dtype=torch.bfloat16, eos_id: int | None = None,
                 moe_decode: str = "dense", quant: str | None = None):
        """Autoregressive generation with the trained weights
        (``inference/decode.py::generate``) on this device: ``prompt``
        [B, P] -> [B, P + max_new_tokens] int32.

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
            moe_decode=moe_decode)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict
                  ) -> dict[str, torch.Tensor]:
        """The training loss and aux with no dropout and no update."""
        if self.remat is None:
            raise RuntimeError("call init() first")
        loss, aux = self._loss_fn(self.model, self._to_device(batch), None)
        return {"loss": loss, **aux}
