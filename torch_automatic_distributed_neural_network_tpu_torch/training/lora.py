"""LoRA: low-rank adapter fine-tuning on frozen base weights.

The JAX package's ``training/lora.py`` on PyTorch.  Every weight whose
name matches a target gets a pair of low-rank factors ``a [.., d_in, r]``
/ ``b [.., r, d_out]`` in the weight's MATRIX view, the effective weight
is ``W + (alpha / r) * a @ b`` laid back into the weight's own layout,
and ONLY the factors train.

The matrix view (:class:`LoraTarget`, :func:`matrix_view`) says which
dims of a weight are its input and which its output features.  The
patterns name the port's parameters (``DecoderLM.named_parameters``)
rather than the flax tree's paths, and a target says in which order its
dims come: the projections and the MLP are ``nn.Linear`` weights,
``[out, in]`` (``out_first``), where the JAX kernels are
``DenseGeneral``'s ``[in.., out..]``; the untied head keeps JAX's
``[d, V]``.  Factors keep JAX's matrix view, so a factor pair crosses
between the packages unchanged (``interop.lora_from_jax``): on an
``[out, in]`` weight the delta is ``scaling * (a @ b).T``, a ``q_proj``
factor is ``d_model`` by ``H*hd`` with head-major output rows, as the
weight's own rows are.  The same table gives the int8 decode weights
their per-output-channel scales (``inference/quant.py``).

The integration keeps the JAX package's user flow::

    spec = LoraSpec(rank=8)                          # q_proj + v_proj
    ad = AutoDistribute(
        model,
        optimizer=lora_optimizer(adamw(1e-4)),
        loss_fn=lora_loss(next_token_loss, spec),
        init_fn=lora_init_fn(base_state_dict, spec),
    )

``lora_init_fn`` loads the base weights, freezes them
(``requires_grad=False``) and puts fresh factors on every targeted
``nn.Linear`` (:func:`apply_lora`: the module becomes a
:class:`LoraLinear`, whose forward merges ``W + scaling * (a @ b).T`` in
fp32 per call, as ``merge_lora`` does inside the JAX loss).
``lora_loss`` holds the model to the spec; ``lora_optimizer`` gives the
factors the inner optimizer and the base ``set_to_zero`` — zero update
and no state, so Adam moments exist only for the factors.
``AutoDistribute`` hands the optimizer and the gradient only the
parameters that train.  :func:`merge_lora` folds trained factors back
into plain weights that a ``DecoderLM`` loads.

A target that is a bare parameter rather than an ``nn.Linear`` weight
(``HEAD_LIKE``: Llama's untied ``lm_head [d, V]``, JAX's ``[in, out]``
view) carries its factors beside it on its owner, as ``<name>_lora_a`` /
``<name>_lora_b``; the owner's class becomes a subclass whose read of the
parameter returns the merged weight ``W + scaling * a @ b`` (fp32
contraction and sum, stored in W's dtype), so every use of it adapts.

Under a tensor-parallel plan (``executor``'s wrappers) a targeted
module's weight is a ``DTensor``; :func:`adapted` lays the factors out
as the weight is split (a column-split weight's ``b`` and a row-split
weight's ``a`` sharded with it, the other replicated), so the merge is
the rank's shard of the merged weight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import warnings
from collections.abc import Mapping
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class LoraTarget:
    """One kernel pattern: ``in_dims`` input dims and ``out_dims`` output
    dims at the end of the shape, inputs first (or outputs first with
    ``out_first``, the ``nn.Linear`` layout); anything earlier
    broadcasts."""

    pattern: str
    in_dims: int = 1
    out_dims: int = 1
    out_first: bool = False


# the core's kernel families in the port's layouts — one table for every
# consumer that needs the matrix view
Q_LIKE = LoraTarget(r"(q_proj|k_proj|v_proj)\.weight$", 1, 1, out_first=True)
O_LIKE = LoraTarget(r"o_proj\.weight$", 1, 1, out_first=True)
MLP_LIKE = LoraTarget(r"(up_proj|gate_proj|down_proj)\.weight$", 1, 1,
                      out_first=True)
HEAD_LIKE = LoraTarget(r"^lm_head$", 1, 1)
KERNEL_MATRIX_VIEWS = (Q_LIKE, O_LIKE, MLP_LIKE, HEAD_LIKE)

# the factor parameters an adapted ``nn.Linear`` carries
FACTOR_NAMES = ("lora_a", "lora_b")


def is_lora_name(name: str) -> bool:
    """Whether a parameter name is a LoRA factor (``...lora_a``/``_b``,
    or a bare parameter's ``..._lora_a``/``_b``)."""
    return name.rsplit(".", 1)[-1].endswith(FACTOR_NAMES)


def factor_prefix(name: str) -> str:
    """The prefix of a targeted weight's factor names: ``layers.0.attn.
    q_proj.`` for ``layers.0.attn.q_proj.weight`` (the module's
    ``lora_a``), ``lm_head_`` for a bare parameter ``lm_head``."""
    return name[:-len("weight")] if name.endswith(".weight") else name + "_"


def factor_site(name: str) -> str:
    """The weight a factor name adapts (inverse of :func:`factor_prefix`)."""
    stem = name[:-len("lora_a")]
    return stem + "weight" if stem.endswith(".") else stem[:-1]


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    rank: int = 8
    alpha: float = 16.0
    # the classic LoRA attention recipe by default; plain-string entries
    # mean 2-D [out, in] nn.Linear weights
    targets: Sequence[LoraTarget | str] = (
        LoraTarget(r"q_proj\.weight$", 1, 1, out_first=True),
        LoraTarget(r"v_proj\.weight$", 1, 1, out_first=True),
    )
    # factor-a init scale (b starts at zero so step 0 is exactly the
    # base model)
    init_scale: float = 0.01

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def resolve(self, path: str) -> LoraTarget | None:
        for t in self.targets:
            if isinstance(t, str):  # a 2-D nn.Linear weight, [out, in]
                t = LoraTarget(t, 1, 1, out_first=True)
            if re.search(t.pattern, path):
                return t
        return None

    def check_matrix_view(self, path: str, shape) -> None:
        """Warn when a plain-string target (implicit 2-D matrix view)
        hits a weight with more dims: the (1, 1) split then treats every
        leading dim as broadcast, which can build factors larger than
        the frozen weight."""
        for t in self.targets:
            if not isinstance(t, str):
                if re.search(t.pattern, path):
                    return  # an explicit target wins the resolve
                continue
            if re.search(t, path) and len(shape) > 2:
                warnings.warn(
                    f"LoRA target {t!r} is a plain string (implicit 2-D "
                    f"matrix view) but matched {path} with shape "
                    f"{tuple(shape)}: the extra leading dims become "
                    f"broadcast dims, so the rank-{self.rank} factors can "
                    "be larger than the kernel itself.  Use an explicit "
                    "LoraTarget(pattern, in_dims, out_dims, out_first) — "
                    "see KERNEL_MATRIX_VIEWS for the core kernel "
                    "families.", stacklevel=3)
                return


def _trailing(shape, target: LoraTarget):
    n = target.in_dims + target.out_dims
    if len(shape) < n:
        raise ValueError(
            f"kernel shape {tuple(shape)} has fewer dims than the target's "
            f"in_dims+out_dims={n} ({target})")
    return len(shape) - n


def matrix_view(shape, target: LoraTarget):
    """(lead dims, d_in, d_out) of a kernel under ``target``'s split.
    Lead dims derive from the shape (``len(shape) - in_dims -
    out_dims``), so stacked and single kernels both resolve."""
    n_lead = _trailing(shape, target)
    lead = tuple(shape[:n_lead])
    first, second = ((target.out_dims, target.in_dims) if target.out_first
                     else (target.in_dims, target.out_dims))
    a = math.prod(shape[n_lead:n_lead + first])
    b = math.prod(shape[n_lead + first:n_lead + first + second])
    d_in, d_out = (b, a) if target.out_first else (a, b)
    return lead, int(d_in), int(d_out)


def input_dims(shape, target: LoraTarget) -> tuple[int, ...]:
    """The axes of a kernel of ``shape`` that hold its input features:
    the dims a per-output-channel scale reduces over."""
    n_lead = _trailing(shape, target)
    start = n_lead + (target.out_dims if target.out_first else 0)
    return tuple(range(start, start + target.in_dims))


def _named_shapes(base) -> dict[str, tuple[int, ...]]:
    """name -> shape of every base weight: a module's parameters (its
    factors left out), or a mapping name -> tensor or shape."""
    if isinstance(base, nn.Module):
        items = base.named_parameters()
    elif isinstance(base, Mapping):
        items = base.items()
    else:
        raise TypeError(f"base must be a module or a name -> tensor "
                        f"mapping, got {type(base).__name__}")
    return {n: tuple(getattr(v, "shape", v)) for n, v in items
            if not is_lora_name(n)}


def _no_match(spec: LoraSpec) -> ValueError:
    return ValueError(
        f"LoraSpec targets {tuple(spec.targets)} matched no >=2-D kernel "
        "in the base params — check the patterns against the model's "
        "parameter names")


def adapter_shapes(base, spec: LoraSpec) -> dict:
    """``name -> (lead, d_in, d_out)`` for every weight ``spec`` matches
    (a module or a name -> tensor/shape mapping): the factor geometry of
    :func:`init_lora_params` without building tensors.  The serving
    adapter pool sizes its factor stacks from this table.  Raises when
    nothing matches."""
    out: dict = {}
    for name, shape in _named_shapes(base).items():
        target = spec.resolve(name)
        if target is None or len(shape) < 2:
            continue
        spec.check_matrix_view(name, shape)
        out[name] = matrix_view(shape, target)
    if not out:
        raise _no_match(spec)
    return out


def init_lora_params(generator: torch.Generator | None, base,
                     spec: LoraSpec) -> dict:
    """``{name: {"a": [.., d_in, r], "b": [.., r, d_out]}}`` fp32 for
    every weight ``spec`` matches: ``a`` normal with std
    ``spec.init_scale`` from ``generator`` (drawn in name order on the
    generator's device, returned on the CPU), ``b`` zero.  Raises if
    nothing matches — a silent no-adapter config would train nothing."""
    gen_device = generator.device if generator is not None else "cpu"
    out = {}
    for name, (lead, d_in, d_out) in adapter_shapes(base, spec).items():
        a = spec.init_scale * torch.randn(
            (*lead, d_in, spec.rank), generator=generator,
            device=gen_device, dtype=torch.float32)
        b = torch.zeros((*lead, spec.rank, d_out), dtype=torch.float32)
        out[name] = {"a": a.cpu(), "b": b}
    return out


def lora_delta(a: torch.Tensor, b: torch.Tensor, scaling: float,
               target: LoraTarget, shape) -> torch.Tensor:
    """``scaling * a @ b`` in fp32, laid into a weight of ``shape``
    under ``target``'s view (transposed for an ``[out, in]`` weight)."""
    d = scaling * (a.to(torch.float32) @ b.to(torch.float32))
    if target.out_first:
        d = d.transpose(-1, -2)
    return d.reshape(shape)


def merge_lora(base, lora: Mapping[str, Mapping[str, torch.Tensor]],
               spec: LoraSpec) -> dict[str, torch.Tensor]:
    """base + scaling * a @ b on every adapted weight (the others pass
    through by identity): a plain name -> tensor mapping that a
    ``DecoderLM`` without adapters loads.  ``base``: a name -> tensor
    mapping, or a module (its state without the factors).  The rank-r
    contraction runs in fp32, the sum is stored in the base dtype."""
    if isinstance(base, nn.Module):
        base = {n: t for n, t in base.state_dict().items()
                if not is_lora_name(n)}
    out = dict(base)
    for name, fac in lora.items():
        target = spec.resolve(name)
        if target is None:
            raise ValueError(f"factor {name!r} matches no target of {spec}")
        w = base[name]
        out[name] = (w.to(torch.float32) + lora_delta(
            fac["a"], fac["b"], spec.scaling, target, w.shape)).to(w.dtype)
    return out


class LoraLinear(nn.Linear):
    """An ``nn.Linear`` carrying LoRA factors ``lora_a [in, r]`` /
    ``lora_b [r, out]``: its forward computes with the merged weight
    ``W + scaling * (a @ b).T`` (fp32 contraction and sum, stored in the
    weight's dtype, then cast to the input's as the port's ``Linear``
    does).  :func:`apply_lora` makes a module one; the factors may be
    parameters (training) or plain tensors (:func:`adapted`)."""

    lora_scaling: float

    def merged_weight(self) -> torch.Tensor:
        from ..models.transformer_core import dense_weight

        w = dense_weight(self.weight, torch.float32)
        delta = self.lora_scaling * (self.lora_a.to(torch.float32)
                                     @ self.lora_b.to(torch.float32))
        dtype = (self.weight.dtype if isinstance(self.weight, torch.Tensor)
                 else torch.float32)
        return (w + delta.transpose(0, 1)).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.merged_weight().to(x.dtype), bias)


_LORA_CLASSES: dict[type, type] = {}


def _lora_class(cls: type) -> type:
    """:class:`LoraLinear` over a linear module class (the port's
    ``Linear``, or ``nn.Linear`` itself), made once per class."""
    if cls is nn.Linear:
        return LoraLinear
    if cls not in _LORA_CLASSES:
        _LORA_CLASSES[cls] = type(f"Lora{cls.__name__}", (LoraLinear, cls),
                                  {"__module__": __name__})
    return _LORA_CLASSES[cls]


class LoraParams:
    """Mixed into a module's class by :func:`apply_lora` for the bare
    parameters it adapts: reading one (``_lora_sites``: name -> target)
    gives ``W + scaling * a @ b`` laid into W's shape, in W's dtype, from
    the factors ``<name>_lora_a`` / ``<name>_lora_b`` beside it."""

    def __getattr__(self, name: str):
        sites = self.__dict__.get("_lora_sites")
        if sites is None or name not in sites:
            return super().__getattr__(name)
        from ..models.transformer_core import dense_weight, gathered

        w = gathered(super().__getattr__(name))
        a = self._lora_factor(f"{name}_lora_a")
        b = self._lora_factor(f"{name}_lora_b")
        d = lora_delta(gathered(a), gathered(b), self._lora_scaling,
                       sites[name], w.shape)
        dtype = w.dtype if isinstance(w, torch.Tensor) else torch.float32
        return (dense_weight(w, torch.float32) + d).to(dtype)

    def _lora_factor(self, name: str):
        got = self.__dict__.get(name)
        return got if got is not None else super().__getattr__(name)


_PARAM_CLASSES: dict[type, type] = {}


def _params_class(cls: type) -> type:
    """:class:`LoraParams` over a module class, made once per class."""
    if issubclass(cls, LoraParams):
        return cls
    if cls not in _PARAM_CLASSES:
        _PARAM_CLASSES[cls] = type(f"Lora{cls.__name__}", (LoraParams, cls),
                                   {"__module__": __name__})
    return _PARAM_CLASSES[cls]


def _site_of(model: nn.Module, name: str, target: LoraTarget):
    """(owning module, attribute, whether it is an ``nn.Linear``'s
    ``[out, in]`` weight) of a targeted weight."""
    owner_name, _, attr = name.rpartition(".")
    owner = model.get_submodule(owner_name) if owner_name else model
    linear = attr == "weight" and isinstance(owner, nn.Linear)
    if linear != target.out_first:
        raise NotImplementedError(
            f"LoRA on {name!r}: an out_first target adapts an nn.Linear "
            "weight, any other target a bare parameter in JAX's [in, out] "
            "view")
    return owner, attr, linear


def _tp_factors(weight, a, b):
    """``a`` / ``b`` as ``DTensor``s split as ``weight`` is (module
    docstring); as they are for a plain weight."""
    from ..utils.device import is_dtensor

    if not is_dtensor(weight):
        return a, b
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    place = weight.placements[0]
    mesh = weight.device_mesh
    a_pl = Shard(0) if place.is_shard() and place.dim == 1 else Replicate()
    b_pl = Shard(1) if place.is_shard() and place.dim == 0 else Replicate()
    return (distribute_tensor(a, mesh, [a_pl], src_data_rank=None),
            distribute_tensor(b, mesh, [b_pl], src_data_rank=None))


def _install(model: nn.Module, spec: LoraSpec, lora: Mapping,
             as_parameters: bool) -> list:
    """Put ``lora``'s factors on their ``nn.Linear`` modules; returns
    (module, old class) pairs."""
    shapes = adapter_shapes(model, spec)
    if set(lora) != set(shapes):
        raise ValueError(
            f"factor sites {sorted(lora)[:4]}... do not match the spec's "
            f"sites {sorted(shapes)[:4]}... ({len(lora)} vs {len(shapes)})")
    done = []
    for name, fac in lora.items():
        target = spec.resolve(name)
        mod, attr, linear = _site_of(model, name, target)
        _, d_in, d_out = shapes[name]
        a, b = fac["a"], fac["b"]
        if tuple(a.shape) != (d_in, spec.rank) or tuple(b.shape) != (
                spec.rank, d_out):
            raise ValueError(
                f"{name}: factors a{tuple(a.shape)} / b{tuple(b.shape)} "
                f"do not match a{(d_in, spec.rank)} / b{(spec.rank, d_out)}")
        weight = mod._parameters[attr]
        dev = weight.device
        if not any(m is mod for m, _ in done):
            done.append((mod, mod.__class__))
        if linear:
            names = FACTOR_NAMES
            if not isinstance(mod, LoraLinear):
                mod.__class__ = _lora_class(type(mod))
            mod.lora_scaling = spec.scaling
        else:
            names = (f"{attr}_lora_a", f"{attr}_lora_b")
            mod.__class__ = _params_class(type(mod))
            mod.__dict__.setdefault("_lora_sites", {})[attr] = target
            mod._lora_scaling = spec.scaling
        if as_parameters:
            # copies: training updates the factors in place
            for n, x in zip(names, (a, b)):
                setattr(mod, n, nn.Parameter(
                    x.detach().to(dev, torch.float32, copy=True)))
        else:
            for n, x in zip(names, _tp_factors(weight, a.to(dev),
                                               b.to(dev))):
                object.__setattr__(mod, n, x)
    return done


def apply_lora(model: nn.Module, spec: LoraSpec, lora: Mapping | None = None,
               *, generator: torch.Generator | None = None) -> nn.Module:
    """Adapt ``model`` in place for fine-tuning: every targeted
    ``nn.Linear`` carries its factors as fp32 parameters ``lora_a`` /
    ``lora_b`` (``lora``, else fresh ones from ``generator``:
    :func:`init_lora_params`) and merges them in its forward; every
    other parameter is frozen (``requires_grad=False``).  Records the
    spec as ``model.lora_spec``."""
    if getattr(model, "lora_spec", None) is not None:
        raise ValueError("the model already carries LoRA adapters")
    if lora is None:
        lora = init_lora_params(generator, model, spec)
    for p in model.parameters():
        p.requires_grad_(False)
    _install(model, spec, lora, as_parameters=True)
    model.lora_spec = spec
    return model


def lora_named(lora: Mapping) -> dict[str, torch.Tensor]:
    """``{name: {"a", "b"}}`` as the parameter names an adapted module
    gives its factors (``...lora_a`` / ``...lora_b``)."""
    out = {}
    for name, fac in lora.items():
        prefix = factor_prefix(name)
        out[prefix + "lora_a"], out[prefix + "lora_b"] = fac["a"], fac["b"]
    return out


def lora_state(model: nn.Module) -> dict:
    """The factors an adapted module carries, as ``{name: {"a", "b"}}``
    keyed by the adapted weight's name (detached, not copied)."""
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, LoraLinear):
            out[f"{prefix}weight"] = {"a": mod.lora_a.detach(),
                                      "b": mod.lora_b.detach()}
        for attr in mod.__dict__.get("_lora_sites", ()):
            out[prefix + attr] = {
                "a": mod._lora_factor(f"{attr}_lora_a").detach(),
                "b": mod._lora_factor(f"{attr}_lora_b").detach()}
    return out


@contextlib.contextmanager
def adapted(model: nn.Module, lora: Mapping | None, spec: LoraSpec):
    """``model`` computing with ``lora``'s factors merged into its
    targeted weights for the duration (plain tensors on each module, no
    parameter and no merged copy of the model: each forward merges per
    layer); ``lora=None`` is the base model.  The serving engine's
    prefill of a tenant's prompt runs under it."""
    if lora is None:
        yield model
        return
    if getattr(model, "lora_spec", None) is not None:
        raise ValueError("adapted() takes a model without adapters of its "
                         "own")
    done = _install(model, spec, lora, as_parameters=False)
    try:
        yield model
    finally:
        for mod, cls in done:
            for attr in mod.__dict__.pop("_lora_sites", ()):
                for side in FACTOR_NAMES:
                    mod.__dict__.pop(f"{attr}_{side}", None)
            for attr in FACTOR_NAMES + ("lora_scaling", "_lora_scaling"):
                mod.__dict__.pop(attr, None)
            mod.__class__ = cls


def _load_base(model: nn.Module, base) -> None:
    state = (base.state_dict() if isinstance(base, nn.Module) else base)
    state = {n: t for n, t in state.items() if not is_lora_name(n)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [n for n in missing if not is_lora_name(n)]
    if missing or unexpected:
        raise KeyError(f"base weights do not match the model: missing "
                       f"{missing[:4]}, unexpected {unexpected[:4]}")


def lora_init_fn(base, spec: LoraSpec) -> Callable:
    """``init_fn`` for ``AutoDistribute``: ``init(model, generator)``
    loads ``base`` (a state dict or a module; None keeps the model's
    weights), freezes it and adds fresh factors from ``generator``
    (:func:`apply_lora`).  ``AutoDistribute`` calls it once, before it
    plans, so the plan sees the factors."""

    def init(model: nn.Module, generator: torch.Generator | None) -> None:
        if base is not None:
            _load_base(model, base)
        apply_lora(model, spec, generator=generator)

    return init


def lora_loss(loss_fn: Callable, spec: LoraSpec) -> Callable:
    """Wrap an ``AutoDistribute`` loss: the loss of the merged weights.
    The adapted modules merge in their forward, so the wrapper holds the
    model (or the wrapper a plan put around it) to ``spec`` and calls
    ``loss_fn``."""

    def wrapped(model, batch, generator):
        got = getattr(model, "lora_spec", None)
        if got is None:
            raise ValueError(
                "lora_loss: the model carries no LoRA adapters — pass "
                "AutoDistribute(init_fn=lora_init_fn(base, spec)) or call "
                "apply_lora(model, spec)")
        if got != spec:
            raise ValueError(f"lora_loss: the model's adapters follow {got}, "
                             f"the loss {spec}")
        return loss_fn(model, batch, generator)

    wrapped.lora_spec = spec
    return wrapped


def _label(params: Mapping[str, Any]) -> dict[str, str]:
    """'lora' for each factor, 'base' for every other parameter."""
    return {n: "lora" if is_lora_name(n) else "base" for n in params}


def lora_optimizer(inner):
    """Train the factors only: ``inner`` on the factors, ``set_to_zero``
    on the base — zero update and zero state, so no Adam moments exist
    for the frozen weights (``optax.multi_transform``)."""
    from .optim import multi_transform, set_to_zero

    return multi_transform({"lora": inner, "base": set_to_zero()}, _label)
