"""Carry decoder weights from the JAX package's parameter tree.

:func:`decoder_from_jax_params` takes the flax ``variables["params"]``
tree of a GPT-2 or Llama ``DecoderLM`` — with every leaf already a numpy
array (``jax.tree.map(np.asarray, params)`` on the JAX side; this module
never imports jax) — and returns the port's :class:`DecoderLM` on a
device.  Layouts mapped:

- the scanned ``layers`` stack ``[L, ...]`` sliced per layer, or the
  unscanned ``layers_0`` ... ``layers_{L-1}`` (``scan_layers=False``);
- ``DenseGeneral`` q/k/v kernels ``[d, H, hd]`` with bias ``[H, hd]``,
  and ``o_proj`` ``[H, hd, d]``, flattened and transposed onto
  ``nn.Linear``'s ``[out, in]``;
- ``nn.Dense`` MLP kernels ``[in, out]``, transposed the same way;
- a tied ``embed.embedding`` ``[V, d]`` or an untied ``lm_head.kernel``
  ``[d, V]`` (kept ``[d, V]``), ``pos_embed``, and the ``embed_norm`` and
  ``final_norm`` the config has;
- int8 leaves (``{"q", "scale"}``, the JAX ``quantize_for_decode``'s
  output): the payload and its scales take the same layout change and
  land as a :class:`~.inference.quant.QuantizedWeight`, so both packages
  decode with the same int8 weights.

The same mapping carries trained JAX parameters, so a port's
``state_dict`` after training steps compares with
``decoder_from_jax_params(jax_params_after, cfg).state_dict()``, and
:func:`train_state_from_jax` carries a whole JAX train state (step,
parameters and the AdamW moments, which have the parameters' tree) into
the port's ``TrainState``, so a JAX run continues in the port.

LoRA factors (:func:`lora_from_jax`): the JAX package's factor tree
(``init_lora_params``' layout, scan-stacked ``a [L, d_in, r]`` /
``b [L, r, d_out]``) split per layer and keyed by the port's weight
names; both packages keep the factors in the matrix view, so no factor
is transposed.  A LoRA train state (``{"base", "lora"}`` parameters and
``lora_optimizer``'s moments) crosses through
:func:`train_state_from_jax` too.
"""

from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from .inference.quant import is_quantized_leaf, put_quantized
from .models.transformer_core import DecoderLM, TransformerConfig
from .utils.device import resolve_device

if TYPE_CHECKING:
    from .core import AutoDistribute, TrainState


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _layer_params(params: dict, n_layers: int) -> list[dict]:
    """One numpy tree per layer, from either layer layout."""
    if "layers" in params:
        stack = params["layers"]

        def at(tree, i):
            if isinstance(tree, dict):
                return {k: at(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        return [at(stack, i) for i in range(n_layers)]
    if "layers_0" in params:
        return [params[f"layers_{i}"] for i in range(n_layers)]
    raise ValueError("expected a 'layers' stack or 'layers_0' ... entries")


def decoder_from_jax_params(params: dict, cfg: TransformerConfig, *,
                            device=None) -> DecoderLM:
    """The port's ``DecoderLM`` holding the weights of a JAX decoder's
    numpy ``params`` tree, on ``device`` (default ``cuda``, raising
    without it; pass ``"cpu"`` for the CPU)."""
    model = DecoderLM(cfg)
    state: dict[str, torch.Tensor] = {}
    quantized: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def put(name, leaf, layout=lambda x: x):
        """``leaf`` in the port's layout under ``name``; an int8 leaf's
        payload and scales take the same layout."""
        if is_quantized_leaf(leaf):
            quantized[name] = (
                torch.from_numpy(np.array(
                    layout(np.asarray(leaf["q"])), dtype=np.int8)),
                _t(layout(np.asarray(leaf["scale"]))))
        else:
            state[name] = _t(layout(np.asarray(leaf)))

    put("embed", params["embed"]["embedding"])
    if cfg.pos == "learned":
        state["pos_embed"] = _t(params["pos_embed"])
    if not cfg.tie_embeddings:
        put("lm_head", params["lm_head"]["kernel"])
    for norm in ("embed_norm", "final_norm"):
        if getattr(cfg, norm):
            for name, leaf in params[norm].items():
                state[f"{norm}.{name}"] = _t(leaf)

    for i, layer in enumerate(_layer_params(params, cfg.n_layers)):
        pre = f"layers.{i}."
        for norm in ("attn_norm", "mlp_norm"):
            for name, leaf in layer[norm].items():
                state[f"{pre}{norm}.{name}"] = _t(leaf)
        for proj in ("q_proj", "k_proj", "v_proj"):
            p = layer["attn"][proj]
            put(f"{pre}attn.{proj}.weight", p["kernel"],  # [d, H, hd]
                lambda x: x.reshape(x.shape[0], -1).T)
            if "bias" in p:
                state[f"{pre}attn.{proj}.bias"] = _t(
                    np.asarray(p["bias"]).reshape(-1))
        p = layer["attn"]["o_proj"]
        put(f"{pre}attn.o_proj.weight", p["kernel"],  # [H, hd, d]
            lambda x: x.reshape(-1, x.shape[-1]).T)
        if "bias" in p:
            state[f"{pre}attn.o_proj.bias"] = _t(p["bias"])
        for proj, p in layer["mlp"].items():
            put(f"{pre}mlp.{proj}.weight", p["kernel"], lambda x: x.T)
            if "bias" in p:
                state[f"{pre}mlp.{proj}.bias"] = _t(p["bias"])

    for name, (q, scale) in quantized.items():
        put_quantized(model, name, q, scale)
        state[f"{name}.q"], state[f"{name}.scale"] = q, scale
    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device))


def jax_param_path(name: str) -> str:
    """The JAX decoder's '/'-joined parameter path (unscanned layers,
    ``scan_layers=False``) of the port parameter ``name``: the map
    :func:`decoder_from_jax_params` follows, e.g.
    ``layers.3.attn.q_proj.weight`` -> ``layers_3/attn/q_proj/kernel``,
    ``embed`` -> ``embed/embedding``, ``lm_head`` -> ``lm_head/kernel``."""
    if name in ("embed", "lm_head"):
        return {"embed": "embed/embedding", "lm_head": "lm_head/kernel"}[name]
    path = re.sub(r"^layers\.(\d+)\.", r"layers_\1/", name)
    if path.endswith(".weight"):
        path = path[:-len(".weight")] + ".kernel"
    return path.replace(".", "/")


def port_param_name(path: str) -> str:
    """The port parameter name of a JAX decoder's '/'-joined path with
    unscanned layers: the inverse of :func:`jax_param_path`."""
    if path in ("embed/embedding", "lm_head/kernel"):
        return path.split("/")[0]
    name = re.sub(r"^layers_(\d+)/", r"layers.\1/", path)
    if name.endswith("/kernel"):
        name = name[:-len("/kernel")] + "/weight"
    return name.replace("/", ".")


def lora_from_jax(lora: dict, n_layers: int
                  ) -> dict[str, dict[str, torch.Tensor]]:
    """The port's ``{weight name: {"a", "b"}}`` fp32 factors of a JAX
    factor tree with numpy leaves: a scan-stacked site
    (``layers/.../kernel``) gives one entry a layer, an unscanned one
    (``layers_3/...``) its own."""
    sites = []

    def walk(node, path):
        if set(node) == {"a", "b"} and not isinstance(node["a"], dict):
            sites.append(("/".join(path), node))
            return
        for k, v in node.items():
            walk(v, path + [k])

    walk(lora, [])
    out = {}
    for path, node in sites:
        a, b = np.asarray(node["a"]), np.asarray(node["b"])
        if path.startswith("layers/"):
            for i in range(n_layers):
                out[port_param_name(f"layers_{i}/{path[len('layers/'):]}")
                    ] = {"a": _t(a[i]), "b": _t(b[i])}
        else:
            out[port_param_name(path)] = {"a": _t(a), "b": _t(b)}
    return out


def _field(obj: Any, name: str) -> Any:
    """``obj.name`` or ``obj[name]``: a JAX struct, NamedTuple or dict."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _with_count(tree: Any, count: int) -> Any:
    """``tree`` with every ``"count"`` entry set to ``count``."""
    if isinstance(tree, dict):
        return {k: count if k == "count" else _with_count(v, count)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_count(v, count) for v in tree)
    return tree


def _adam_state(opt_state: Any) -> Any:
    """optax's AdamW state (``count``, ``mu``, ``nu``) inside a JAX
    optimizer state: the chain's first element, or the ``lora`` branch
    of ``lora_optimizer``'s ``multi_transform``."""
    inner = getattr(opt_state, "inner_states", None)
    if inner is not None:
        lora = inner["lora"]
        return _adam_state(getattr(lora, "inner_state", lora))
    if isinstance(opt_state, (list, tuple)) and not hasattr(opt_state, "mu"):
        return _adam_state(opt_state[0])
    return opt_state


def train_state_from_jax(ad: "AutoDistribute", jax_state: Any, *,
                         seed: int = 0) -> "TrainState":
    """The port's ``TrainState`` continuing a JAX ``TrainState``.

    ``jax_state``: the JAX package's state with numpy leaves
    (``jax.tree.map(np.asarray, ...)`` on the JAX side, the rng left out
    or as key data): its ``step``, ``params`` and ``opt_state``, whose
    first element is optax's AdamW state (``count``, ``mu``, ``nu``).
    ``ad``: a port ``AutoDistribute`` not yet initialized, over a
    ``DecoderLM`` of the JAX model's config, with ``adamw``.  The
    parameters go into ``ad.model`` and the moments into the state
    through :func:`decoder_from_jax_params`'s mapping; every optimizer
    count becomes AdamW's.  ``seed`` takes the place of the JAX rng (the
    port draws dropout masks from its own generators).

    A LoRA state (parameters ``{"base", "lora"}``, ``lora_optimizer``'s
    moments): ``ad`` is built with ``lora_loss``/``lora_optimizer`` and
    no ``init_fn`` (the factors come from the state, the spec from
    ``lora_loss``), its model takes the base weights and
    the carried factors (``training.lora.apply_lora``), and the moments
    of the factors go into the state."""
    from .training.lora import apply_lora, lora_named

    cfg = ad.model.cfg

    def port_named(tree) -> dict[str, torch.Tensor]:
        return decoder_from_jax_params(tree, cfg, device="cpu").state_dict()

    params = _field(jax_state, "params")
    adam = _adam_state(_field(jax_state, "opt_state"))
    if isinstance(params, dict) and set(params) == {"base", "lora"}:
        spec = getattr(ad._loss_fn, "lora_spec", None)
        if spec is None:
            raise ValueError("a LoRA state needs an AutoDistribute whose "
                             "loss_fn is lora_loss(..., spec)")
        ad.model.load_state_dict(port_named(params["base"]))
        apply_lora(ad.model, spec, lora_from_jax(params["lora"],
                                                 cfg.n_layers))
        moments = {key: lora_named(lora_from_jax(
            _field(adam, key)["lora"], cfg.n_layers)) for key in ("mu", "nu")}
    else:
        ad.model.load_state_dict(port_named(params))
        moments = {"mu": port_named(_field(adam, "mu")),
                   "nu": port_named(_field(adam, "nu"))}
    state = ad.init(None)

    def fill(tree):
        if isinstance(tree, dict):
            if "mu" in tree and "nu" in tree:
                with torch.no_grad():
                    for key, named in moments.items():
                        for name, t in tree[key].items():
                            t.copy_(named[name])
            for v in tree.values():
                fill(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                fill(v)

    fill(state.opt_state)
    count = int(np.asarray(_field(adam, "count")))
    return dataclasses.replace(
        state, step=int(np.asarray(_field(jax_state, "step"))),
        opt_state=_with_count(state.opt_state, count), seed=seed)
