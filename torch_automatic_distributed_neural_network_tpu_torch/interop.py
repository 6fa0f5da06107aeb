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
  ``final_norm`` the config has.

The same mapping carries trained JAX parameters, so a port's
``state_dict`` after training steps compares with
``decoder_from_jax_params(jax_params_after, cfg).state_dict()``, and
:func:`train_state_from_jax` carries a whole JAX train state (step,
parameters and the AdamW moments, which have the parameters' tree) into
the port's ``TrainState``, so a JAX run continues in the port.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

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
    state = {"embed": _t(params["embed"]["embedding"])}
    if cfg.pos == "learned":
        state["pos_embed"] = _t(params["pos_embed"])
    if not cfg.tie_embeddings:
        state["lm_head"] = _t(params["lm_head"]["kernel"])
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
            kernel = np.asarray(p["kernel"])  # [d, H, hd]
            state[f"{pre}attn.{proj}.weight"] = _t(
                kernel.reshape(kernel.shape[0], -1).T)
            if "bias" in p:
                state[f"{pre}attn.{proj}.bias"] = _t(
                    np.asarray(p["bias"]).reshape(-1))
        p = layer["attn"]["o_proj"]
        kernel = np.asarray(p["kernel"])  # [H, hd, d]
        state[f"{pre}attn.o_proj.weight"] = _t(
            kernel.reshape(-1, kernel.shape[-1]).T)
        if "bias" in p:
            state[f"{pre}attn.o_proj.bias"] = _t(p["bias"])
        for proj, p in layer["mlp"].items():
            state[f"{pre}mlp.{proj}.weight"] = _t(np.asarray(p["kernel"]).T)
            if "bias" in p:
                state[f"{pre}mlp.{proj}.bias"] = _t(p["bias"])

    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device))


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
    port draws dropout masks from its own generators)."""
    cfg = ad.model.cfg

    def port_named(tree) -> dict[str, torch.Tensor]:
        return decoder_from_jax_params(tree, cfg, device="cpu").state_dict()

    ad.model.load_state_dict(port_named(_field(jax_state, "params")))
    state = ad.init(None)
    adam = _field(jax_state, "opt_state")[0]
    moments = {"mu": port_named(_field(adam, "mu")),
               "nu": port_named(_field(adam, "nu"))}

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
