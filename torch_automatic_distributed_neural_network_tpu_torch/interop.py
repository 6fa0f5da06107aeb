"""Carry model weights from the JAX package's parameter trees.

:func:`decoder_from_jax_params` takes the flax ``variables["params"]``
tree of a GPT-2 or Llama ``DecoderLM`` — with every leaf already a numpy
array (``jax.tree.map(np.asarray, params)`` on the JAX side; this module
never imports jax) — and returns the port's :class:`DecoderLM` on a
device.  One function a family does the same for the rest of the zoo:
:func:`bert_from_jax_params` (and :func:`bert_classifier_from_jax_params`),
:func:`vit_from_jax_params`, :func:`mt_from_jax_params`,
:func:`moe_from_jax_params`, :func:`mlp_from_jax_params`,
:func:`resnet_from_jax_params` (parameters and ``batch_stats``) and
:func:`bridge_from_jax_variables` (a ``from_torch`` bridge's
``params``, ``batch_stats`` and ``constants``, by name);
:func:`from_jax_params` picks by a port model's family, and
:func:`jax_param_path` gives the JAX path of a port name that they follow.
Layouts mapped:

- the scanned ``layers`` stack ``[L, ...]`` sliced per layer, or the
  unscanned ``layers_0`` ... ``layers_{L-1}`` (``scan_layers=False``);
- ``DenseGeneral`` q/k/v kernels ``[d, H, hd]`` with bias ``[H, hd]``,
  and ``o_proj`` ``[H, hd, d]``, flattened and transposed onto
  ``nn.Linear``'s ``[out, in]``;
- ``nn.Dense`` MLP kernels ``[in, out]``, transposed the same way;
- ResNet's ``nn.Conv`` kernels HWIO onto ``nn.Conv2d``'s OIHW, and its
  BatchNorm ``scale``/``bias`` (parameters) and ``mean``/``var`` (the
  ``batch_stats`` collection, the port's buffers) under the same names;
- a tied ``embed.embedding`` ``[V, d]`` or an untied ``lm_head.kernel``
  ``[d, V]`` (kept ``[d, V]``), ``pos_embed``, ``seg_embed`` (BERT's
  token types), and the ``embed_norm`` and ``final_norm`` the config
  has;
- MoE layers: the ``router`` kernel ``[d, E]`` as a linear layer, and
  the ``experts_{up,gate,down}`` banks ``[E, d, f]`` / ``[E, f, d]`` kept
  in the JAX layout;
- int8 leaves (``{"q", "scale"}``, the JAX ``quantize_for_decode``'s
  output): the payload and its scales take the same layout change and
  land as a :class:`~.inference.quant.QuantizedWeight`, so both packages
  decode with the same int8 weights.

The same mapping carries trained JAX parameters, so a port's
``state_dict`` after training steps compares with
``decoder_from_jax_params(jax_params_after, cfg).state_dict()``, and
:func:`train_state_from_jax` carries a whole JAX train state (step,
parameters and the AdamW moments, which have the parameters' tree) into
the port's ``TrainState``, so a JAX run continues in the port (any
family of the zoo; the AdamW moments or SGD's momentum trace, and a
stateful model's ``model_state``).

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


class _Carry:
    """Port name -> fp32 tensor (or int8 payload and scales) of a JAX
    numpy tree."""

    def __init__(self):
        self.state: dict[str, torch.Tensor] = {}
        self.quantized: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def put(self, name, leaf, layout=lambda x: x):
        """``leaf`` in the port's layout under ``name``; an int8 leaf's
        payload and scales take the same layout."""
        if is_quantized_leaf(leaf):
            self.quantized[name] = (
                torch.from_numpy(np.array(
                    layout(np.asarray(leaf["q"])), dtype=np.int8)),
                _t(layout(np.asarray(leaf["scale"]))))
        else:
            self.state[name] = _t(layout(np.asarray(leaf)))

    def linear(self, name, p):
        """A flax ``nn.Dense`` (kernel [in, out]) onto ``nn.Linear``."""
        self.put(f"{name}.weight", p["kernel"], lambda x: x.T)
        if "bias" in p:
            self.put(f"{name}.bias", p["bias"])

    def norm(self, name, p):
        for key, leaf in p.items():
            self.put(f"{name}.{key}", leaf)

    def attention(self, name, p):
        """``DenseGeneral`` q/k/v kernels [d, H, hd] (bias [H, hd]) and
        ``o_proj`` [H, hd, d], flattened onto ``nn.Linear``."""
        for proj in ("q_proj", "k_proj", "v_proj"):
            self.put(f"{name}.{proj}.weight", p[proj]["kernel"],
                     lambda x: x.reshape(x.shape[0], -1).T)
            if "bias" in p[proj]:
                self.put(f"{name}.{proj}.bias", p[proj]["bias"],
                         lambda x: x.reshape(-1))
        self.put(f"{name}.o_proj.weight", p["o_proj"]["kernel"],
                 lambda x: x.reshape(-1, x.shape[-1]).T)
        if "bias" in p["o_proj"]:
            self.put(f"{name}.o_proj.bias", p["o_proj"]["bias"])

    def mlp(self, name, p):
        """The dense MLP's linear layers, or an MoE layer's router and its
        ``[E, d, f]`` expert banks (kept in the JAX layout)."""
        for proj, leaf in p.items():
            if proj.startswith("experts_"):
                self.put(f"{name}.{proj}", leaf)
            else:
                self.linear(f"{name}.{proj}", leaf)

    def nest(self, prefix: str, sub: "_Carry") -> None:
        """``sub``'s entries under the module ``prefix``."""
        for name, t in sub.state.items():
            self.state[f"{prefix}.{name}"] = t
        for name, qs in sub.quantized.items():
            self.quantized[f"{prefix}.{name}"] = qs


def _backbone(c: _Carry, params: dict, cfg: TransformerConfig, *,
              token_embed: bool = True) -> None:
    """The shared backbone's entries (``transformer_core.build_backbone``)."""
    if token_embed:
        c.put("embed", params["embed"]["embedding"])
    if cfg.pos == "learned":
        c.put("pos_embed", params["pos_embed"])
    if cfg.type_vocab_size:
        c.put("seg_embed", params["seg_embed"]["embedding"])
    for norm in ("embed_norm", "final_norm"):
        if getattr(cfg, norm):
            c.norm(norm, params[norm])
    for i, layer in enumerate(_layer_params(params, cfg.n_layers)):
        for norm in ("attn_norm", "mlp_norm"):
            c.norm(f"layers.{i}.{norm}", layer[norm])
        c.attention(f"layers.{i}.attn", layer["attn"])
        c.mlp(f"layers.{i}.mlp", layer["mlp"])


def _fill_decoder(c, params, model):
    _backbone(c, params, model.cfg)
    if not model.cfg.tie_embeddings:
        c.put("lm_head", params["lm_head"]["kernel"])


def _fill_bert(c, params, model):
    _backbone(c, params, model.cfg)
    if hasattr(model, "mlm_dense"):
        c.linear("mlm_dense", params["mlm_dense"])
        c.norm("mlm_norm", params["mlm_norm"])
        c.put("mlm_bias", params["mlm_bias"])


def _fill_bert_classifier(c, params, model):
    sub = _Carry()
    _fill_bert(sub, params["encoder"], model.encoder)
    c.nest("encoder", sub)
    c.linear("classifier", params["classifier"])


def _fill_vit(c, params, model):
    c.linear("patch_proj", params["patch_proj"])
    c.put("cls_token", params["cls_token"])
    _backbone(c, params, model.cfg.core, token_embed=False)
    c.linear("classifier", params["classifier"])


def _fill_mt(c, params, model):
    c.put("embed", params["embed"]["embedding"])
    c.put("pos_embed", params["pos_embed"])
    for stack, norms, attns in (
            ("enc", ("attn_norm", "mlp_norm"), ("attn",)),
            ("dec", ("attn_norm", "cross_norm", "mlp_norm"),
             ("attn", "cross_attn"))):
        for i in range(model.cfg.n_layers):
            layer = params[f"{stack}_{i}"]
            for norm in norms:
                c.norm(f"{stack}.{i}.{norm}", layer[norm])
            for attn in attns:
                c.attention(f"{stack}.{i}.{attn}", layer[attn])
            c.mlp(f"{stack}.{i}.mlp", layer["mlp"])
        c.norm(f"{stack}_norm", params[f"{stack}_norm"])


def _fill_mlp(c, params, model):
    for i in range(len(model.features)):
        c.linear(f"dense.{i}", params[f"dense_{i}"])


def _fill_resnet(c, variables, model):
    """Every entry of the model's ``state_dict`` from its JAX path: a
    4-d conv kernel HWIO -> OIHW, the classifier's [in, out] -> [out,
    in]; ``mean``/``var`` from ``batch_stats`` where ``variables`` has
    it (a parameter-shaped tree, Adam's moments, has not: the model's
    own buffers stay)."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats")
    own = model.state_dict()
    for name, t in own.items():
        *path, leaf = jax_param_path(name).split("/")
        if leaf in ("mean", "var"):
            if stats is None:
                c.state[name] = t.detach().float().cpu()
                continue
            tree = stats
        else:
            tree = params
        for key in path:
            tree = tree[key]
        c.put(name, tree[leaf], {4: lambda x: x.transpose(3, 2, 0, 1),
                                 2: lambda x: x.T}.get(t.dim(), lambda x: x))


_BRIDGE_COLLECTIONS = ("params", "batch_stats", "constants")


def _fill_bridge(c, variables, model):
    """Every entry of a ``TorchBridge``'s ``state_dict`` from the JAX
    bridge's variables by name (the two share names and layouts):
    ``params["{scope}//{name}"]`` (``qkv//kernel`` [in, out],
    ``conv1//kernel`` OIHW, ``pos//value``, ``tf//enc.l0.sa.in_w``) the
    parameters, ``batch_stats["{scope}//mean"]`` / ``"//var"`` and
    ``constants["{scope}"]`` (a traced buffer) the buffers.  A bare
    parameter-shaped tree (the Adam moments) fills the parameters; a
    buffer it lacks keeps the model's own value."""
    if "params" in variables and set(variables) <= set(_BRIDGE_COLLECTIONS):
        trees = [variables.get(k, {}) for k in _BRIDGE_COLLECTIONS]
    else:
        trees = [variables]
    for name, t in model.state_dict().items():
        leaf = next((tree[name] for tree in trees if name in tree), None)
        if leaf is None:
            c.state[name] = t.detach().cpu()
        else:
            c.put(name, leaf)


def _filler(model: torch.nn.Module):
    """The fill function of a port model's family (subclasses first)."""
    from .models import (
        MLP,
        BertClassifier,
        BertEncoder,
        ResNet,
        Seq2SeqTransformer,
        TorchBridge,
        ViTEncoder,
    )

    for cls, fill in ((BertClassifier, _fill_bert_classifier),
                      (BertEncoder, _fill_bert), (ViTEncoder, _fill_vit),
                      (Seq2SeqTransformer, _fill_mt), (MLP, _fill_mlp),
                      (ResNet, _fill_resnet), (TorchBridge, _fill_bridge),
                      (DecoderLM, _fill_decoder)):
        if isinstance(model, cls):
            return fill
    raise TypeError(f"no JAX parameter map for {type(model).__name__}")


def _load(model: torch.nn.Module, params: dict, device) -> torch.nn.Module:
    """``model`` (built on the meta device or the CPU) holding ``params``
    (a JAX numpy tree of its family), moved to ``device``."""
    c = _Carry()
    _filler(model)(c, params, model)
    for name, (q, scale) in c.quantized.items():
        put_quantized(model, name, q, scale)
        c.state[f"{name}.q"], c.state[f"{name}.scale"] = q, scale
    model.load_state_dict(c.state, strict=True)
    return model.to(resolve_device(device))


def decoder_from_jax_params(params: dict, cfg: TransformerConfig, *,
                            device=None) -> DecoderLM:
    """The port's ``DecoderLM`` holding the weights of a JAX decoder's
    numpy ``params`` tree, on ``device`` (default ``cuda``, raising
    without it; pass ``"cpu"`` for the CPU).  An ``MoEConfig`` gives the
    port's ``MoELM`` (:func:`moe_from_jax_params`)."""
    from .models.moe import MoEConfig, MoELM

    return _load((MoELM if isinstance(cfg, MoEConfig) else DecoderLM)(cfg),
                 params, device)


def moe_from_jax_params(params: dict, cfg, *, device=None):
    """The port's ``MoELM`` of a JAX ``MoELM``'s tree: the decoder's map,
    plus each layer's ``router`` kernel [d, E] onto ``nn.Linear`` and its
    ``experts_{up,gate,down}`` banks [E, d, f] / [E, f, d] as they are."""
    return decoder_from_jax_params(params, cfg, device=device)


def bert_from_jax_params(params: dict, cfg: TransformerConfig, *,
                         device=None):
    """The port's ``BertEncoder`` of a JAX ``BertEncoder``'s tree:
    ``seg_embed`` (the token-type table), ``embed_norm``, the layers, and
    the MLM head's ``mlm_dense``, ``mlm_norm`` and ``mlm_bias`` (an
    encoder without them, a classifier's, builds without the head)."""
    from .models.bert import BertEncoder

    return _load(BertEncoder(cfg, mlm_head="mlm_dense" in params), params,
                 device)


def bert_classifier_from_jax_params(params: dict, cfg: TransformerConfig, *,
                                    device=None):
    """The port's ``BertClassifier`` of a JAX ``BertClassifier``'s tree
    (``encoder`` and ``classifier``)."""
    from .models.bert import BertClassifier

    n = np.asarray(params["classifier"]["kernel"]).shape[-1]
    return _load(BertClassifier(cfg, num_classes=n), params, device)


def vit_from_jax_params(params: dict, cfg, *, device=None):
    """The port's ``ViTEncoder`` of a JAX ``ViTEncoder``'s tree:
    ``patch_proj``, ``cls_token``, the backbone without a token table and
    the ``classifier``."""
    from .models.vit import ViTEncoder

    return _load(ViTEncoder(cfg), params, device)


def mt_from_jax_params(params: dict, cfg, *, device=None):
    """The port's ``Seq2SeqTransformer`` of a JAX one's tree: the shared
    ``embed`` and ``pos_embed``, ``enc_i`` / ``dec_i`` (self-attention,
    the decoder's ``cross_attn``, the MLP and their norms), ``enc_norm``
    and ``dec_norm``."""
    from .models.transformer_mt import Seq2SeqTransformer

    return _load(Seq2SeqTransformer(cfg), params, device)


def mlp_from_jax_params(params: dict, *, device=None):
    """The port's ``MLP`` of a JAX ``MLP``'s tree (``dense_i``), its
    widths read off the kernels."""
    from .models.mlp import MLP

    kernels = [np.asarray(params[f"dense_{i}"]["kernel"])
               for i in range(len(params))]
    return _load(MLP(tuple(k.shape[1] for k in kernels),
                     in_features=kernels[0].shape[0]), params, device)


def resnet_from_jax_params(variables: dict, cfg, *, device=None):
    """The port's ``ResNet`` of a JAX ``ResNet``'s ``variables``
    (``{"params": ..., "batch_stats": ...}``, numpy leaves): conv kernels
    HWIO -> OIHW, the classifier's kernel transposed, BatchNorm's
    ``scale``/``bias`` as parameters and ``mean``/``var`` as buffers."""
    from .models.resnet import ResNet

    return _load(ResNet(cfg), variables, device)


def _like(model: torch.nn.Module, device="cpu") -> torch.nn.Module:
    """A fresh, empty model of ``model``'s family and configuration, on
    ``device``."""
    from .models import MLP, BertClassifier, BertEncoder, TorchBridge

    with torch.device("meta"):
        if isinstance(model, TorchBridge):
            fresh = TorchBridge(model.spec, model.layout)
        elif isinstance(model, BertClassifier):
            fresh = BertClassifier(model.cfg, model.num_classes)
        elif isinstance(model, BertEncoder):
            fresh = BertEncoder(model.cfg,
                                mlm_head=hasattr(model, "mlm_dense"))
        elif isinstance(model, MLP):
            fresh = MLP(model.features,
                        in_features=model.dense[0].in_features)
        else:
            fresh = type(model)(model.cfg)
    return fresh.to_empty(device=device)


def bridge_from_jax_variables(variables: dict, like: torch.nn.Module, *,
                              device=None) -> torch.nn.Module:
    """A new ``TorchBridge`` of ``like``'s graph (``models.from_torch`` of
    the same torch module) holding the JAX bridge's ``variables`` (numpy
    leaves): ``params``, ``batch_stats`` and ``constants`` by name, each
    JAX key the port's name (:func:`_fill_bridge`), on ``device``."""
    return from_jax_params(variables, like, device=device)


def from_jax_params(params: dict, like: torch.nn.Module, *,
                    device=None) -> torch.nn.Module:
    """A new port model of ``like``'s family and configuration holding a
    JAX tree of that family (parameters, or anything with their tree:
    the Adam moments), on ``device``."""
    return _load(_like(like), params, device)


# the bare tables: a port parameter that is a whole flax module's one leaf
_TABLES = {"embed": "embedding", "seg_embed": "embedding",
           "lm_head": "kernel"}


def jax_param_path(name: str) -> str:
    """The JAX model's '/'-joined parameter path (unscanned layers,
    ``scan_layers=False``) of the port parameter ``name``, for every
    family of the zoo: the map the converters follow.  A numbered
    submodule (``layers.3``, ``enc.0``, ``dense.1``) is flax's
    ``layers_3``, a linear layer's ``weight`` its ``kernel``, and a bare
    table its module's leaf, e.g. ``layers.3.attn.q_proj.weight`` ->
    ``layers_3/attn/q_proj/kernel``, ``embed`` -> ``embed/embedding``,
    ``lm_head`` -> ``lm_head/kernel``.  ResNet's names are flax's
    (``stage1_block0.conv2.weight`` -> ``stage1_block0/conv2/kernel``;
    BatchNorm's ``scale``/``bias`` and its buffers ``mean``/``var``, the
    ``batch_stats`` collection's leaves, keep their names)."""
    *mods, leaf = re.sub(r"\.(\d+)\.", r"_\1.", name).split(".")
    if leaf in _TABLES:
        mods, leaf = mods + [leaf], _TABLES[leaf]
    elif leaf == "weight":
        leaf = "kernel"
    return "/".join(mods + [leaf])


def port_param_name(path: str) -> str:
    """The port parameter name of a JAX model's '/'-joined path with
    unscanned layers: the inverse of :func:`jax_param_path`."""
    *mods, leaf = path.split("/")
    if mods and _TABLES.get(mods[-1]) == leaf:
        *mods, leaf = mods
    elif leaf == "kernel":
        leaf = "weight"
    return re.sub(r"_(\d+)\.", r".\1.", ".".join(mods + [leaf]))


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
    if hasattr(opt_state, "mu") or (isinstance(opt_state, dict)
                                    and "mu" in opt_state):
        return opt_state
    if isinstance(opt_state, (list, tuple)) and opt_state:
        return _adam_state(opt_state[0])
    return None  # optax's sgd: no moments (an empty state, or a trace)


def _trace_state(opt_state: Any) -> Any:
    """The ``trace`` tree of optax's ``TraceState`` (``sgd`` with
    momentum) inside a JAX optimizer state, or None."""
    if "trace" in getattr(opt_state, "_fields", ()):  # a NamedTuple
        return opt_state.trace
    if isinstance(opt_state, (list, tuple)):
        for s in opt_state:
            found = _trace_state(s)
            if found is not None:
                return found
    return None


def train_state_from_jax(ad: "AutoDistribute", jax_state: Any, *,
                         seed: int = 0) -> "TrainState":
    """The port's ``TrainState`` continuing a JAX ``TrainState``.

    ``jax_state``: the JAX package's state with numpy leaves
    (``jax.tree.map(np.asarray, ...)`` on the JAX side, the rng left out
    or as key data): its ``step``, ``params``, ``model_state`` (a
    stateful model's ``batch_stats``) and ``opt_state``, whose first
    element is optax's AdamW state (``count``, ``mu``, ``nu``), or
    optax's ``TraceState`` (``sgd`` with momentum: ``trace``), or holds
    no state at all (optax's ``sgd``).  ``ad``: a port
    ``AutoDistribute`` not yet initialized, over a model of the JAX
    model's family and config (any of the zoo), with ``adamw`` (or
    ``sgd``, with or without momentum).  The parameters and the model
    state go into ``ad.model`` and the moments or the trace into the
    state through the family's map (:func:`from_jax_params`); every
    optimizer count becomes AdamW's, or the step without one.  ``seed`` takes the place of the JAX rng (the
    port draws dropout masks from its own generators).

    A LoRA state (parameters ``{"base", "lora"}``, ``lora_optimizer``'s
    moments): ``ad`` is built with ``lora_loss``/``lora_optimizer`` and
    no ``init_fn`` (the factors come from the state, the spec from
    ``lora_loss``), its model takes the base weights and
    the carried factors (``training.lora.apply_lora``), and the moments
    of the factors go into the state."""
    from .training.lora import apply_lora, lora_named

    def port_named(tree) -> dict[str, torch.Tensor]:
        return from_jax_params(tree, ad.model, device="cpu").state_dict()

    params = _field(jax_state, "params")
    model_state = getattr(jax_state, "model_state", None) or {}
    opt_state = _field(jax_state, "opt_state")
    adam = _adam_state(opt_state)
    trace = _trace_state(opt_state)
    if isinstance(params, dict) and set(params) == {"base", "lora"}:
        spec = getattr(ad._loss_fn, "lora_spec", None)
        if spec is None:
            raise ValueError("a LoRA state needs an AutoDistribute whose "
                             "loss_fn is lora_loss(..., spec)")
        n_layers = ad.model.cfg.n_layers
        ad.model.load_state_dict(port_named(params["base"]))
        apply_lora(ad.model, spec, lora_from_jax(params["lora"], n_layers))
        moments = {key: lora_named(lora_from_jax(
            _field(adam, key)["lora"], n_layers)) for key in ("mu", "nu")}
    else:
        ad.model.load_state_dict(port_named(
            {"params": params, **model_state} if model_state else params))
        moments = {} if adam is None else {
            "mu": port_named(_field(adam, "mu")),
            "nu": port_named(_field(adam, "nu"))}
        if trace is not None:
            moments["trace"] = port_named(trace)
    state = ad.init(None)

    def fill(tree):
        if isinstance(tree, dict):
            if set(moments) & set(tree):
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
    step = int(np.asarray(_field(jax_state, "step")))
    count = step if adam is None else int(np.asarray(_field(adam, "count")))
    return dataclasses.replace(
        state, step=step, opt_state=_with_count(state.opt_state, count),
        seed=seed)
