"""``from_torch``: an unmodified torch ``nn.Module`` under
``AutoDistribute`` — the port of the JAX package's
``models/torch_bridge.py``.

The reference's promise is that ``AutoDistribute(model)`` wraps an
unmodified ``nn.Module``.  HF checkpoints migrate through
``models/import_hf.py``; this module takes a hand-written torch model:
``torch.fx`` traces its ``forward`` once into a graph of submodule
calls, tensor methods and functions, and :class:`TorchBridge`, an
``nn.Module``, re-executes that graph with its own parameters, which
carry the JAX package's variable paths as names, so ``planner.make_plan``
sees what the JAX planner sees.

- **Leaves** (``Linear``, ``Conv2d``, ``BatchNorm1d/2d``, ``LayerNorm``,
  ``GroupNorm``, ``Embedding``, ``Dropout``, ``Flatten``, the pools,
  ``Identity`` and the common activations) run as torch's functionals
  on the bridge's parameters.  ``nn.MultiheadAttention`` and the
  ``nn.Transformer`` family (the encoder and decoder layers and stacks,
  ``nn.Transformer``) are leaves with executors of their own, written
  out in plain torch as JAX writes them in plain XLA (their forwards
  carry fast-path control flow that fx cannot trace): the need-weights
  output is the softmax before dropout, a bool mask is True where
  attention is NOT allowed, a float mask adds.  Every other torch.nn
  module is traced through to its leaves.
- **Functions and tensor methods** run as themselves, but only those of
  the JAX bridge's tables; **literals** only of its kinds.  Anything
  outside them raises :class:`UnsupportedTorchModule` naming the node,
  as in JAX, although torch could run it: the port adds no feature JAX
  lacks.  Models with data-dependent Python control flow cannot be
  traced (torch raises; the same boundary ``torch.compile`` draws).
- **Names and layouts** are JAX's: a leaf's parameters are
  ``"{scope}//{name}"`` with ``scope`` the module's path, ``.`` -> ``_``
  (``qkv//kernel``, ``bn1//scale``; the composites' dotted names, e.g.
  ``tf//enc.l0.sa.in_w``, as nested submodules, so a parameter's name
  is the JAX key); a ``Linear`` kernel is ``[in, out]`` (held as the
  transposed view of torch's ``[out, in]`` storage, so the product is
  the source's own), a ``Conv2d`` kernel OIHW, the MHA projections
  torch's.  A traced parameter (``self.pos``) is ``"{scope}//value"``,
  a traced buffer (``self.mask``) the buffer ``"{scope}"``, and
  BatchNorm's running statistics the buffers ``"{scope}//mean"`` /
  ``"//var"``.
- **State.** The bridge is ``stateful``: its buffers are
  ``TrainState.model_state``.  ``forward(..., train=True)`` enables
  dropout and BatchNorm's batch statistics; with ``mutable=True`` it
  returns ``(output, new running statistics by name)`` and writes none
  (torch's momentum blend of the unbiased variance), the port's
  ``*_mutable`` losses' convention, so a recomputed forward moves
  nothing.
- **Dropout** draws from the port's explicit generator (the losses'
  ``generator``): one seed a call, the mask drawn on the tensor's device
  from it; without a generator there is no dropout.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import is_dtensor
from .transformer_core import _dropout as seeded_dropout


class UnsupportedTorchModule(NotImplementedError):
    pass


# ---------------------------------------------------------------------------
# Graph spec (static: rebuilt from, never referring to, the source module)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    name: str
    kind: str          # placeholder | call_module | call_function |
                       # call_method | get_attr | output
    target: str        # layer kind / function id / method name / attr path
    args: tuple        # tagged: ('ref', name) | ('lit', value), nested
    kwargs: tuple      # ((key, tagged), ...)
    cfg: tuple = ()    # static layer config ((key, value), ...)
    scope: str = ""    # a leaf's parameter scope


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    nodes: tuple
    n_inputs: int


def _thaw(t, env):
    tag, v = t
    if tag == "ref":
        return env[v]
    if tag == "lit":
        return v
    if tag == "slice":
        return slice(*[_thaw(x, env) for x in v])
    seq = [_thaw(x, env) for x in v]
    return tuple(seq) if tag == "tuple" else seq


def _tag_arg(a):
    """fx arg -> tagged form (node refs, containers, slices, literals);
    a literal of another kind is refused, as in JAX."""
    if isinstance(a, torch.fx.Node):
        return ("ref", a.name)
    if isinstance(a, (list, tuple)):
        return ("tuple" if isinstance(a, tuple) else "list",
                tuple(_tag_arg(x) for x in a))
    if isinstance(a, slice):
        return ("slice", (_tag_arg(a.start), _tag_arg(a.stop),
                          _tag_arg(a.step)))
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype)):
        return ("lit", a)
    raise UnsupportedTorchModule(f"unsupported literal {type(a)}: {a!r}")


def _sanitize(target: str) -> str:
    return target.replace(".", "_")


# ---------------------------------------------------------------------------
# Leaf conversion: torch module -> (kind, cfg, params, stats)
# ---------------------------------------------------------------------------


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


def _kernel(w: torch.Tensor) -> torch.Tensor:
    """A ``Linear`` weight ``[out, in]`` as JAX's kernel ``[in, out]``: the
    transposed view of a copy of torch's storage."""
    return _copy(w).t()


def _mha_leaf_params(mha, prefix: str) -> dict:
    if not mha._qkv_same_embed_dim:
        raise UnsupportedTorchModule(
            "MultiheadAttention with kdim/vdim != embed_dim")
    if mha.bias_k is not None or mha.add_zero_attn:
        raise UnsupportedTorchModule("MHA bias_k / add_zero_attn")
    p = {prefix + "in_w": _copy(mha.in_proj_weight),     # [3d, d]
         prefix + "out_w": _copy(mha.out_proj.weight)}   # [d, d]
    if mha.in_proj_bias is not None:
        p[prefix + "in_b"] = _copy(mha.in_proj_bias)
    if mha.out_proj.bias is not None:
        p[prefix + "out_b"] = _copy(mha.out_proj.bias)
    return p


def _act_name(fn) -> str:
    name = getattr(fn, "__name__", str(fn))
    if "gelu" in name:
        return "gelu"
    if "relu" in name:
        return "relu"
    raise UnsupportedTorchModule(f"transformer activation {name!r}")


def _tel_params_cfg(layer, prefix: str = "", cross: bool = False):
    """TransformerEncoder/DecoderLayer -> (params, cfg).  Norms are
    numbered in torch's order: norm1 (self-attention), [norm2
    cross-attention,] the last the feed-forward's."""
    p = {}
    p.update(_mha_leaf_params(layer.self_attn, prefix + "sa."))
    if cross:
        p.update(_mha_leaf_params(layer.multihead_attn, prefix + "ca."))
    for lin, name in ((layer.linear1, "lin1."), (layer.linear2, "lin2.")):
        p[prefix + name + "kernel"] = _kernel(lin.weight)
        if lin.bias is not None:
            p[prefix + name + "bias"] = _copy(lin.bias)
    for n in ("norm1", "norm2") + (("norm3",) if cross else ()):
        ln = getattr(layer, n)
        if ln.weight is None or ln.bias is None:
            raise UnsupportedTorchModule(
                "transformer layer norm without affine weight+bias "
                "(bias=False / elementwise_affine=False)")
        p[prefix + n + ".scale"] = _copy(ln.weight)
        p[prefix + n + ".bias"] = _copy(ln.bias)
    cfg = {"heads": int(layer.self_attn.num_heads),
           "batch_first": bool(layer.self_attn.batch_first),
           "norm_first": bool(layer.norm_first),
           "act": _act_name(layer.activation),
           "rate": float(layer.dropout1.p),
           "attn_rate": float(layer.self_attn.dropout),
           "eps": float(layer.norm1.eps)}
    return p, cfg


def _tstack_params_cfg(layers, final_norm, prefix: str, cross: bool = False):
    p, cfg = {}, None
    for i, layer in enumerate(layers):
        pi, cfg_i = _tel_params_cfg(layer, prefix=f"{prefix}l{i}.",
                                    cross=cross)
        p.update(pi)
        if cfg is not None and cfg_i != cfg:
            raise UnsupportedTorchModule(
                "transformer stack with heterogeneous layer configs")
        cfg = cfg_i
    if final_norm is not None:
        if getattr(final_norm, "weight", None) is None or \
                getattr(final_norm, "bias", None) is None:
            raise UnsupportedTorchModule(
                "transformer stack final norm without affine weight+bias")
        p[prefix + "norm.scale"] = _copy(final_norm.weight)
        p[prefix + "norm.bias"] = _copy(final_norm.bias)
    return p, dict(cfg)


def _affine(mod, what: str) -> dict:
    """A norm's ``scale`` and ``bias``, both or neither."""
    if mod.weight is None:
        return {}
    if mod.bias is None:
        raise UnsupportedTorchModule(f"{what} with a weight and no bias")
    return {"scale": _copy(mod.weight), "bias": _copy(mod.bias)}


def _convert_leaf(mod) -> tuple[str, dict, dict, dict]:
    if isinstance(mod, nn.Linear):
        p = {"kernel": _kernel(mod.weight)}
        if mod.bias is not None:
            p["bias"] = _copy(mod.bias)
        return "linear", {}, p, {}
    if isinstance(mod, nn.Conv2d):
        if _pair(mod.output_padding) != (0, 0):
            raise UnsupportedTorchModule("Conv2d output_padding")
        if mod.padding_mode != "zeros":
            raise UnsupportedTorchModule(
                f"Conv2d padding_mode={mod.padding_mode!r}")
        if isinstance(mod.padding, str):
            raise UnsupportedTorchModule(f"Conv2d padding={mod.padding!r}")
        p = {"kernel": _copy(mod.weight)}  # OIHW, as torch executes
        if mod.bias is not None:
            p["bias"] = _copy(mod.bias)
        cfg = {"stride": _pair(mod.stride), "padding": _pair(mod.padding),
               "dilation": _pair(mod.dilation), "groups": int(mod.groups)}
        return "conv2d", cfg, p, {}
    if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
        if not mod.track_running_stats:
            raise UnsupportedTorchModule("BatchNorm without running stats")
        if mod.momentum is None:
            # a cumulative moving average needs a step counter
            raise UnsupportedTorchModule("BatchNorm momentum=None (CMA)")
        p = _affine(mod, "BatchNorm") if mod.affine else {}
        stats = {"mean": _copy(mod.running_mean),
                 "var": _copy(mod.running_var)}
        cfg = {"eps": float(mod.eps), "momentum": float(mod.momentum),
               "affine": bool(mod.affine)}
        return "batchnorm", cfg, p, stats
    if isinstance(mod, nn.LayerNorm):
        p = _affine(mod, "LayerNorm") if mod.elementwise_affine else {}
        cfg = {"eps": float(mod.eps), "ndim": len(mod.normalized_shape),
               "affine": bool(mod.elementwise_affine)}
        return "layernorm", cfg, p, {}
    if isinstance(mod, nn.Embedding):
        return "embedding", {}, {"embedding": _copy(mod.weight)}, {}
    if isinstance(mod, nn.Dropout):
        return "dropout", {"rate": float(mod.p)}, {}, {}
    if isinstance(mod, nn.Flatten):
        return "flatten", {"start": int(mod.start_dim),
                           "end": int(mod.end_dim)}, {}, {}
    if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
        if getattr(mod, "ceil_mode", False):
            raise UnsupportedTorchModule("pool ceil_mode")
        kind = "maxpool2d" if isinstance(mod, nn.MaxPool2d) else "avgpool2d"
        if kind == "maxpool2d" and _pair(mod.dilation) != (1, 1):
            raise UnsupportedTorchModule("MaxPool2d dilation")
        if kind == "avgpool2d" and (
                not mod.count_include_pad or mod.divisor_override is not None):
            raise UnsupportedTorchModule(
                "AvgPool2d count_include_pad=False / divisor_override")
        stride = mod.stride if mod.stride is not None else mod.kernel_size
        return kind, {"kernel": _pair(mod.kernel_size),
                      "stride": _pair(stride),
                      "padding": _pair(mod.padding)}, {}, {}
    if isinstance(mod, nn.AdaptiveAvgPool2d):
        return "adaptiveavgpool2d", {"out": _pair(mod.output_size)}, {}, {}
    if isinstance(mod, nn.GroupNorm):
        p = _affine(mod, "GroupNorm") if mod.affine else {}
        return "groupnorm", {"groups": int(mod.num_groups),
                             "eps": float(mod.eps),
                             "affine": bool(mod.affine)}, p, {}
    if isinstance(mod, nn.MultiheadAttention):
        return "mha", {"heads": int(mod.num_heads),
                       "batch_first": bool(mod.batch_first),
                       "rate": float(mod.dropout)}, \
            _mha_leaf_params(mod, ""), {}
    if isinstance(mod, nn.TransformerEncoderLayer):
        p, cfg = _tel_params_cfg(mod)
        return "tel", cfg, p, {}
    if isinstance(mod, nn.TransformerDecoderLayer):
        p, cfg = _tel_params_cfg(mod, cross=True)
        return "tdl", cfg, p, {}
    if isinstance(mod, nn.TransformerEncoder):
        p, cfg = _tstack_params_cfg(mod.layers, mod.norm, "")
        cfg.update(kind="encoder", n_layers=len(mod.layers))
        return "tstack", cfg, p, {}
    if isinstance(mod, nn.TransformerDecoder):
        p, cfg = _tstack_params_cfg(mod.layers, mod.norm, "", cross=True)
        cfg.update(kind="decoder", n_layers=len(mod.layers))
        return "tstack", cfg, p, {}
    if isinstance(mod, nn.Transformer):
        p, cfg = _tstack_params_cfg(mod.encoder.layers, mod.encoder.norm,
                                    "enc.")
        pd, cfg_d = _tstack_params_cfg(mod.decoder.layers, mod.decoder.norm,
                                       "dec.", cross=True)
        if cfg_d != cfg:
            # one cfg runs both stacks: a mixed pair would mistranslate
            raise UnsupportedTorchModule(
                "nn.Transformer with differing encoder/decoder layer "
                f"configs: {cfg} vs {cfg_d}")
        p.update(pd)
        cfg.update(kind="transformer", enc_layers=len(mod.encoder.layers),
                   dec_layers=len(mod.decoder.layers))
        return "tstack", cfg, p, {}
    if isinstance(mod, nn.Identity):
        return "identity", {}, {}, {}
    acts = {nn.ReLU: "relu", nn.GELU: "gelu", nn.SiLU: "silu",
            nn.Tanh: "tanh", nn.Sigmoid: "sigmoid",
            nn.LeakyReLU: "leaky_relu", nn.Softmax: "softmax"}
    for cls, kind in acts.items():
        if isinstance(mod, cls):
            cfg = {}
            if kind == "gelu":
                cfg = {"approximate": getattr(mod, "approximate", "none")}
            if kind == "leaky_relu":
                cfg = {"slope": float(mod.negative_slope)}
            if kind == "softmax":
                cfg = {"dim": int(mod.dim if mod.dim is not None else -1)}
            return kind, cfg, {}, {}
    raise UnsupportedTorchModule(
        f"no converter for torch module {type(mod).__name__}; supported: "
        "Linear Conv2d BatchNorm1d/2d LayerNorm GroupNorm Embedding "
        "MultiheadAttention Dropout Flatten MaxPool2d AvgPool2d "
        "AdaptiveAvgPool2d Identity and common activations")


def _leaf_types():
    """Module types converted as leaves; every other module (containers,
    user modules, the other torch.nn composites) is traced through."""
    return (
        nn.Linear, nn.Conv2d, nn.BatchNorm1d, nn.BatchNorm2d,
        nn.LayerNorm, nn.GroupNorm, nn.Embedding,
        nn.MultiheadAttention, nn.TransformerEncoderLayer,
        nn.TransformerDecoderLayer, nn.TransformerEncoder,
        nn.TransformerDecoder, nn.Transformer,
        nn.Dropout, nn.Flatten, nn.MaxPool2d,
        nn.AvgPool2d, nn.AdaptiveAvgPool2d, nn.Identity, nn.ReLU,
        nn.GELU, nn.SiLU, nn.Tanh, nn.Sigmoid, nn.LeakyReLU,
        nn.Softmax,
    )


# ---------------------------------------------------------------------------
# Function and method tables: the JAX bridge's, executed as torch
# ---------------------------------------------------------------------------


def _t_f_dropout(x, p=0.5, training=False, inplace=False):
    if training:
        raise UnsupportedTorchModule(
            "F.dropout traced with training=True — use nn.Dropout (the "
            "module form maps to the bridge's generator-driven dropout)")
    return x


def _t_adaptive_avg_pool2d(x, output_size):
    oh, ow = _pair(output_size)
    h, w = x.shape[-2], x.shape[-1]
    if (oh, ow) != (1, 1) and (h % oh or w % ow):
        raise UnsupportedTorchModule(
            f"adaptive_avg_pool2d {h}x{w} -> {oh}x{ow} (non-divisible)")
    return F.adaptive_avg_pool2d(x, (oh, ow))


def _fn_id(f) -> str:
    return f"{getattr(f, '__module__', '?')}.{getattr(f, '__name__', f)}"


def _function_table() -> dict[str, Any]:
    """The JAX bridge's function table by id, each entry torch's own
    function (or one that refuses what JAX refuses at run time)."""
    same = (
        operator.add, operator.sub, operator.mul, operator.truediv,
        operator.floordiv, operator.neg, operator.pow, operator.matmul,
        operator.getitem, operator.eq, operator.ne, operator.lt, operator.gt,
        torch.add, torch.sub, torch.mul, torch.matmul, torch.bmm, torch.cat,
        torch.stack, torch.flatten, torch.transpose, torch.permute,
        torch.reshape, torch.relu, torch.tanh, torch.sigmoid, torch.exp,
        torch.log, torch.sqrt, torch.rsqrt, torch.mean, torch.sum,
        torch.softmax, torch.tril, torch.triu, torch.ones, torch.zeros,
        torch.arange, torch.full, torch.logical_and, torch.logical_or,
        torch.logical_not, torch.unsqueeze, torch.squeeze, F.relu, F.gelu,
        F.silu, F.tanh, F.sigmoid, F.leaky_relu, F.softmax, F.log_softmax,
        F.max_pool2d, F.avg_pool2d, math.sqrt)
    table = {_fn_id(f): f for f in same}
    table[_fn_id(F.adaptive_avg_pool2d)] = _t_adaptive_avg_pool2d
    # traced in eval mode, so functional dropout is the identity; a
    # training=True literal would silently drop it: refused
    table[_fn_id(F.dropout)] = _t_f_dropout
    return table


_FUNCTIONS = _function_table()


def _t_expand(x, *s):
    sizes = s[0] if len(s) == 1 and isinstance(s[0], (tuple, list)) else s
    if len(sizes) != x.ndim:
        raise UnsupportedTorchModule(".expand() that changes rank")
    return x.expand(*sizes)


# the JAX bridge's tensor methods: each runs as torch's own method
_METHODS = frozenset((
    "view", "reshape", "flatten", "permute", "transpose", "contiguous",
    "size", "dim", "mean", "sum", "unsqueeze", "squeeze", "masked_fill",
    "float", "softmax", "tril", "relu", "tanh", "sigmoid", "add", "mul",
    "matmul", "bmm", "eq", "pow", "chunk", "expand", "type_as", "to"))


def _call_method(name: str, x, *args, **kwargs):
    if name == "expand":
        return _t_expand(x, *args)
    return getattr(x, name)(*args, **kwargs)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


class _Scope(nn.Module):
    """A container on a dotted parameter path (``tf//enc`` -> ``l0`` ->
    ``sa``), so the full name is the JAX key."""


def _owner(root: nn.Module, name: str) -> tuple[nn.Module, str]:
    """The module holding ``name``'s last part, made where missing."""
    *path, leaf = name.split(".")
    mod = root
    for part in path:
        if part not in mod._modules:
            mod.add_module(part, _Scope())
        mod = mod._modules[part]
    return mod, leaf


def _dropout(x: torch.Tensor, rate: float, train: bool,
             generator: torch.Generator | None) -> torch.Tensor:
    """The shared backbone's dropout (``transformer_core._dropout``) under
    ``train``, seeded with one draw of ``generator`` (none: no
    dropout)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return seeded_dropout(x, rate, seed)


class TorchBridge(nn.Module):
    """Re-executes a converted torch fx graph (:func:`from_torch`).
    ``spec`` is the graph; ``layout`` names each tensor the bridge holds:
    ``(name, shape, kind)`` with kind ``"param"``, ``"kernel"`` (a
    ``Linear`` kernel ``[in, out]`` held as a transposed view) or
    ``"buffer:<dtype>"``.  ``forward(*inputs, train=False,
    mutable=False, generator=None)``: the module docstring."""

    # forward takes train= and mutable=, and the step threads the buffers
    stateful = True
    # under ``tp`` (``executor._apply_tp``): the packed [q; k; v]
    # projections split each third alike, and the group the split leaves
    # are sharded over, which the forward reduces partial outputs across
    tp_packed = {r"(sa|ca)\.in_[wb]$": 3}
    tensor_group = None

    def __init__(self, spec: GraphSpec, layout: tuple):
        super().__init__()
        self.spec, self.layout = spec, layout
        for name, shape, kind in layout:
            mod, leaf = _owner(self, name)
            if kind.startswith("buffer:"):
                dtype = getattr(torch, kind.split(":", 1)[1])
                mod.register_buffer(leaf, torch.empty(shape, dtype=dtype))
            elif kind == "kernel":
                mod.register_parameter(leaf, nn.Parameter(
                    torch.empty(shape[::-1]).t()))
            else:
                mod.register_parameter(leaf, nn.Parameter(torch.empty(shape)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None
                     ) -> "TorchBridge":
        """JAX's standalone ``TorchBridge.init``: zero parameters and
        buffers, unit running variances (the converted weights come from
        :func:`from_torch`, not from here)."""
        for p in self.parameters():
            p.zero_()
        for name, b in self.named_buffers():
            b.fill_(1 if name.endswith("//var") else 0)
        return self

    def _get(self, name: str) -> torch.Tensor:
        """A held tensor by its dotted name, through attribute access (so
        ``torch.func.functional_call``'s substitutes are seen)."""
        obj = self
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    def forward(self, *inputs, train: bool = False, mutable: bool = False,
                generator: torch.Generator | None = None):
        env: dict[str, Any] = {}
        out, n_in = None, 0
        updates = {} if train and mutable else None
        for node in self.spec.nodes:
            if node.kind == "placeholder":
                if n_in < len(inputs):
                    env[node.name] = inputs[n_in]
                elif node.args:  # an omitted argument with a default
                    env[node.name] = _thaw(node.args[0], env)
                else:
                    raise TypeError(
                        f"missing input for placeholder {node.name!r}")
                n_in += 1
            elif node.kind == "output":
                out = _thaw(node.args[0], env)
            elif node.kind == "get_attr":
                env[node.name] = self._get(node.target)
            elif node.kind == "call_module":
                largs = tuple(_thaw(a, env) for a in node.args)
                lkwargs = {k: _thaw(v, env) for k, v in node.kwargs}
                env[node.name] = self._apply_layer(
                    node, largs, lkwargs, train, updates, generator)
            elif node.kind == "call_function":
                args = _thaw(("tuple", node.args), env)
                kwargs = {k: _thaw(v, env) for k, v in node.kwargs}
                env[node.name] = _FUNCTIONS[node.target](*args, **kwargs)
            elif node.kind == "call_method":
                args = _thaw(("tuple", node.args), env)
                kwargs = {k: _thaw(v, env) for k, v in node.kwargs}
                env[node.name] = _call_method(node.target, *args, **kwargs)
            else:
                raise UnsupportedTorchModule(f"node kind {node.kind}")
        return out if updates is None else (out, updates)

    def _p(self, scope: str, name: str):
        """A leaf's tensor (this rank's shard of one split over
        ``tensor``), or None where it has none."""
        key = f"{scope}//{name}"
        try:
            t = self._get(key)
        except AttributeError:
            return None
        return t.to_local() if is_dtensor(t) else t

    def _split(self, scope: str, name: str):
        """The ``tensor`` group when the leaf is split over it, else
        None."""
        t = self._get(f"{scope}//{name}")
        if is_dtensor(t) and t.to_local().shape != t.shape:
            return self.tensor_group
        return None

    def _apply_layer(self, node, largs, lkwargs, train, updates, generator):
        kind, cfg, scope = node.target, dict(node.cfg), node.scope
        x = largs[0] if largs else None

        def p(name):
            return self._p(scope, name)

        if kind == "mha":
            return self._apply_mha(scope, cfg, largs, lkwargs, train,
                                   generator)
        if kind in ("tel", "tdl"):
            return self._apply_tel_leaf(kind, scope, cfg, largs, lkwargs,
                                        train, generator)
        if kind == "tstack":
            return self._apply_tstack(scope, cfg, largs, lkwargs, train,
                                      generator)
        if kind == "linear":
            return F.linear(x, p("kernel").t(), p("bias"))
        if kind == "conv2d":
            return F.conv2d(x, p("kernel"), p("bias"), cfg["stride"],
                            cfg["padding"], cfg["dilation"], cfg["groups"])
        if kind == "batchnorm":
            return self._batchnorm(scope, cfg, x, train, updates)
        if kind == "layernorm":
            return F.layer_norm(x, x.shape[x.ndim - cfg["ndim"]:],
                                p("scale"), p("bias"), cfg["eps"])
        if kind == "groupnorm":
            return F.group_norm(x, cfg["groups"], p("scale"), p("bias"),
                                cfg["eps"])
        if kind == "embedding":
            return p("embedding")[x]
        if kind == "dropout":
            return _dropout(x, cfg["rate"], train, generator)
        if kind == "flatten":
            return torch.flatten(x, cfg["start"], cfg["end"])
        if kind == "maxpool2d":
            return F.max_pool2d(x, cfg["kernel"], cfg["stride"],
                                cfg["padding"])
        if kind == "avgpool2d":
            return F.avg_pool2d(x, cfg["kernel"], cfg["stride"],
                                cfg["padding"])
        if kind == "adaptiveavgpool2d":
            return _t_adaptive_avg_pool2d(x, cfg["out"])
        if kind == "identity":
            return x
        if kind == "gelu":
            return F.gelu(x, approximate=cfg.get("approximate", "none"))
        if kind == "leaky_relu":
            return F.leaky_relu(x, cfg["slope"])
        if kind == "softmax":
            return F.softmax(x, cfg["dim"])
        simple = {"relu": F.relu, "silu": F.silu, "tanh": torch.tanh,
                  "sigmoid": torch.sigmoid}
        if kind in simple:
            return simple[kind](x)
        raise UnsupportedTorchModule(f"layer kind {kind}")

    def _batchnorm(self, scope, cfg, x, train, updates):
        """torch's BatchNorm: the batch statistics under ``train`` (the new
        running ones, torch's momentum blend of the unbiased variance,
        into ``updates`` when collected), else the running ones."""
        mean_name, var_name = f"{scope}//mean", f"{scope}//var"
        run_mean, run_var = self._get(mean_name), self._get(var_name)
        scale, bias = self._p(scope, "scale"), self._p(scope, "bias")
        if not train:
            return F.batch_norm(x, run_mean, run_var, scale, bias, False,
                                0.0, cfg["eps"])
        if updates is not None:
            with torch.no_grad():
                axes = tuple(i for i in range(x.ndim) if i != 1)
                mean = x.mean(axes)
                var = x.var(axes, unbiased=False)
                n = x.numel() / mean.numel()
                m = cfg["momentum"]
                updates[mean_name] = (1 - m) * run_mean + m * mean
                updates[var_name] = (1 - m) * run_var + m * var * (
                    n / max(n - 1, 1))
        return F.batch_norm(x, None, None, scale, bias, True, 0.0, cfg["eps"])

    def _apply_mha(self, scope, cfg, largs, lkwargs, train, generator):
        """nn.MultiheadAttention, torch's semantics: packed in_proj, bool
        masks True = NOT allowed (key_padding_mask True = ignore), float
        masks additive; returns ``(output, attention weights or None)``."""
        q, k, v = largs[0], largs[1], largs[2]

        def arg(i, key, default=None):
            # torch's positional order: (query, key, value,
            # key_padding_mask, need_weights, attn_mask,
            # average_attn_weights, is_causal)
            if key in lkwargs:
                return lkwargs[key]
            return largs[i] if len(largs) > i else default

        key_padding_mask = arg(3, "key_padding_mask")
        need_weights = arg(4, "need_weights", True)
        attn_mask = arg(5, "attn_mask")
        average_attn_weights = arg(6, "average_attn_weights", True)
        is_causal = arg(7, "is_causal", False)
        if not cfg["batch_first"]:  # torch's default layout [T, B, d]
            q, k, v = (t.transpose(0, 1) for t in (q, k, v))
        out, w = self._mha_core(scope, "", cfg, q, k, v, attn_mask=attn_mask,
                                key_padding_mask=key_padding_mask,
                                is_causal=is_causal, train=train,
                                generator=generator)
        if not cfg["batch_first"]:
            out = out.transpose(0, 1)
        if need_weights:
            return (out, w.mean(1) if average_attn_weights else w)
        return (out, None)

    def _mha_core(self, scope, prefix, cfg, q, k, v, *, attn_mask,
                  key_padding_mask, is_causal, train, generator):
        """Batch-first multi-head attention shared by the MHA leaf and the
        nn.Transformer executors, plain torch (JAX ``_mha_core``);
        ``{prefix}in_w`` etc. under ``scope``.  Returns ``(out [B, Tq, d],
        probs [B, H, Tq, Tk])``: the probabilities before dropout, which
        torch returns as the weights while the dropped ones multiply V.
        Split over ``tensor``, this rank's heads: ``in_w`` holds its rows
        of each third, ``out_w`` the matching input columns, and the
        partial outputs are summed over the group before ``out_b``."""
        d = q.shape[-1]
        hd = d // cfg["heads"]
        in_w = self._p(scope, prefix + "in_w")  # [3d, d], torch layout
        in_b = self._p(scope, prefix + "in_b")
        group = self._split(scope, prefix + "in_w")
        if group is not None:
            from ..parallel.expert import _CopyToGroup

            copies = {}
            for t in (q, k, v):  # self-attention passes one tensor thrice
                if id(t) not in copies:
                    copies[id(t)] = _CopyToGroup.apply(t, group)
            q, k, v = copies[id(q)], copies[id(k)], copies[id(v)]
        dl = in_w.shape[0] // 3  # this rank's width of each third
        H = dl // hd

        def proj(x, lo):
            return F.linear(x, in_w[lo:lo + dl],
                            None if in_b is None else in_b[lo:lo + dl])

        qp, kp, vp = proj(q, 0), proj(k, dl), proj(v, 2 * dl)
        B, Tq, Tk = qp.shape[0], qp.shape[1], kp.shape[1]
        qh = qp.reshape(B, Tq, H, hd).transpose(1, 2)
        kh = kp.reshape(B, Tk, H, hd).transpose(1, 2)
        vh = vp.reshape(B, Tk, H, hd).transpose(1, 2)
        scores = (qh @ kh.transpose(-2, -1)) / math.sqrt(hd)
        neg = torch.finfo(scores.dtype).min * 0.5
        if is_causal:
            causal = torch.ones((Tq, Tk), dtype=torch.bool,
                                device=scores.device).tril(Tk - Tq)
            scores = scores.masked_fill(~causal, neg)
        if attn_mask is not None:
            m = attn_mask
            m = m.reshape(B, H, Tq, Tk) if m.ndim == 3 else m[None, None]
            if m.dtype == torch.bool:
                scores = scores.masked_fill(m, neg)  # True = NOT allowed
            else:
                scores = scores + m.to(scores.dtype)
        if key_padding_mask is not None:  # [B, Tk] True = ignore
            scores = scores.masked_fill(
                key_padding_mask.to(torch.bool)[:, None, None, :], neg)
        probs = torch.softmax(scores, dim=-1)
        dropped = _dropout(probs, cfg.get("attn_rate", cfg["rate"]), train,
                           generator)
        out = (dropped @ vh).transpose(1, 2).reshape(B, Tq, dl)
        out_w, out_b = (self._p(scope, prefix + "out_w"),
                        self._p(scope, prefix + "out_b"))
        if group is None:
            return F.linear(out, out_w, out_b), probs
        from ..parallel.expert import _SumOverGroup

        out = _SumOverGroup.apply(F.linear(out, out_w), group)
        return (out if out_b is None else out + out_b), probs

    def _lin(self, scope, prefix, x):
        return F.linear(x, self._p(scope, prefix + "kernel").t(),
                        self._p(scope, prefix + "bias"))

    def _ln(self, scope, prefix, x, eps):
        return F.layer_norm(x, x.shape[-1:], self._p(scope, prefix + "scale"),
                            self._p(scope, prefix + "bias"), eps)

    def _apply_tel(self, scope, cfg, x, train, generator, *, prefix="",
                   attn_mask=None, key_padding_mask=None, memory=None,
                   memory_mask=None, memory_key_padding_mask=None):
        """One TransformerEncoderLayer (with ``memory``, a
        TransformerDecoderLayer): torch's post- or pre-norm residual
        wiring around :meth:`_mha_core` and the feed-forward."""
        eps, rate = cfg["eps"], cfg["rate"]
        act = F.gelu if cfg["act"] == "gelu" else F.relu

        def drop(h):
            return _dropout(h, rate, train, generator)

        def sa(h):
            out, _ = self._mha_core(
                scope, prefix + "sa.", cfg, h, h, h, attn_mask=attn_mask,
                key_padding_mask=key_padding_mask, is_causal=False,
                train=train, generator=generator)
            return drop(out)

        def ca(h):
            out, _ = self._mha_core(
                scope, prefix + "ca.", cfg, h, memory, memory,
                attn_mask=memory_mask,
                key_padding_mask=memory_key_padding_mask, is_causal=False,
                train=train, generator=generator)
            return drop(out)

        def ff(h):
            group = self._split(scope, prefix + "lin1.kernel")
            if group is None:
                h = drop(act(self._lin(scope, prefix + "lin1.", h)))
                return drop(self._lin(scope, prefix + "lin2.", h))
            # split over tensor: lin1's output columns, lin2's input rows
            from ..parallel.expert import _CopyToGroup, _SumOverGroup

            h = drop(act(self._lin(scope, prefix + "lin1.",
                                   _CopyToGroup.apply(h, group))))
            h = _SumOverGroup.apply(F.linear(
                h, self._p(scope, prefix + "lin2.kernel").t()), group)
            bias = self._p(scope, prefix + "lin2.bias")
            return drop(h if bias is None else h + bias)

        def norm(n, h):
            return self._ln(scope, f"{prefix}norm{n}.", h, eps)

        n = 1
        if cfg["norm_first"]:
            x = x + sa(norm(n, x))
            n += 1
            if memory is not None:
                x = x + ca(norm(n, x))
                n += 1
            x = x + ff(norm(n, x))
        else:
            x = norm(n, x + sa(x))
            n += 1
            if memory is not None:
                x = norm(n, x + ca(x))
                n += 1
            x = norm(n, x + ff(x))
        return x

    def _apply_tel_leaf(self, kind, scope, cfg, largs, lkwargs, train,
                        generator):
        """A TransformerEncoderLayer / DecoderLayer called on its own."""

        def arg(i, *keys):
            for key in keys:
                if key in lkwargs:
                    return lkwargs[key]
            return largs[i] if len(largs) > i else None

        bf, x = cfg["batch_first"], largs[0]
        if kind == "tel":
            mem, mm, mkpm = None, None, None
            mask, kpm = arg(1, "src_mask"), arg(2, "src_key_padding_mask")
        else:
            mem, mask = arg(1, "memory"), arg(2, "tgt_mask")
            mm, kpm = arg(3, "memory_mask"), arg(4, "tgt_key_padding_mask")
            mkpm = arg(5, "memory_key_padding_mask")
        if not bf:
            x = x.transpose(0, 1)
            mem = None if mem is None else mem.transpose(0, 1)
        y = self._apply_tel(scope, cfg, x, train, generator, attn_mask=mask,
                            key_padding_mask=kpm, memory=mem,
                            memory_mask=mm, memory_key_padding_mask=mkpm)
        return y if bf else y.transpose(0, 1)

    def _apply_tstack(self, scope, cfg, largs, lkwargs, train, generator):
        """TransformerEncoder / TransformerDecoder / nn.Transformer run
        from their converted per-layer parameters."""
        kind, bf, eps = cfg["kind"], cfg["batch_first"], cfg["eps"]

        def get(i, *ks):
            for k in ks:
                if k in lkwargs:
                    return lkwargs[k]
            return largs[i] if len(largs) > i else None

        def has(prefix):
            return self._p(scope, prefix + "norm.scale") is not None

        def run(x, prefix, n_layers, **kw):
            for i in range(n_layers):
                x = self._apply_tel(scope, cfg, x, train, generator,
                                    prefix=f"{prefix}l{i}.", **kw)
            if has(prefix):
                x = self._ln(scope, prefix + "norm.", x, eps)
            return x

        def bt(t):
            return t if bf else t.transpose(0, 1)

        if kind == "transformer":
            src, tgt = bt(largs[0]), bt(largs[1])
            mem = run(src, "enc.", cfg["enc_layers"],
                      attn_mask=get(2, "src_mask"),
                      key_padding_mask=get(5, "src_key_padding_mask"))
            return bt(run(tgt, "dec.", cfg["dec_layers"],
                          attn_mask=get(3, "tgt_mask"),
                          key_padding_mask=get(6, "tgt_key_padding_mask"),
                          memory=mem, memory_mask=get(4, "memory_mask"),
                          memory_key_padding_mask=get(
                              7, "memory_key_padding_mask")))
        if kind == "encoder":
            return bt(run(bt(largs[0]), "", cfg["n_layers"],
                          attn_mask=get(1, "mask", "src_mask"),
                          key_padding_mask=get(2, "src_key_padding_mask")))
        return bt(run(bt(largs[0]), "", cfg["n_layers"],
                      attn_mask=get(2, "tgt_mask"),
                      key_padding_mask=get(4, "tgt_key_padding_mask"),
                      memory=bt(largs[1]), memory_mask=get(3, "memory_mask"),
                      memory_key_padding_mask=get(
                          5, "memory_key_padding_mask")))


# ---------------------------------------------------------------------------
# from_torch
# ---------------------------------------------------------------------------


class _Tracer(torch.fx.Tracer):
    # proxy buffer and parameter attribute access, so that
    # self.mask[:t, :t] traces to get_attr + getitem instead of slicing
    # a concrete tensor with a Proxy (a TypeError)
    proxy_buffer_attributes = True

    def is_leaf_module(self, m, qualname):
        # a leaf iff it has a converter: the torch.nn composites without
        # one trace through to their leaves, unlike fx's default, which
        # stops at every torch.nn module
        return isinstance(m, _leaf_types())


def from_torch(module: nn.Module) -> tuple[TorchBridge, dict]:
    """Trace a torch ``nn.Module`` and convert it: ``(TorchBridge, its
    tensors by name)``, the bridge holding copies of the module's weights
    on the module's device and ready for ``AutoDistribute``.

    >>> net = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.ReLU())
    >>> model, params = from_torch(net)
    >>> model(x)                                    # == net(x)
    >>> ad = AutoDistribute(model, loss_fn=softmax_xent_loss_mutable,
    ...                     init_fn=lambda m, g: m.load_state_dict(params))
    """
    was_training = module.training
    module.eval()  # functional dropout etc. trace with training=False
    try:
        graph = _Tracer().trace(module)
        traced = torch.fx.GraphModule(module, graph)
    except Exception as e:  # torch raises plain Exceptions from tracing
        raise UnsupportedTorchModule(
            f"torch.fx cannot trace this module ({e}); models with "
            "data-dependent Python control flow need a hand port") from e
    finally:
        module.train(was_training)

    modules = dict(traced.named_modules())
    nodes = []
    params: dict[str, torch.Tensor] = {}
    buffers: dict[str, torch.Tensor] = {}
    n_inputs = 0
    for node in traced.graph.nodes:
        args = tuple(_tag_arg(a) for a in node.args)
        kwargs = tuple((k, _tag_arg(v)) for k, v in node.kwargs.items())
        if node.op == "placeholder":
            n_inputs += 1
            # args carries fx's recorded default value (if any), so an
            # optional forward argument can be omitted
            nodes.append(NodeSpec(node.name, "placeholder", "", args, ()))
        elif node.op == "output":
            nodes.append(NodeSpec(node.name, "output", "", args, ()))
        elif node.op == "get_attr":
            t = traced
            for part in node.target.split("."):
                t = getattr(t, part)
            scope = _sanitize(node.target)
            if isinstance(t, nn.Parameter) and t.requires_grad:
                name = f"{scope}//value"
                params[name] = _copy(t)
            else:
                name = scope
                buffers[name] = _copy(t)
            nodes.append(NodeSpec(node.name, "get_attr", name, (), ()))
        elif node.op == "call_module":
            kind, cfg, p, st = _convert_leaf(modules[node.target])
            scope = _sanitize(node.target)
            params.update({f"{scope}//{n}": t for n, t in p.items()})
            buffers.update({f"{scope}//{n}": t for n, t in st.items()})
            nodes.append(NodeSpec(node.name, "call_module", kind, args,
                                  kwargs, tuple(sorted(cfg.items())), scope))
        elif node.op == "call_function":
            fid = _fn_id(node.target)
            if fid not in _FUNCTIONS:
                raise UnsupportedTorchModule(
                    f"function {fid} at node {node.name}")
            nodes.append(NodeSpec(node.name, "call_function", fid, args,
                                  kwargs))
        elif node.op == "call_method":
            if node.target not in _METHODS:
                raise UnsupportedTorchModule(
                    f"tensor method .{node.target}() at node {node.name}")
            nodes.append(NodeSpec(node.name, "call_method", node.target,
                                  args, kwargs))
        else:
            raise UnsupportedTorchModule(f"fx op {node.op}")

    def kind_of(name: str, t: torch.Tensor) -> str:
        return "kernel" if t.dim() == 2 and name.endswith("kernel") else "param"

    layout = tuple(
        [(n, tuple(t.shape), kind_of(n, t)) for n, t in params.items()]
        + [(n, tuple(t.shape), f"buffer:{str(t.dtype).split('.')[-1]}")
           for n, t in buffers.items()])
    device = next((t.device for t in (*params.values(), *buffers.values())),
                  torch.device("cpu"))
    with torch.device(device):
        bridge = TorchBridge(GraphSpec(nodes=tuple(nodes), n_inputs=n_inputs),
                             layout)
    bridge.load_state_dict({**params, **buffers}, strict=True)
    return bridge, {**dict(bridge.named_parameters()),
                    **dict(bridge.named_buffers())}
