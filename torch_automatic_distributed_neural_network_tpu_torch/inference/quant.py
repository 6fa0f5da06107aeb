"""int8 storage: the decode weights and the paged KV pool.

The JAX package's ``inference/quant.py``.  A quantized leaf is a
``{"q": int8, "scale": fp32}`` pair: symmetric int8 with one fp32 scale
per channel the scheme reduces over, ``scale = max|x| / 127`` (floored
at 1e-8 / 127), ``q = clip(round(x / scale), -127, 127)``.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the same
fp32 inputs quantize to the same payloads.

- **Weights** (:func:`quantize_for_decode`): single-token decode streams
  every weight through the card for rank-1 work, so storing them as int8
  halves the bytes against bf16.  Each embedding scales per row (a row
  is both a lookup and a tied-head output channel), each kernel per
  output channel over its input dims (``training/lora.py``'s matrix-view
  table); norms and biases stay fp32.  In a module the pair is a
  :class:`QuantizedWeight` in the parameter's place, which gives its own
  dense form where the model uses it (``QuantizedWeight.dense`` /
  ``.rows``), as the JAX decode path dequantizes each layer's leaves
  inside its scan.
- **KV** (:func:`quantize_kv`): reduces over head_dim only (the last
  axis), so each token of each head requantizes independently when it is
  written into a paged block: freeing or reusing a block needs no scale
  bookkeeping.
- **LoRA factors** (:func:`quantize_lora_factor`): one scale per output
  channel of the factor, over its contraction axis.
"""

from __future__ import annotations

import copy
import itertools
import re

import torch
from torch import nn

from ..training.lora import KERNEL_MATRIX_VIEWS, input_dims
from ..utils.device import is_dtensor

# embeddings quantize per row; ``pos_embed`` is not an embedding table
# here, as it is not one in the JAX package's pattern
_EMBED_PAT = re.compile(r"^embed$")


class QuantizedWeight(nn.Module):
    """An int8 weight in a module: the payload ``q`` and its fp32
    ``scale`` (buffers, so they follow the module between devices), read
    as the ``{"q", "scale"}`` pair by ``x["q"]`` / ``x["scale"]``.  The
    model reads it through :meth:`dense` and :meth:`rows`
    (``models/transformer_core.py::dense_weight`` /
    ``embedding_lookup``), dequantized at use."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in ("q", "scale"):
            raise KeyError(key)
        return getattr(self, key)

    def dense(self, dtype) -> torch.Tensor:
        """The whole weight, dequantized to ``dtype``; a payload sharded
        as trained (:func:`quantize_sharded`) is gathered over every mesh
        axis but ``tensor`` first, as the plan's tensor-parallel wrappers
        compute with it."""
        if is_dtensor(self.q):
            return dequantize_leaf({"q": over_tensor(self.q),
                                    "scale": over_tensor(self.scale)}, dtype)
        return dequantize_leaf(self, dtype)

    def whole(self) -> "QuantizedWeight":
        """This weight with its payload and scale whole on this rank."""
        if not is_dtensor(self.q):
            return self
        from ..models.transformer_core import gathered

        return QuantizedWeight(gathered(self.q), gathered(self.scale))

    def rows(self, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """Rows ``tokens`` of a per-row quantized embedding: gather, then
        dequantize only the looked-up rows."""
        return (self.q[tokens].to(torch.float32)
                * self.scale[tokens]).to(dtype)


def is_quantized_leaf(x) -> bool:
    return isinstance(x, QuantizedWeight) or (
        isinstance(x, dict) and set(x) == {"q", "scale"})


def _quantize(leaf: torch.Tensor, reduce_dims: tuple[int, ...],
              groups=()) -> dict:
    """Symmetric int8 with per-channel scales over ``reduce_dims``; the
    channel maxima also taken over each process group of ``groups`` (the
    mesh dims that split a reduced dim of a sharded weight)."""
    w = leaf.to(torch.float32)
    amax = w.abs().amax(dim=reduce_dims, keepdim=True)
    for group in groups:
        torch.distributed.all_reduce(amax, torch.distributed.ReduceOp.MAX,
                                     group=group)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_leaf(x: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"q", "scale"} -> dense tensor in ``dtype``."""
    return (x["q"].to(torch.float32) * x["scale"]).to(dtype)


def _target_dims(name: str, shape) -> tuple[int, ...] | None:
    """The dims a weight named ``name`` scales over, or None when it
    stays in full precision."""
    if len(shape) < 2:
        return None
    if _EMBED_PAT.search(name):  # [V, d] -> scale [V, 1]
        return (len(shape) - 1,)
    for target in KERNEL_MATRIX_VIEWS:
        if re.search(target.pattern, name):
            return input_dims(shape, target)
    return None


def quantize_for_decode(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose embedding and kernels are int8
    (:class:`QuantizedWeight`, scales as above); norms, biases and the
    learned positions are copied in full precision.  Weights already
    quantized stay as they are.  ``model`` itself is not changed."""
    targets = {}
    for name, p in model.named_parameters():
        dims = _target_dims(name, p.shape)
        if dims is not None:
            targets[name] = (p, dims)
    # the copy shares every parameter it is about to replace, so the
    # full-precision weights are never held twice
    memo = {id(p): p for p, _ in targets.values()}
    out = copy.deepcopy(model, memo)
    with torch.no_grad():
        for name, (p, dims) in targets.items():
            leaf = _quantize(p.detach(), dims)
            put_quantized(out, name, leaf["q"], leaf["scale"])
    return out


def over_tensor(x):
    """A sharded ``DTensor`` laid out over the ``tensor`` mesh axis alone,
    as the tensor-parallel wrappers compute: its other mesh dims (fsdp,
    data) gathered; a plain tensor where the mesh has no tensor axis."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names
    keep = [pl if n == "tensor" else Replicate()
            for n, pl in zip(names, x.placements)]
    if keep != list(x.placements):
        x = x.redistribute(mesh, keep)
    if "tensor" not in names:
        return x.to_local()
    return DTensor.from_local(x.to_local(), mesh["tensor"],
                              [keep[names.index("tensor")]], run_check=False,
                              shape=x.shape, stride=x.stride())


def quantize_shard(x: torch.Tensor, dims: tuple[int, ...]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of ``x`` over ``dims``, as :func:`_quantize` gives
    them for the whole tensor, computed on this rank's shard of a
    ``DTensor``: the maxima taken over every mesh dim that splits one of
    ``dims`` (a row-split weight's input dim), both kept in ``x``'s
    layout (the scale replicated where the maxima were taken)."""
    if not is_dtensor(x):
        leaf = _quantize(x, dims)
        return leaf["q"], leaf["scale"]
    from torch.distributed.tensor import DTensor, Replicate

    mesh, groups, scale_pl = x.device_mesh, [], []
    for i, pl in enumerate(x.placements):
        if getattr(pl, "dim", None) in dims:
            groups.append(mesh.get_group(i))
            scale_pl.append(Replicate())
        else:
            scale_pl.append(pl)
    leaf = _quantize(x.to_local(), dims, groups)
    shape = torch.Size(1 if d in dims else n for d, n in enumerate(x.shape))
    return (DTensor.from_local(leaf["q"], mesh, x.placements,
                               run_check=False, shape=x.shape,
                               stride=x.stride()),
            DTensor.from_local(leaf["scale"], mesh, scale_pl,
                               run_check=False, shape=shape,
                               stride=torch.empty(shape, device="meta")
                               .stride()))


def quantize_sharded(model: nn.Module, source: dict, device) -> nn.Module:
    """Fill ``model`` for int8 decoding from a plan's shards, gathering no
    weight whole: ``model`` is an empty copy on the meta device laid out
    by the plan's tensor-parallel wrappers alone, ``source`` names each
    of its tensors (``DTensor``s sharded as trained, or plain ones).
    Each weight :func:`quantize_for_decode` quantizes becomes a
    :class:`QuantizedWeight` whose payload and scale keep their source's
    layout (:func:`quantize_shard`; gathered over the axes but tensor at
    use, as FSDP gathers a layer); every other tensor is copied in full
    precision, gathered over every axis but tensor."""
    from torch.distributed.tensor import distribute_tensor

    targets = {}
    for name, p in model.named_parameters():
        dims = _target_dims(name, p.shape)
        if dims is not None:
            targets[name] = dims
    empty = torch.empty(0, device="meta")
    for name in targets:  # no full-precision storage is made for these
        put_quantized(model, name, empty, empty)
    model.to_empty(device=device)
    with torch.no_grad():
        for name, dims in targets.items():
            qw = model.get_submodule(name)
            qw.q, qw.scale = quantize_shard(source[name], dims)
        for name, t in itertools.chain(model.named_parameters(),
                                       model.named_buffers()):
            if name.rpartition(".")[0] in targets:
                continue
            src = source[name]
            if is_dtensor(src):
                src = over_tensor(src)
            if is_dtensor(src) and not is_dtensor(t):
                src = src.to_local()  # replicated over tensor
            elif is_dtensor(t) and not is_dtensor(src):
                src = distribute_tensor(src.to(t.device), t.device_mesh,
                                        t.placements, src_data_rank=None)
            t.copy_(src)
    return model


def put_quantized(model: nn.Module, name: str, q: torch.Tensor,
                  scale: torch.Tensor) -> None:
    """Put the int8 pair ``(q, scale)`` in the place of ``model``'s
    parameter ``name`` (a dotted name, as ``named_parameters`` gives)."""
    owner_name, _, attr = name.rpartition(".")
    owner = model.get_submodule(owner_name) if owner_name else model
    delattr(owner, attr)
    setattr(owner, attr, QuantizedWeight(q, scale))


def quantize_kv(x: torch.Tensor) -> dict:
    """int8 KV storage with per-token-per-head scales.

    ``x`` is any KV tensor whose LAST axis is head_dim (a [.., kvH, hd]
    cache block, a single written token, a whole pooled cache); the
    scale reduces over head_dim only."""
    return _quantize(x, (x.dim() - 1,))


def quantize_lora_factor(x: torch.Tensor) -> dict:
    """int8 storage for a LoRA low-rank factor: an A factor
    ``[.., d_in, r]`` or a B factor ``[.., r, d_out]``.  Either way the
    second-to-last axis is the contraction axis of the rank-r product,
    so the scale reduces over it: one fp32 scale per output channel of
    the factor.  The serving adapter pool (``inference/serve/adapters.py``)
    stores its tenants this way."""
    return _quantize(x, (x.dim() - 2,))


def dequantize_kv(qkv: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"q", "scale"} KV leaf -> dense [.., kvH, hd] in ``dtype``."""
    return dequantize_leaf(qkv, dtype)


def kv_leaf_parts(x):
    """``(payload, scale | None)`` view of a KV-pool leaf: the storage
    contract the paged-attention kernel reads in-kernel (the int8 payload
    and its scales as separate operands, multiplied on load)."""
    if is_quantized_leaf(x):
        return x["q"], x["scale"]
    return x, None

