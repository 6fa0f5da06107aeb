"""Paged LoRA adapter pool for multi-tenant serving.

The JAX package's ``inference/serve/adapters.py`` on PyTorch.  Serving
many fine-tuned variants of ONE base model cannot merge adapters per
request in the decode step (a merge builds a whole weight copy per
tenant).  Instead a fixed-shape pool of low-rank factors, indexed by
adapter slot, sits beside the paged KV pool: the slot-padded decode step
GATHERS each sequence slot's (A, B) by integer id and adds the
per-slot delta

    y = x @ W + scaling * (x @ A_id) @ B_id

to each adapted projection, so heterogeneous tenants (and the base model
itself) share one decode step; only the ``adapter_ids [S]`` operand
changes per step.

Layout.  One pool entry ("site") per adapted attention projection, keyed
``q/k/v/o``, each a pair of stacked factors in the matrix view

    a: [L, A, d_in, r]      b: [L, A, r, d_out]

layer-major (A = pool size), so ``factors[key]["a"][l]`` is layer ``l``'s
``[A, d_in, r]`` stack.  With ``quantize=True`` each factor is int8 with
per-output-channel fp32 scales (``quant.quantize_lora_factor``); a tenant
is quantized ONCE at ``register()``, so decode, prefill and any parity
oracle see the same round-tripped numbers, and the decode gather
dequantizes only the gathered rows (:func:`factor_rows`).

Slot 0 is ``IDENTITY_ADAPTER``: all-zero factors, so its delta is exactly
0 and base-model requests run through the same gather unchanged.  The
allocator hands out slots 1..A-1 with LRU eviction and
pinned-while-referenced semantics: a tenant decoding in some sequence
slot is never evicted from under the step; unpinned residents stay warm
until capacity demands their slot.  Pins are held by RUNNING sequence
slots only — queued and prefilling requests reference adapters by NAME,
which is what makes preemption leak-free (``Scheduler.check_invariants``
asserts it).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from ...training.lora import LoraSpec, adapter_shapes, init_lora_params
from ...utils.device import resolve_device
from ..quant import dequantize_leaf, is_quantized_leaf, quantize_lora_factor
from .scheduler import IDENTITY_ADAPTER

__all__ = ["IDENTITY_ADAPTER", "AdapterAllocator", "AdapterPool",
           "factor_rows", "pool_adapter_bytes", "random_adapter"]

# Only the attention projections are poolable: they are the classic LoRA
# recipe and the decode step adds their deltas per slot.
_SITE_RE = re.compile(r"^layers\.(\d+)\.attn\.(q_proj|k_proj|v_proj|o_proj)"
                      r"\.weight$")
_SITE_KEY = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o"}
_SITE_PROJ = {key: proj for proj, key in _SITE_KEY.items()}


class AdapterAllocator:
    """LRU slot allocator with pin counts over slots 1..n_adapters-1.

    ``acquire`` pins (refcount +1) and faults the name in if absent,
    evicting the least-recently-used UNPINNED resident when full; returns
    None when every slot is pinned (the caller backs off — the engine
    requeues the request).  ``release`` unpins but leaves the tenant
    resident, so a bursty tenant re-acquires its warm slot as a hit.
    Loud double release; slot 0 is never handed out.
    """

    def __init__(self, n_adapters: int):
        if n_adapters < 2:
            raise ValueError(
                f"n_adapters={n_adapters}: need slot 0 (identity) plus at "
                "least one tenant slot")
        self.n_adapters = n_adapters
        # LIFO free list like BlockAllocator: slot 1 pops first
        self._free = list(range(n_adapters - 1, 0, -1))
        self._slot: dict[str, int] = {}   # resident name -> slot
        self._refs: dict[str, int] = {}   # resident name -> pin count
        self._order: list[str] = []       # LRU order, least-recent first
        self.hits = 0
        self.faults = 0
        self.evictions = 0

    @property
    def n_resident(self) -> int:
        return len(self._slot)

    @property
    def n_pinned(self) -> int:
        return sum(1 for c in self._refs.values() if c > 0)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.faults
        return self.hits / total if total else 0.0

    def slot_of(self, name: str) -> int | None:
        return self._slot.get(name)

    def pinned_names(self) -> dict[str, int]:
        """name -> pin count for every pinned resident (invariant checks)."""
        return {n: c for n, c in self._refs.items() if c > 0}

    def _touch(self, name: str) -> None:
        self._order.remove(name)
        self._order.append(name)

    def acquire(self, name: str) -> tuple[int, bool, str | None] | None:
        """Pin ``name``; returns (slot, was_resident, evicted_name) or
        None when every slot is pinned by someone else."""
        if name in self._slot:
            self.hits += 1
            self._refs[name] += 1
            self._touch(name)
            return self._slot[name], True, None
        evicted = None
        if self._free:
            slot = self._free.pop()
        else:
            victim = next(
                (n for n in self._order if self._refs[n] == 0), None)
            if victim is None:
                return None
            slot = self._slot.pop(victim)
            del self._refs[victim]
            self._order.remove(victim)
            self.evictions += 1
            evicted = victim
        self.faults += 1
        self._slot[name] = slot
        self._refs[name] = 1
        self._order.append(name)
        return slot, False, evicted

    def release(self, name: str) -> None:
        if self._refs.get(name, 0) < 1:
            raise ValueError(
                f"release of adapter {name!r} that holds no pinned "
                "reference — double release or never acquired")
        self._refs[name] -= 1

    def invalidate(self, name: str) -> None:
        """Drop an unpinned resident (the re-register path).  Pinned ->
        error: a live decode slot is reading those factors."""
        if name not in self._slot:
            return
        if self._refs[name] > 0:
            raise ValueError(
                f"cannot invalidate adapter {name!r}: pinned by "
                f"{self._refs[name]} running slot(s)")
        self._free.append(self._slot.pop(name))
        del self._refs[name]
        self._order.remove(name)


def _zeros_factor(shape, quantize: bool, dtype, device):
    if not quantize:
        return torch.zeros(shape, dtype=dtype, device=device)
    # int8 q = 0 dequantizes to exactly 0 whatever the scale; scales
    # start at 1 to keep the leaf well-formed
    return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
            "scale": torch.ones(shape[:-2] + (1, shape[-1]),
                                dtype=torch.float32, device=device)}


def factor_rows(leaf, ids: torch.Tensor) -> torch.Tensor:
    """Per-slot factor gather: a layer's ``[A, m, n]`` pool leaf ->
    ``[S, m, n]`` fp32 at adapter ``ids [S]``.  An int8 leaf dequantizes
    only the GATHERED rows, so the pool itself stays int8."""
    if is_quantized_leaf(leaf):
        return leaf["q"][ids].to(torch.float32) * leaf["scale"][ids]
    return leaf[ids].to(torch.float32)


def _layer(leaf, layer: int):
    """Layer ``layer`` of a stacked pool leaf (a view)."""
    if is_quantized_leaf(leaf):
        return {"q": leaf["q"][layer], "scale": leaf["scale"][layer]}
    return leaf[layer]


class AdapterPool:
    """Fixed-shape device pool of per-tenant LoRA factors.

    ``register()`` validates and stages a tenant's factors (quantizing
    once if ``quantize``); ``acquire()`` pins it into a device slot
    (loading on fault); ``release()`` unpins.  ``factors`` is what the
    decode step reads (:meth:`layer_factors`): its shapes never change
    after construction, and a slot load writes into it in place.

    ``base``: the model (or its name -> tensor mapping) the spec's
    geometry comes from (``training.lora.adapter_shapes``), so the pool
    layout cannot drift from trained factor shapes.  ``device``: where
    the pool lives (default ``cuda``, raising without it).  A ``mesh``
    (tensor-parallel serving) raises ``NotImplementedError``.
    """

    def __init__(self, base, spec: LoraSpec, *, n_adapters: int = 8,
                 quantize: bool = False, dtype=torch.float32, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "AdapterPool(mesh=...): tensor-parallel serving is not "
                "ported to the PyTorch package yet (ROADMAP Queue 1 item 2, "
                "tensor-parallel serving)")
        self.spec = spec
        self.n_adapters = int(n_adapters)
        self.quantize = bool(quantize)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.allocator = AdapterAllocator(self.n_adapters)
        # key -> (n_layers, d_in, d_out); geometry from training/lora.py
        self.sites: dict[str, tuple[int, int, int]] = {}
        per_site: dict[str, dict[int, tuple[int, int]]] = {}
        for name, (lead, d_in, d_out) in adapter_shapes(base, spec).items():
            m = _SITE_RE.match(name)
            if m is None or lead:
                raise NotImplementedError(
                    f"the serving adapter pool factorizes the attention "
                    f"projections (layers.N.attn.{{q,k,v,o}}_proj.weight) "
                    f"only, but LoraSpec matched {name!r} — MLP and head "
                    "targets need the merge-per-request path")
            per_site.setdefault(_SITE_KEY[m.group(2)], {})[
                int(m.group(1))] = (d_in, d_out)
        for key, layers in per_site.items():
            n_layers = len(layers)
            dims = set(layers.values())
            if sorted(layers) != list(range(n_layers)) or len(dims) != 1:
                raise ValueError(f"site {key!r}: layers {sorted(layers)} "
                                 f"with factor dims {sorted(dims)}")
            (d_in, d_out), = dims
            self.sites[key] = (n_layers, d_in, d_out)
        r = spec.rank
        self.factors: dict[str, dict] = {
            key: {"a": _zeros_factor((L, self.n_adapters, d_in, r),
                                     self.quantize, dtype, self.device),
                  "b": _zeros_factor((L, self.n_adapters, r, d_out),
                                     self.quantize, dtype, self.device)}
            for key, (L, d_in, d_out) in self.sites.items()}
        self._registry: dict[str, dict] = {}

    def layer_factors(self, layer: int) -> dict[str, dict]:
        """Layer ``layer``'s ``{site: {"a": [A, d_in, r], "b": [A, r,
        d_out]}}`` (views of the pool)."""
        return {key: {side: _layer(fac[side], layer) for side in ("a", "b")}
                for key, fac in self.factors.items()}

    # -- registry -------------------------------------------------------------

    def has(self, name: str) -> bool:
        return name in self._registry

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._registry)

    def _site_name(self, key: str, layer: int) -> str:
        return f"layers.{layer}.attn.{_SITE_PROJ[key]}.weight"

    def register(self, name: str, lora: Mapping) -> None:
        """Stage a tenant's factors (``{weight name: {"a", "b"}}``, the
        layout of ``training.lora.init_lora_params``).  Validates that
        they match this pool's sites exactly; quantizes ONCE here when
        the pool is int8, so every consumer sees identical round-tripped
        numbers.  Re-registering a resident but unpinned tenant drops its
        slot (the next acquire faults the new factors in); a pinned
        tenant refuses."""
        want = {self._site_name(key, l): key
                for key, (L, _, _) in self.sites.items() for l in range(L)}
        if set(lora) != set(want):
            raise ValueError(
                f"adapter {name!r} factor sites {sorted(lora)} do not match "
                f"the pool's spec sites {sorted(want)}")
        r = self.spec.rank
        entry: dict[str, dict] = {}
        for key, (L, d_in, d_out) in self.sites.items():
            stacks = {"a": [], "b": []}
            for l in range(L):
                site = self._site_name(key, l)
                fac = lora[site]
                if set(fac) != {"a", "b"}:
                    raise ValueError(
                        f"adapter {name!r}: site {site!r} needs an 'a' and "
                        "a 'b' factor")
                a, b = fac["a"], fac["b"]
                if tuple(a.shape) != (d_in, r) or tuple(b.shape) != (r, d_out):
                    raise ValueError(
                        f"adapter {name!r}: site {site!r} factor shapes "
                        f"a{tuple(a.shape)} / b{tuple(b.shape)} do not "
                        f"match the pool's a{(d_in, r)} / b{(r, d_out)}")
                stacks["a"].append(torch.as_tensor(a, dtype=torch.float32))
                stacks["b"].append(torch.as_tensor(b, dtype=torch.float32))
            entry[key] = {}
            for side, parts in stacks.items():
                x = torch.stack(parts).to(self.device)  # [L, m, n]
                entry[key][side] = (quantize_lora_factor(x) if self.quantize
                                    else x.to(self.dtype))
        self.allocator.invalidate(name)
        self._registry[name] = entry

    def effective_lora(self, name: str) -> dict:
        """The EXACT factors decode serves (an int8 pool's round-trip
        through quantization), as the ``{weight name: {"a", "b"}}`` fp32
        mapping ``merge_lora`` and ``training.lora.adapted`` take.  The
        engine's prefill and the merged-weight parity oracle both use
        this, so prefill KV, the per-slot decode and the reference see
        one set of numbers."""
        out = {}
        for key, fac in self._registry[name].items():
            dense = {side: dequantize_leaf(fac[side], torch.float32)
                     if is_quantized_leaf(fac[side]) else fac[side]
                     for side in ("a", "b")}
            for l in range(self.sites[key][0]):
                out[self._site_name(key, l)] = {
                    side: dense[side][l] for side in ("a", "b")}
        return out

    # -- device slots ---------------------------------------------------------

    def acquire(self, name: str) -> tuple[int, bool, str | None] | None:
        """Pin ``name`` into a device slot, loading factors on fault.
        Returns (slot, was_resident, evicted_name) or None when every
        slot is pinned."""
        if name not in self._registry:
            raise KeyError(
                f"unknown adapter {name!r} — register() it before submit")
        res = self.allocator.acquire(name)
        if res is None:
            return None
        slot, was_resident, _ = res
        if not was_resident:
            self._load(slot, name)
        return res

    def release(self, name: str) -> None:
        self.allocator.release(name)

    @torch.no_grad()
    def _load(self, slot: int, name: str) -> None:
        for key, fac in self._registry[name].items():
            for side in ("a", "b"):
                src, dst = fac[side], self.factors[key][side]
                if self.quantize:
                    dst["q"][:, slot] = src["q"]
                    dst["scale"][:, slot] = src["scale"]
                else:
                    dst[:, slot] = src

    # -- accounting -----------------------------------------------------------

    @property
    def total_bytes(self) -> int:
        total = 0
        for fac in self.factors.values():
            for leaf in fac.values():
                for t in (leaf.values() if is_quantized_leaf(leaf)
                          else (leaf,)):
                    total += t.numel() * t.element_size()
        return total


def pool_adapter_bytes(cfg, *, rank: int, n_adapters: int,
                       quantize: bool = False,
                       degrees: dict | None = None) -> int:
    """Device-free per-device memory of an :class:`AdapterPool` under
    the default ``LoraSpec`` recipe (q_proj + v_proj): fp32 factors, or
    int8 payload + per-output-channel fp32 scales when ``quantize``.
    Under a tensor degree (``degrees={"tensor": t}``) each ``b`` factor
    splits its output channels t ways when they divide, so only b/t
    lands on a shard; ``a`` factors stay replicated."""
    t = int((degrees or {}).get("tensor", 1)) or 1
    per_adapter_layer = 0
    q_out = cfg.n_heads * cfg.head_dim
    v_out = cfg.kv_heads * cfg.head_dim
    for d_out in (q_out, v_out):
        shard = t if t > 1 and d_out % t == 0 else 1
        a_elems = cfg.d_model * rank
        b_elems = rank * (d_out // shard)
        o_local = d_out // shard
        if quantize:
            per_adapter_layer += a_elems + 4 * rank      # int8 + [1, r] f32
            per_adapter_layer += b_elems + 4 * o_local   # int8 + [1, o] f32
        else:
            per_adapter_layer += 4 * (a_elems + b_elems)
    return int(cfg.n_layers) * int(n_adapters) * per_adapter_layer


def random_adapter(base, spec: LoraSpec, *, seed: int = 0,
                   scale: float = 0.02) -> dict:
    """A seeded random tenant for smokes and benches: the geometry of
    ``init_lora_params`` (``a`` from a CPU generator seeded ``seed``) with
    a non-zero ``b`` drawn from ``numpy.random.RandomState(seed)`` with
    std ``scale`` (b starts at zero in training init, and an all-zero
    tenant would make multi-tenant parity vacuous)."""
    lora = init_lora_params(torch.Generator().manual_seed(seed), base, spec)
    rs = np.random.RandomState(seed)
    for fac in lora.values():
        fac["b"] = torch.from_numpy(
            rs.normal(scale=scale, size=tuple(fac["b"].shape)).astype(
                np.float32))
    return lora
