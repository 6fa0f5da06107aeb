"""Tracing / profiling hooks: ``torch.profiler`` traces and one-call cost
measurements for MFU and memory accounting (the JAX package's
``utils/profiling.py``, whose ``jax.profiler`` traces and XLA cost
analysis these replace).

- :func:`trace` captures a Chrome trace (CPU, and CUDA when the card is
  there) of everything inside the block into ``logdir``;
- :func:`annotate` names a region on that timeline;
- :func:`compiled_cost` runs a callable ONCE and measures it: its FLOPs
  (``torch.utils.flop_counter.FlopCounterMode``) and, on CUDA, the peak
  memory the call allocated.  PyTorch compiles no program ahead of
  time, so "compiled" keeps the JAX name only: the call executes.  Its
  result is memoized in the process and, with ``TADNN_EXPORT_CACHE``
  set, in the export cache's index (the JAX package's cost cache);
- :class:`LiveBytes` counts the bytes of the storages alive during a
  call, fake tensors' too, and :class:`Flops` its FLOPs: run under
  ``FakeTensorMode`` they measure a step with nothing allocated
  (``AutoDistribute.compile_report``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

@contextlib.contextmanager
def trace(logdir: str, device: Any = None):
    """Capture a Chrome trace of everything inside the block, written to
    ``logdir`` on exit (view it in Perfetto or ``chrome://tracing``)::

        with profiling.trace("/tmp/trace"):
            for _ in range(10):
                state, _ = ad.step(state, batch)

    The CUDA lane is captured when ``device`` is a CUDA device, or (the
    default, None) when a card is there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    fd, path = tempfile.mkstemp(dir=logdir, prefix="trace.",
                                suffix=".json.gz")
    os.close(fd)
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    from torch.profiler import record_function

    return record_function(name)


def _tensors(obj: Any):
    import torch

    from .debug import tree_leaves

    return [leaf for _, leaf in tree_leaves(obj)
            if isinstance(leaf, torch.Tensor)]


def _nbytes(obj: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


# memo of measured costs.  JAX keys its memo on the digest of the
# lowered program, which holds the weights' shapes; the port lowers
# nothing, so the key digests what decides the measurement: the callable
# and the state it reaches (a module's parameters, buffers, submodules
# and plain attributes, a function's bytecode, defaults, closed-over
# values and the module-level models, tensors and plain data it names,
# a bound method's object),
# the arguments' shapes, dtypes and devices (and any scalar arguments),
# and the environment (torch, CUDA, the card).  Values of tensors are not
# keyed: what is memoized depends on shapes only.  A callable whose
# state cannot be described gets no key and is measured on every call.
# In-process hits skip the call; cross-process hits ride in the export
# cache's index as JSON-only records, validated against the same
# fingerprint.
_cost_memo: dict[str, dict] = {}

# the measurements a memo keeps: the FLOPs and the bytes passed in and
# returned.  ``temp_size`` and ``peak_size`` depend on what the
# allocator held around the call, so only a call that runs reports them.
_MEMO_MEMORY = ("argument_size", "output_size")


class _Undescribable(Exception):
    pass


def _describe(obj, seen: set[int]):
    """A JSON-able description of ``obj`` that changes when what a call
    of it (or with it) computes may change; raises ``_Undescribable``."""
    import dataclasses
    import enum
    import functools
    import hashlib
    import marshal
    import types

    import torch

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return repr(obj)
    if isinstance(obj, (torch.dtype, torch.device, enum.Enum)):
        return str(obj)
    if isinstance(obj, torch.Tensor):
        return ["tensor", list(obj.shape), str(obj.dtype), str(obj.device),
                bool(obj.requires_grad)]
    if isinstance(obj, (tuple, list)):
        return [_describe(v, seen) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(_dumps(_describe(v, seen)) for v in obj)
    if isinstance(obj, dict):
        return [[_describe(k, seen), _describe(v, seen)]
                for k, v in obj.items()]
    if isinstance(obj, (types.ModuleType, type, types.BuiltinFunctionType,
                        torch._ops.OpOverload, torch._ops.OpOverloadPacket)):
        return ["static", getattr(obj, "__module__", None),
                getattr(obj, "__qualname__", getattr(obj, "__name__", None))]
    if id(obj) in seen:  # a cycle: described where it was first met
        return ["seen", type(obj).__qualname__]
    seen.add(id(obj))
    if isinstance(obj, torch.nn.Module):
        attrs = {k: v for k, v in vars(obj).items()
                 if not k.startswith("_") or k in ("_parameters", "_buffers",
                                                   "_modules")}
        return ["module", type(obj).__module__, type(obj).__qualname__,
                _describe(type(obj).forward, seen),
                [[k, _describe(attrs[k], seen)] for k in sorted(attrs)]]
    if isinstance(obj, types.FunctionType):
        code = obj.__code__
        names = set()
        stack = [code]
        while stack:  # the module-level names of nested functions too
            c = stack.pop()
            names.update(c.co_names)
            stack.extend(k for k in c.co_consts
                         if isinstance(k, types.CodeType))
        g = obj.__globals__
        return ["function", obj.__module__, obj.__qualname__,
                hashlib.sha256(marshal.dumps(code)).hexdigest(),
                _describe(obj.__defaults__, seen),
                _describe(obj.__kwdefaults__, seen),
                [_describe(c.cell_contents, seen)
                 for c in obj.__closure__ or ()],
                [[n, _describe_global(g[n], seen)] for n in sorted(names)
                 if n in g]]
    if isinstance(obj, types.MethodType):
        return ["method", _describe(obj.__self__, seen),
                _describe(obj.__func__, seen)]
    if isinstance(obj, functools.partial):
        return ["partial", _describe(obj.func, seen),
                _describe(obj.args, seen), _describe(obj.keywords, seen)]
    if dataclasses.is_dataclass(obj):
        return ["dataclass", type(obj).__module__, type(obj).__qualname__,
                [[f.name, _describe(getattr(obj, f.name), seen)]
                 for f in dataclasses.fields(obj)]]
    if callable(obj) and hasattr(obj, "__dict__"):
        # an instance whose class defines __call__: its code and its state
        return ["callable", type(obj).__module__, type(obj).__qualname__,
                _describe(type(obj).__call__, seen),
                _describe(vars(obj), seen)]
    raise _Undescribable(type(obj).__qualname__)


def _describe_global(obj, seen: set[int]):
    """A module-level value a function names: described in full when it
    can be (a model, a tensor, plain data); another function by its
    code alone, and any other object (a logger, a registry) by its type,
    so that the helpers a function calls do not pull the library's
    internals into the key."""
    import hashlib
    import marshal
    import types

    if isinstance(obj, types.FunctionType):
        return ["function", obj.__module__, obj.__qualname__,
                hashlib.sha256(marshal.dumps(obj.__code__)).hexdigest()]
    inner = set(seen)
    try:
        out = _describe(obj, inner)
    except _Undescribable:
        return ["opaque", type(obj).__module__, type(obj).__qualname__]
    seen |= inner
    return out


def _dumps(obj) -> str:
    import json

    return json.dumps(obj, sort_keys=True)


def _cost_cache_key(fn, args, kwargs) -> str | None:
    import hashlib

    from ..export.cache import env_fingerprint

    try:
        blob = _dumps({"fn": _describe(fn, set()),
                           "args": _describe((args, kwargs), set()),
                           "env": env_fingerprint()})
    except (_Undescribable, TypeError, ValueError, AttributeError):
        return None
    return "cost-" + hashlib.sha256(blob.encode()).hexdigest()[:32]


def _memo_entry(cost: dict) -> dict:
    """What the memo keeps of a measurement (``_MEMO_MEMORY``)."""
    return {"flops": cost["flops"],
            "memory": {k: cost["memory"][k] for k in _MEMO_MEMORY}}


def compiled_cost(fn, *args, **kwargs) -> dict:
    """ONE call, all measurements: ``{'flops': ..., 'memory': ...}``.

    ``flops`` counts the call's matmuls, convolutions and attention
    (``FlopCounterMode``: 2·M·K·N a matmul, as XLA's cost analysis
    counts them); None when it counted nothing.  ``memory`` holds
    ``argument_size`` and ``output_size`` (bytes of the tensors passed
    in and returned) and, when they are on CUDA, ``temp_size`` (the
    peak the call allocated above its arguments, outputs included) and
    ``peak_size`` (the allocator's peak during the call).  A failing
    call returns ``{'flops': None, 'memory': None, 'error': '<reason>'}``
    and journals ``cost_analysis.error``, as in the JAX package.

    Results are memoized (:data:`_cost_memo`, and the export cache's
    index when ``TADNN_EXPORT_CACHE`` is set) under a key of the
    callable's code and reachable state and the arguments' shapes (see
    :func:`_describe`): a hit does not run ``fn``, as JAX's cost
    analysis never runs it, and returns ``flops``, ``argument_size``
    and ``output_size`` only (``temp_size`` and ``peak_size`` depend on
    the allocator's state, and are not kept).  Each skipped call
    journals ``cost_analysis.cached`` with its tier (``memory`` or
    ``disk``).  Failures are never cached, and a callable whose state
    cannot be described is measured on every call.
    """
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..obs import journal as _journal

    key = _cost_cache_key(fn, args, kwargs)
    if key is not None and key in _cost_memo:
        _journal.event("cost_analysis.cached", key=key, tier="memory")
        return _copy(_cost_memo[key])
    cache = None
    if key is not None:
        from ..export import cache as _export_cache

        cache = _export_cache.resolve(None)  # env-gated, off by default
        if cache is not None:
            rec = cache.lookup(key)
            if rec is not None and cache.check_live(rec) is None:
                analysis = rec.get("analysis") or {}
                _cost_memo[key] = _copy(analysis)
                _journal.event("cost_analysis.cached", key=key,
                               tier="disk")
                return _copy(analysis)
    cuda = [t for t in _tensors((args, kwargs)) if t.is_cuda]
    device = cuda[0].device if cuda else None
    try:
        if device is not None:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
        with FlopCounterMode(display=False) as counter:
            out = fn(*args, **kwargs)
        if device is not None:
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
    except Exception as e:  # noqa: BLE001 — reported, as JAX reports it
        reason = f"{type(e).__name__}: {e}"
        _journal.event("cost_analysis.error", error=reason)
        return {"flops": None, "memory": None, "error": reason}
    memory = {"argument_size": _nbytes((args, kwargs)),
              "output_size": _nbytes(out)}
    if device is not None:
        memory["temp_size"] = int(peak - before)
        memory["peak_size"] = int(peak)
    out = {"flops": float(counter.get_total_flops()) or None,
           "memory": memory}
    if key is not None:
        _cost_memo[key] = _memo_entry(out)
        if cache is not None:
            try:
                cache.put_record(key, {
                    "kind": "cost_analysis",
                    "env": _export_cache.env_fingerprint(),
                    "analysis": _memo_entry(out),
                })
            except OSError:
                pass  # read-only cache dir — the measurement still returns
    return out


def _copy(cost: dict) -> dict:
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in cost.items()}


def compiled_flops(fn, *args, **kwargs) -> float | None:
    """FLOPs of one call of ``fn`` (``FlopCounterMode``).  None when the
    call counted nothing or failed; callers fall back to analytic 6ND
    estimates."""
    cost = compiled_cost(fn, *args, **kwargs)
    return cost["flops"] if not cost.get("error") else None


def compiled_memory(fn, *args, **kwargs) -> dict | None:
    """Memory of one call of ``fn``: argument and output bytes, and on
    CUDA the peak it allocated (``compiled_cost``).  None when the call
    failed."""
    cost = compiled_cost(fn, *args, **kwargs)
    return cost["memory"] if not cost.get("error") else None


def memory_stats(device: Any | None = None) -> dict | None:
    """The CUDA caching allocator's statistics of ``device`` (default:
    the current card); None on the CPU, which keeps none, as the JAX
    package returns None for a device without them."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else
        torch.device("cpu"))
    if dev.type != "cuda":
        return None
    try:
        return dict(torch.cuda.memory_stats(dev))
    except Exception:  # noqa: BLE001 — no allocator statistics
        return None



class LiveBytes(TorchDispatchMode):
    """A dispatch mode that tracks the bytes of live storages: each
    storage an op makes is counted from the op until the storage is
    freed (a weak reference's callback), a view or an in-place result of
    a storage it knows is not counted again.  ``track`` registers
    storages made before the mode (a call's arguments).  ``current`` and
    ``peak`` are bytes; under ``FakeTensorMode`` the fake storages are
    counted as the real ones would be and nothing is allocated."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def _add(self, t) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return key
        n = int(st.nbytes())
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._drop, key)
        return key

    def _drop(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def track(self, tree) -> set[int]:
        """Count the storages of ``tree``'s tensors; returns their keys."""
        return {self._add(t) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)}

    @staticmethod
    def keys(tree) -> set[int]:
        """The storage keys of ``tree``'s tensors."""
        return {t.untyped_storage()._cdata for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


class Flops(TorchDispatchMode):
    """FLOPs of the ops run under it, by ``FlopCounterMode``'s own formula
    table (``torch.utils.flop_counter.flop_registry``, K1-K3 registered
    there by ``ops/flash_attention.py``).  The mode itself is not used:
    its module tracker hooks every module's gradients, which
    ``torch.autograd.grad`` through a checkpointed layer refuses."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += int(formula(*args, **kwargs, out_val=out))
        return out
