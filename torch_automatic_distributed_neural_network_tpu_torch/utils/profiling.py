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
  time, so "compiled" keeps the JAX name only: the call executes.  The
  JAX package's on-disk cost cache waits for ROADMAP Queue 1 item 4;
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
    """
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..obs import journal as _journal

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
    return {"flops": float(counter.get_total_flops()) or None,
            "memory": memory}


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
