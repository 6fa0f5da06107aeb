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
  JAX package's on-disk cost cache waits for ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any

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
