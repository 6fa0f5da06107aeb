"""Runtime device-timeline tracing: measured per-step attribution.

The analytic side of the comms story (``planner.expected_collective_bytes``,
``tune/cost.py``'s roofline) predicts traffic but cannot see *exposed*
collective time — communication that the schedule failed to hide behind
compute.  This module closes that loop on ``torch.profiler``, as the JAX
package's ``obs/trace.py`` does on ``jax.profiler``:

- :class:`StepTracer` captures a ``torch.profiler`` trace (CPU, and the
  CUDA lane when the step runs on the card) around instrumented steps,
  each step inside a ``record_function`` named ``tadnn_step#<i>``, and
  writes it with ``export_chrome_trace`` under its ``logdir``;
- :func:`parse_trace` reads that Chrome-trace JSON(.gz) into the step
  windows and the device-op lane (CUDA kernels, memcpys and memsets on
  the card; ``cpu_op`` events and the gloo/NCCL backends' annotations
  on the CPU), plus the ``c10d::*`` collectives with the bytes their
  recorded shapes carry;
- :func:`attribute` turns the parsed timeline into per-step compute
  time, collective time, exposed collective time (interval arithmetic
  over the op lanes) and measured MFU, journaled as ``trace.step``;
- :func:`measured_collective_bytes` sums a traced step's collective
  payload bytes by family (the profiler's ``Input Dims``/``Input type``
  of each ``c10d::*`` op: the JAX package reads the compiled HLO text
  instead), and :func:`crosscheck_collectives` journals the measured vs
  modeled ratio per category as ``trace.collective``;
  :func:`hlo_collective_bytes` (JAX's name) reads the same families'
  counts and bytes from the text of the traced step
  (``AutoDistribute.compiled_step_text``: an fx graph, not HLO).

Everything below the capture layer is pure stdlib (gzip/json/re), so
``tadnn report`` can re-attribute a saved trace on a machine with no
accelerator runtime.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import re
import tempfile
from typing import Any, Callable, Iterable, Sequence

from . import journal as _journal

# The record_function name marking one instrumented step's window:
# ``tadnn_step#<i>`` (record_function takes no args, so the step number
# rides in the name; the JAX package's annotation carries it as an arg).
STEP_ANNOTATION = "tadnn_step"

# Op-name prefixes that are collectives (async forms are emitted as
# <op>-start / <op>-done; matching on the prefix catches both).
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# The same families under this package's names: the c10d ops (the host
# side of a collective, with its shapes), the gloo and NCCL backends'
# own annotations (``gloo:all_reduce``, ``nccl:all_gather``) and the
# NCCL kernels on the device lane (``ncclDevKernel_AllReduce_Sum_f32_
# RING_LL``).  Matched on the name with its separators dropped.
_PORT_PREFIXES = ("c10d::", "gloo:", "nccl:", "ncclKernel_",
                  "ncclDevKernel_")
_PORT_FAMILIES = (
    ("reducescatter", "reduce-scatter"),
    ("allreduce", "all-reduce"),
    ("allgather", "all-gather"),
    ("alltoall", "all-to-all"),
    ("sendrecv", "collective-permute"),
    ("c10dsend", "collective-permute"),
    ("c10drecv", "collective-permute"),
    ("broadcast", "broadcast"),
)

# Which planner.expected_collective_bytes per-device category each
# collective family lands in (tune/cost.py._CATEGORY_AXES is the same
# taxonomy from the modeled side), and the c10d ops FSDP2 and DDP
# dispatch, by name.
CATEGORY_BY_OP = {
    "all-reduce": "grad_allreduce",
    "all-gather": "param_allgather",
    "reduce-scatter": "grad_reduce_scatter",
    "c10d::allreduce_": "grad_allreduce",
    "c10d::_allgather_base_": "param_allgather",
    "c10d::allgather_into_tensor_coalesced_": "param_allgather",
    "c10d::_reduce_scatter_base_": "grad_reduce_scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "grad_reduce_scatter",
}

# bytes of the profiler's ``Input type`` names (unknown: 4, as the JAX
# package counts an unknown HLO dtype)
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
    "long int": 8, "int": 4, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::Float8_e4m3fn": 1,
    "c10::Float8_e5m2": 1, "c10::complex<float>": 8,
    "c10::complex<double>": 16,
}


def collective_family(op_name: str) -> str | None:
    """The collective family of an op name (one of ``COLLECTIVE_OPS``,
    or ``broadcast``), or None for an op that moves no data between
    devices."""
    for fam in COLLECTIVE_OPS:
        if op_name.startswith(fam):
            return fam
    if not op_name.startswith(_PORT_PREFIXES):
        return None
    flat = re.sub(r"[^a-z0-9]", "", op_name.lower())
    for key, fam in _PORT_FAMILIES:
        if key in flat:
            return fam
    return None


def is_collective(op_name: str) -> bool:
    """True for ops that move data between devices: the HLO names (the
    sync form or the async ``-start``/``-done`` halves) and this
    package's c10d ops, backend annotations and NCCL kernels."""
    return collective_family(op_name) is not None


# -- capture ----------------------------------------------------------------


def _device_of(obj: Any):
    """The device of the first tensor inside ``obj`` (a tensor, or a
    tree of them such as ``TrainState``), else None."""
    import torch

    from ..utils.debug import tree_leaves

    for _, leaf in tree_leaves(obj):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


class StepTracer:
    """Profiler capture with per-step window annotations.

    Usage::

        with StepTracer(device=ad.device) as tr:
            for i in range(5):
                with tr.step(i):
                    state, m = ad.step(state, batch)
                    tr.fence()   # the window must contain the device work
        recs = attribute(parse_trace(tr.trace_path))

    The fence matters: CUDA launches are asynchronous, so an unfenced
    window measures host-side enqueue, not the device timeline.
    ``device`` (a ``torch.device`` or its name) adds the CUDA lane when
    it is a CUDA device.  ``trace_path`` is the ``.json.gz`` the capture
    wrote under ``logdir`` (set on exit).
    """

    def __init__(self, logdir: str | None = None, *, device: Any = None):
        import torch

        self.logdir = logdir or tempfile.mkdtemp(prefix="tadnn_trace_")
        self.device = torch.device(device) if device is not None else (
            torch.device("cpu"))
        self.trace_path: str | None = None
        self._prof = None

    def __enter__(self) -> "StepTracer":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities, record_shapes=True)
        self._prof.__enter__()
        return self

    def step(self, i: int):
        """Annotation context marking step ``i``'s window on the trace."""
        from torch.profiler import record_function

        return record_function(f"{STEP_ANNOTATION}#{int(i)}")

    def fence(self) -> None:
        """Wait for the work queued on the traced device (a no-op on the
        CPU, where the step already ran)."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc: Any) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        if exc and exc[0] is not None:
            return
        os.makedirs(self.logdir, exist_ok=True)
        fd, path = tempfile.mkstemp(dir=self.logdir, prefix="tadnn_trace.",
                                    suffix=".json.gz")
        os.close(fd)
        prof.export_chrome_trace(path)
        self.trace_path = path


# -- parsing ----------------------------------------------------------------

# device-lane categories of a CUDA capture
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _numel(dims: Any) -> int:
    """Elements of a profiler ``Input Dims`` entry: a shape, or a list
    of shapes for a tensor list."""
    if not isinstance(dims, list):
        return 0
    if all(isinstance(d, int) for d in dims):
        return math.prod(dims)
    return sum(_numel(d) for d in dims)


def _result_bytes(args: dict, by_numel: dict[int, int]) -> int:
    """Bytes of a c10d op's result, by the JAX package's convention (the
    collective's result shape): the first argument of every c10d op is
    the tensor (list) it writes — ``_allgather_base_``'s gathered output,
    ``_reduce_scatter_base_``'s shard, ``allreduce_``'s tensors.  A
    tensor list records no dtype: it is taken from the backend's own
    annotation of the same size (``by_numel``), else counted at 4
    bytes."""
    dims = (args.get("Input Dims") or [None])[0]
    types = args.get("Input type") or [""]
    n = _numel(dims)
    if dims == [] or not n:
        return 0
    itemsize = _DTYPE_BYTES.get(types[0])
    if itemsize is None:
        itemsize = by_numel.get(n, 4)
    return n * itemsize


def _load_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", ()) if isinstance(data, dict) else data


def parse_trace(path: str) -> dict:
    """Parse a ``torch.profiler`` Chrome trace (JSON or ``.json.gz``)
    into the lanes the attribution needs: step windows (the
    ``tadnn_step#<i>`` ranges: ``gpu_user_annotation`` on the device
    clock when the capture has a CUDA lane, else ``user_annotation``)
    and op events (CUDA kernels, memcpys and memsets on the card; on a
    CPU-only capture the ``cpu_op`` events and the gloo/NCCL backends'
    annotations).  Timestamps and durations are microseconds on one
    clock.  Also ``host_steps`` (the host-side windows) and
    ``collectives`` (each ``c10d::*`` op: name, family, ts and the
    bytes of its result) for :func:`measured_collective_bytes`."""
    events = [e for e in _load_events(path) if e.get("ph") == "X"]
    prefix = STEP_ANNOTATION + "#"

    def windows(cat: str) -> list[dict]:
        out = []
        for e in events:
            name = e.get("name", "")
            if e.get("cat") == cat and name.startswith(prefix):
                try:
                    step = int(name[len(prefix):])
                except ValueError:
                    continue
                out.append({"step": step, "ts": e["ts"],
                            "dur": e.get("dur", 0.0)})
        return sorted(out, key=lambda s: s["ts"])

    host_steps = windows("user_annotation")
    device_ops = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if device_ops:
        steps = windows("gpu_user_annotation") or host_steps
        lane = device_ops
    else:
        steps = host_steps
        lane = [e for e in events if e.get("cat") == "cpu_op" or (
            e.get("cat") == "user_annotation"
            and is_collective(e.get("name", "")))]
    ops = sorted(({"name": e.get("name", ""), "ts": e["ts"],
                   "dur": e.get("dur", 0.0), "tid": e.get("tid")}
                  for e in lane), key=lambda o: o["ts"])
    # a tensor list's dtype, from the backend annotation of its size
    by_numel: dict[int, int] = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(
                ("gloo:", "nccl:")):
            args = e.get("args") or {}
            size = _DTYPE_BYTES.get((args.get("Input type") or [""])[0])
            n = _numel((args.get("Input Dims") or [None])[0])
            if size and n:
                by_numel.setdefault(n, size)
    colls = []
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "cpu_op" or not name.startswith("c10d::"):
            continue
        fam = collective_family(name)
        if fam is None:
            continue
        colls.append({"name": name, "family": fam, "ts": e["ts"],
                      "bytes": _result_bytes(e.get("args") or {},
                                             by_numel)})
    colls.sort(key=lambda c: c["ts"])
    return {"steps": steps, "ops": ops, "path": path,
            "host_steps": host_steps, "collectives": colls}


def _union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge possibly-overlapping [start, end) intervals."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out: list[tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _total(union: Sequence[tuple[float, float]]) -> float:
    return sum(e - s for s, e in union)


def _overlap(a: Sequence[tuple[float, float]],
             b: Sequence[tuple[float, float]]) -> float:
    """Total length of the intersection of two interval unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute(parsed: dict, *, flops_per_step: float | None = None,
              peak_flops_per_chip: float | None = None,
              n_chips: int | None = None) -> list[dict]:
    """Per-step attribution from a parsed timeline.

    For each ``tadnn_step`` window: clip the device-op events to it,
    classify collective vs compute by op name, and compute

    - ``compute_s`` / ``collective_s``: union lengths of each class
      (union, not sum — parallel op lanes must not double-count);
    - ``exposed_collective_s``: collective union MINUS its overlap with
      the compute union — communication the schedule failed to hide,
      the measured analog of tune/cost.py's worst-case comm term;
    - ``measured_mfu`` when the caller supplies ``flops_per_step``
      (peak and chip count default to the detected topology's).

    All durations in seconds.  Invariants:
    ``exposed <= collective`` and ``compute, collective <= wall``.
    """
    recs = []
    for win in parsed["steps"]:
        t0, t1 = win["ts"], win["ts"] + win["dur"]
        comp, coll = [], []
        coll_by_family: dict[str, float] = {}
        n_ops = 0
        for op in parsed["ops"]:
            s = max(op["ts"], t0)
            e = min(op["ts"] + op["dur"], t1)
            if e <= s:
                continue
            n_ops += 1
            fam = collective_family(op["name"])
            if fam is not None:
                coll.append((s, e))
                coll_by_family[fam] = coll_by_family.get(fam, 0.0) + (
                    (e - s) / 1e6
                )
            else:
                comp.append((s, e))
        comp_u, coll_u = _union(comp), _union(coll)
        collective_s = _total(coll_u) / 1e6
        exposed_s = collective_s - _overlap(comp_u, coll_u) / 1e6
        wall_s = win["dur"] / 1e6
        rec = {
            "step": win["step"],
            "wall_s": wall_s,
            "compute_s": _total(comp_u) / 1e6,
            "collective_s": collective_s,
            "exposed_collective_s": max(0.0, exposed_s),
            "n_ops": n_ops,
        }
        if coll_by_family:
            rec["collectives"] = {
                k: round(v, 9) for k, v in sorted(coll_by_family.items())
            }
        mfu = _measured_mfu(flops_per_step, wall_s,
                            peak_flops_per_chip, n_chips)
        if mfu is not None:
            rec["measured_mfu"] = mfu
        recs.append(rec)
    return recs


def _measured_mfu(flops_per_step: float | None, wall_s: float,
                  peak: float | None, n_chips: int | None) -> float | None:
    if not flops_per_step or wall_s <= 0:
        return None
    if peak is None or n_chips is None:
        from .. import topology

        topo = topology.detect()
        peak = peak if peak is not None else topo.chip.flops_per_s
        n_chips = n_chips if n_chips is not None else topo.num_devices
    if not peak or not n_chips:
        return None
    return flops_per_step / wall_s / (peak * n_chips)


# -- capture + attribute in one call ----------------------------------------


def trace_steps(
    step_fn: Callable[[Any, Any], tuple[Any, Any]],
    state: Any,
    batch: Any,
    *,
    steps: int = 3,
    first_step: int = 0,
    logdir: str | None = None,
    flops_per_step: float | None = None,
    journal: "Any | None" = None,
    device: Any = None,
    timeline: dict | None = None,
) -> tuple[Any, list[dict]]:
    """Run ``steps`` instrumented calls of ``step_fn(state, batch) ->
    (state, metrics)`` under one profiler capture, attribute the
    timeline, and journal one ``trace.step`` event per step.  Returns
    ``(final_state, attribution_records)``; a ``timeline`` dict is
    filled with the parsed capture (:func:`parse_trace`), the input of
    :func:`measured_collective_bytes`.

    Each step is fenced (``torch.cuda.synchronize`` inside its window)
    so the annotation window contains the device work — the capture is
    NOT steady-state throughput and its wall time lands in the trainer's
    ``trace`` goodput bucket, never ``step``.  ``device`` defaults to
    where the state's tensors live.
    """
    if device is None:
        device = _device_of(state) or _device_of(batch)
    tracer = StepTracer(logdir, device=device)
    with tracer:
        for k in range(steps):
            with tracer.step(first_step + k):
                state, metrics = step_fn(state, batch)
                tracer.fence()
    parsed = parse_trace(tracer.trace_path)
    if timeline is not None:
        timeline.update(parsed)
    recs = attribute(parsed, flops_per_step=flops_per_step)
    jnl = journal if journal is not None else _journal.get_default()
    for r in recs:
        jnl.event("trace.step", trace=tracer.trace_path, **r)
    return state, recs


# -- measured collective bytes (the profiled step's c10d ops) ---------------


def measured_collective_bytes(parsed: dict) -> dict[str, dict]:
    """Per-family collective payload bytes of one traced step, from a
    :func:`parse_trace` timeline: every ``c10d::*`` op inside a step's
    host window, its result's bytes (the recorded ``Input Dims`` and
    ``Input type``), summed per family and averaged over the traced
    steps.  Per device (each process records its own ops), directly
    comparable to ``expected_collective_bytes()['per_device'][cat]
    ['payload_bytes']``.  The JAX package parses the same numbers out of
    the compiled HLO text; a profiled step covers every accumulation
    slice, so it is already a whole step."""
    windows = parsed.get("host_steps") or parsed.get("steps") or ()
    if not windows:
        return {}
    out: dict[str, dict] = {}
    for c in parsed.get("collectives") or ():
        if not any(w["ts"] <= c["ts"] < w["ts"] + w["dur"]
                   for w in windows):
            continue
        rec = out.setdefault(c["family"], {"count": 0, "payload_bytes": 0})
        rec["count"] += 1
        rec["payload_bytes"] += c["bytes"]
    n = len(windows)
    return {fam: {"count": round(r["count"] / n),
                  "payload_bytes": int(r["payload_bytes"] / n)}
            for fam, r in sorted(out.items())}


# ``name: "bf16[4, 3]" = torch.ops._c10d_functional.all_reduce.default(``
# — a collective node of a traced step's readable fx text, with its
# result's dtype and shape (a list result: several ``dtype[dims]``)
_FX_COLL_RE = re.compile(
    r':\s*"(?P<shape>[^"]*)"\s*=\s*torch\.ops\.'
    r'(?P<ns>_c10d_functional|c10d)\.(?P<op>\w+)\.')
_FX_SHAPE_RE = re.compile(r"([a-z]+[0-9]*)\[([0-9, ]*)\]")
_FX_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "i64": 8,
                   "i32": 4, "i16": 2, "i8": 1, "u8": 1, "b8": 1,
                   "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16}


def hlo_collective_bytes(compiled_text: str) -> dict[str, dict]:
    """Per-family collective payload bytes parsed from the text of a
    traced step (``AutoDistribute.compiled_step_text``): every
    collective node's result shape, summed per family — JAX's
    convention, which parses the compiled HLO.  The port's text is the
    fx graph of the step traced on fake tensors at the plan's local
    shapes (one rank's program), so the numbers are per device and
    comparable to ``expected_collective_bytes()['per_device'][cat]
    ['payload_bytes']``.  Waits and unknown dtypes (counted at 4 bytes,
    as JAX counts an unknown HLO dtype) aside, each node is one
    collective."""
    out: dict[str, dict] = {}
    for m in _FX_COLL_RE.finditer(compiled_text or ""):
        fam = collective_family(f"c10d::{m.group('op')}")
        if fam is None:
            continue
        b = 0
        for dtype, dims in _FX_SHAPE_RE.findall(m.group("shape")):
            n = 1
            for d in dims.split(","):
                if d.strip():
                    n *= int(d)
            b += n * _FX_DTYPE_BYTES.get(dtype, 4)
        rec = out.setdefault(fam, {"count": 0, "payload_bytes": 0})
        rec["count"] += 1
        rec["payload_bytes"] += b
    return out


def crosscheck_collectives(
    measured: dict, modeled_per_device: dict, *,
    grad_accum: int = 1, journal: "Any | None" = None,
) -> list[dict]:
    """Join measured (profiled) and modeled (planner) collective bytes
    and journal one ``trace.collective`` event per category.

    ``ratio`` is measured/modeled payload bytes; ``within_2x`` is the
    acceptance band (the modeled side is exact ring-payload math, so the
    ratio lands near 1.0 — drift beyond 2x means the plan model and the
    executed step disagree about what moves).  ``grad_accum`` scales a
    one-slice measurement to the modeled per-step convention; a
    :func:`measured_collective_bytes` step is whole already (1).
    """
    by_cat: dict[str, dict] = {}
    for op, v in measured.items():  # by family or by c10d op name
        by_cat.setdefault(CATEGORY_BY_OP.get(op, op), v)
    out = []
    for fam in ("all-reduce", "all-gather", "reduce-scatter"):
        cat = CATEGORY_BY_OP[fam]
        m = by_cat.get(cat, {})
        meas = m.get("payload_bytes", 0) * max(1, grad_accum)
        model = (modeled_per_device.get(cat) or {}).get("payload_bytes", 0)
        if not meas and not model:
            continue
        ratio = (meas / model) if (meas and model) else None
        rec = {
            "category": cat,
            "hlo_op": fam,
            "measured_bytes": int(meas),
            "modeled_bytes": int(model),
            "count": m.get("count", 0),
            "ratio": round(ratio, 4) if ratio is not None else None,
            "within_2x": (ratio is not None and 0.5 <= ratio <= 2.0),
        }
        out.append(rec)
        jnl = journal if journal is not None else _journal.get_default()
        jnl.event("trace.collective", **rec)
    return out


def exposed_fraction(steps: Sequence[dict]) -> float | None:
    """Fraction of total collective time that is exposed across a set of
    ``trace.step`` records — the measured-overlap feed for
    ``tune.cost.score(measured_overlap=...)``.  None when the steps saw
    no collectives (single device)."""
    coll = sum(s.get("collective_s") or 0.0 for s in steps)
    exp = sum(s.get("exposed_collective_s") or 0.0 for s in steps)
    if coll <= 0 or not math.isfinite(coll):
        return None
    return min(1.0, max(0.0, exp / coll))
