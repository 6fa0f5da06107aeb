"""Device-timeline attribution: the pure half of the JAX package's
``obs/trace.py``.

The analytic side of the comms story (``planner.expected_collective_bytes``,
``tune/cost.py``'s roofline) predicts traffic but cannot see *exposed*
collective time — communication that the schedule failed to hide behind
compute.  This module holds the stdlib arithmetic that turns a parsed
device timeline into that measurement:

- :func:`is_collective` classifies an op name;
- :func:`attribute` turns a parsed timeline (``{"steps": [...], "ops":
  [...]}``, times in microseconds) into per-step compute time,
  collective time, exposed collective time (interval arithmetic over the
  device-op lanes) and, given the step's FLOPs, measured MFU;
- :func:`exposed_fraction` folds ``trace.step`` records into the
  measured-overlap feed of ``tune.cost.score(measured_overlap=...)``.

The capture half — ``StepTracer``, ``trace_steps`` and the collective
byte crosscheck, on ``torch.profiler`` — waits for ROADMAP Queue 1 item
7d, as does parsing a ``torch.profiler`` trace into the timeline form
:func:`attribute` reads.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

# Op-name prefixes that are collectives (async forms are emitted as
# <op>-start / <op>-done; matching on the prefix catches both).
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# Which planner.expected_collective_bytes per-device category each
# collective family lands in (tune/cost.py._CATEGORY_AXES is the same
# taxonomy from the modeled side).
CATEGORY_BY_OP = {
    "all-reduce": "grad_allreduce",
    "all-gather": "param_allgather",
    "reduce-scatter": "grad_reduce_scatter",
}


def is_collective(op_name: str) -> bool:
    """True for ops that move data between devices (either the sync
    form or the async ``-start``/``-done`` halves)."""
    return op_name.startswith(COLLECTIVE_OPS)


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

    For each step window: clip the device-op events to it, classify
    collective vs compute by op name, and compute

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
            if is_collective(op["name"]):
                coll.append((s, e))
                fam = next(f for f in COLLECTIVE_OPS
                           if op["name"].startswith(f))
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
