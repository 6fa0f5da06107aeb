"""Multihost journal aggregation: merge per-host JSONL journals into one
run view (the JAX package's ``obs/aggregate.py``, copied: it is pure
stdlib there too).

Multi-process runs produce one journal per process when constructed with
``Journal(path_i, host0_only=False, meta={"host": i})`` (the pattern the
launcher's workers follow: per-process artifacts, joined by the
supervisor, ``training/launch.py``).  This module merges those files —
tagging every record with its host id and interleaving on the wall
clock — so a report sees a single timeline, and computes the per-host
step skew (the straggler signal: one slow host gates every collective).

Pure stdlib; safe on a machine with no accelerator runtime.
"""

from __future__ import annotations

import json
import os
import re
from typing import Mapping, Sequence

from .journal import Journal

# journal.host3.jsonl / journal-3.jsonl / host3.journal.jsonl ...
_HOST_IN_NAME = re.compile(r"(?:host|proc|p)[._-]?(\d+)")


def find_host_journals(directory: str) -> list[str]:
    """Per-host journal files in a run directory: every ``*.jsonl``
    whose name contains 'journal' or 'serve' (serving engines journal
    per-process too — ``serve.host0.jsonl`` merges like a training
    journal), sorted; merged outputs excluded so a re-merge is
    idempotent."""
    out = [
        os.path.join(directory, f)
        for f in sorted(os.listdir(directory))
        if f.endswith(".jsonl") and "merged" not in f
        and ("journal" in f or "serve" in f)
    ]
    return out


def _host_of(path: str, records: Sequence[dict], fallback: int) -> int:
    """Host id for one journal: the ``journal.start`` meta wins, then a
    host/proc number in the filename, then the list position."""
    for r in records:
        if r.get("name") == "journal.start":
            for key in ("host", "process", "process_index"):
                if isinstance(r.get(key), int):
                    return r[key]
            break
    m = _HOST_IN_NAME.search(os.path.basename(path))
    if m:
        return int(m.group(1))
    return fallback


def merge(journals: "Sequence[str] | Mapping[int, str]") -> list[dict]:
    """Read every per-host journal, tag each record with ``host``, and
    interleave on the wall clock (monotonic ``t`` is per-process and NOT
    comparable across hosts; ``wall`` is the only shared ordering).

    ``journals`` is a list of paths (host ids inferred) or an explicit
    ``{host_id: path}`` mapping.

    Records pass through untouched apart from the ``host`` tag —
    serving telemetry (``serve.*``, ``slo.*``, ``simulate.drift``)
    keeps every field, so ``tadnn report`` and ``tadnn monitor`` read
    a merged multihost serving journal exactly like a single-host one.
    """
    if isinstance(journals, Mapping):
        items = [(int(h), p) for h, p in sorted(journals.items())]
    else:
        items = [(None, p) for p in journals]
    merged: list[dict] = []
    for idx, (host, path) in enumerate(items):
        records = Journal.read(path)
        hid = host if host is not None else _host_of(path, records, idx)
        for r in records:
            rec = dict(r)
            rec.setdefault("host", hid)
            merged.append(rec)
    merged.sort(key=lambda r: (r.get("wall") or 0.0, r.get("t") or 0.0))
    return merged


def write_merged(records: Sequence[dict], path: str) -> str:
    """Write merged records as JSONL (the shape ``Journal.read`` and
    ``report.generate`` consume)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for r in records:
            f.write(json.dumps(r, default=str) + "\n")
    os.replace(tmp, path)
    return path


def merge_run(directory: str, out: str = "journal.merged.jsonl") -> str:
    """Find, merge and write a run directory's per-host journals.
    Returns the merged file's path (raises when no journals exist)."""
    paths = find_host_journals(directory)
    if not paths:
        raise FileNotFoundError(f"no per-host journals (*.jsonl) in "
                                f"{directory}")
    return write_merged(merge(paths), os.path.join(directory, out))


def host_skew(records: Sequence[dict], *, name: str = "trace.step",
              field: str = "wall_s") -> dict | None:
    """Per-host mean of ``field`` over ``name`` events, plus the skew.

    The headline is ``skew_fraction`` — (slowest - fastest) mean step
    wall over the fastest host's — because under SPMD every collective
    runs at the pace of the slowest participant: a 10% straggler is a
    10% tax on the whole run.  None when fewer than 2 hosts reported.
    """
    by_host: dict[int, list[float]] = {}
    for r in records:
        if r.get("name") != name or "host" not in r:
            continue
        v = r.get(field)
        if isinstance(v, (int, float)):
            by_host.setdefault(int(r["host"]), []).append(float(v))
    if len(by_host) < 2:
        return None
    per_host = {
        h: {"n": len(vs), "mean": sum(vs) / len(vs)}
        for h, vs in sorted(by_host.items())
    }
    means = [v["mean"] for v in per_host.values()]
    fastest, slowest = min(means), max(means)
    return {
        "n_hosts": len(per_host),
        "event": name,
        "field": field,
        "per_host": per_host,
        "fastest": fastest,
        "slowest": slowest,
        "skew": slowest - fastest,
        "skew_fraction": (slowest - fastest) / fastest if fastest else None,
    }
