"""Persistent tuning cache: (param signature, topology fingerprint,
policy) -> winning plan, as append-only JSONL.

Default location ``~/.cache/tadnn/tune_cache.jsonl``; override with the
``TADNN_TUNE_CACHE`` env var (point different jobs at different files,
or at /dev/null-ish paths in hermetic CI).  Append-only with
last-match-wins semantics — concurrent writers at worst duplicate a
line, they never corrupt a decision.

The key hashes everything a decision depends on, so any change —
different model shapes, different device count/kind/slicing, different
search policy — misses cleanly instead of replaying a stale plan.

Size cap: append-only means unbounded growth on long-lived machines.
``TADNN_TUNE_CACHE_MAX_BYTES`` (same contract as the journal's
``TADNN_JOURNAL_MAX_BYTES``, default off) caps the file: when an
append crosses the cap, :func:`compact_jsonl` rewrites it keeping only
the LAST record per key (the record ``lookup`` would return anyway),
then sheds oldest-first if still over.

The PyTorch package's copy of the JAX package's ``tune/cache.py``.
:func:`params_signature` digests the port's parameter names (``layers.0.
attn.q_proj.weight``), shapes and torch dtypes, so a port key never
equals the JAX package's key for the same model: the two packages keep
their decisions apart even when they share a cache file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Mapping

from .. import planner
from .. import topology as topo_mod

_ENV = "TADNN_TUNE_CACHE"
_ENV_MAX = "TADNN_TUNE_CACHE_MAX_BYTES"
_DEFAULT = "~/.cache/tadnn/tune_cache.jsonl"


def cache_path(path: str | None = None) -> str:
    return os.path.expanduser(path or os.environ.get(_ENV) or _DEFAULT)


def _env_max_bytes() -> int:
    try:
        return int(os.environ.get(_ENV_MAX, "0"))
    except ValueError:
        return 0


def params_signature(abstract_params: Mapping[str, Any]) -> str:
    """Stable digest of the abstract parameters (names, shapes, dtypes)."""
    entries = sorted(
        (
            name,
            list(planner._shape(leaf)),
            planner._dtype_name(getattr(leaf, "dtype", "float32")),
        )
        for name, leaf in abstract_params.items()
    )
    digest = hashlib.sha256(
        json.dumps(entries, sort_keys=True).encode()
    )
    return digest.hexdigest()[:16]


def topology_fingerprint(topo: topo_mod.Topology) -> dict:
    fp = {
        "num_devices": topo.num_devices,
        "num_hosts": topo.num_hosts,
        "platform": topo.platform,
        "device_kind": topo.device_kind,
        "num_slices": topo.num_slices,
    }
    if topo.chip_override is not None:
        # what-if sweeps may override interconnect numbers per topology
        # (topology.parse_topology dcn_* args) — a swept variant must
        # never replay a decision cached under the datasheet chip
        fp["chip_override"] = dataclasses.asdict(topo.chip_override)
    return fp


def cache_key(
    signature: str, topo_fp: Mapping, policy: Mapping | Any
) -> str:
    if dataclasses.is_dataclass(policy) and not isinstance(policy, type):
        policy = dataclasses.asdict(policy)
    blob = json.dumps(
        {"params": signature, "topology": dict(topo_fp),
         "policy": {k: list(v) if isinstance(v, tuple) else v
                    for k, v in dict(policy).items()}},
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def lookup(key: str, path: str | None = None) -> dict | None:
    """Latest cached record for ``key``, or None."""
    p = cache_path(path)
    if not os.path.isfile(p):
        return None
    hit = None
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn concurrent write — skip the line
            if rec.get("key") == key:
                hit = rec.get("record")
    return hit


def store(key: str, record: Mapping, path: str | None = None,
          max_bytes: int | None = None) -> str:
    """Append a decision; returns the file written.

    ``max_bytes`` caps the file via :func:`compact_jsonl` (None reads
    ``TADNN_TUNE_CACHE_MAX_BYTES``; 0 disables — callers with their own
    compaction schedule pass 0).
    """
    p = cache_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "a") as f:
        f.write(json.dumps({"key": key, "record": dict(record)}) + "\n")
    cap = _env_max_bytes() if max_bytes is None else max_bytes
    if cap:
        try:
            over = os.path.getsize(p) >= cap
        except OSError:
            over = False
        if over:
            compact_jsonl(p, max_bytes=cap)
    return p


def compact_jsonl(path: str, max_bytes: int = 0) -> dict:
    """Dedup-compact an append-only keyed JSONL file in place.

    Keeps the LAST record per key (last-match-wins semantics preserved
    bit-for-bit: every surviving key still resolves to the same record
    ``lookup`` returned before), ordered by last occurrence; torn lines
    are dropped.  If the result still exceeds ``max_bytes`` (when
    nonzero), oldest entries are shed first.  Atomic (tmp +
    ``os.replace``), so a concurrent reader sees either generation,
    never a torn file.  Returns compaction stats.
    """
    if not os.path.isfile(path):
        return {"before_bytes": 0, "after_bytes": 0, "kept": 0,
                "dropped": 0}
    before = os.path.getsize(path)
    last: dict[str, str] = {}  # key -> raw line, in last-occurrence order
    total = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn write — compaction discards it
            if not isinstance(rec, dict) or rec.get("key") is None:
                continue
            total += 1
            last.pop(rec["key"], None)  # re-insert at the end
            last[rec["key"]] = line
    lines = list(last.values())
    dropped = total - len(lines)
    if max_bytes:
        size = sum(len(ln) + 1 for ln in lines)
        while lines and size > max_bytes:
            size -= len(lines[0]) + 1
            lines.pop(0)
            dropped += 1
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    os.replace(tmp, path)
    return {"before_bytes": before, "after_bytes": os.path.getsize(path),
            "kept": len(lines), "dropped": dropped}
