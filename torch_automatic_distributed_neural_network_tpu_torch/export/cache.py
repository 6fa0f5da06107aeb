"""Content-addressed on-disk cache of built kernel libraries.

Layout (root = ``TADNN_EXPORT_CACHE`` or ``~/.cache/tadnn/torch_kernels``)::

    <root>/index.jsonl     append-only keyed records (tune-cache format:
                           {"key": ..., "record": {...}}, last match wins)
    <root>/libs/<env>/lib<name>_<digest>.so
                           each built library once, under a digest of the
                           environment that built it (``env_tag``)

Keys reuse the tuning cache's machinery (``tune.cache.cache_key`` over
params signature x topology fingerprint x a program blob), so a tuner
decision and the libraries its run launches share one fingerprint.  A
record lists the libraries its kind launches (name, file, size, sha256);
it points at them and holds no copy, so entries that launch the same
library (two batch sizes, two plans, K4's two serving kinds) share one
file, and a miss installs a library another live entry already holds
instead of building it again.  The torch, CUDA and ``nvcc`` versions and
the card are deliberately NOT part of the key: they live in the index
record and are VALIDATED at load time, so a version bump or another card
surfaces as a loud ``export.stale`` (skip + rebuild + overwrite) instead
of a silent key miss that leaves dead payloads behind forever.  So does
a library whose source digest (its file name, ``ops.build.library_path``)
no longer matches ``csrc/``, and a library whose bytes disagree with the
record's sha256 or are missing.

The index shares the tune cache's size-capped compaction
(``tune.cache.compact_jsonl``): over the cap, the file is rewritten
last-record-per-key and library files no record points at are deleted.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Mapping, Sequence

import torch

from ..obs import journal as obs_journal
from ..ops import build
from ..tune import cache as tune_cache

_ENV = "TADNN_EXPORT_CACHE"
_ENV_MAX = "TADNN_EXPORT_CACHE_MAX_BYTES"
_DEFAULT_DIR = "~/.cache/tadnn/torch_kernels"
_DEFAULT_INDEX_MAX = 8 * 2**20
_LIBS = "libs"

# index-record env fields validated (not keyed) at load time
_ENV_FIELDS = ("torch", "cuda", "nvcc", "platform", "device_kind",
               "capability", "num_devices")

# libraries whose cached copy would not load in this process: built from
# the sources once, never installed again (two kinds share K4's)
_fell_back: set[str] = set()


def cache_dir(spec: Any = None) -> str | None:
    """Resolve a cache-root spec to a directory path (or None = off).

    - a string: that directory;
    - ``True``: ``TADNN_EXPORT_CACHE`` or the default user cache dir;
    - ``None``: ``TADNN_EXPORT_CACHE`` if set, else off (the opt-in
      default — existing runs see no new files unless asked);
    - ``False``: off, even with the env var set.
    """
    if spec is False:
        return None
    if isinstance(spec, (str, os.PathLike)):
        return os.path.expanduser(str(spec))
    env = os.environ.get(_ENV)
    if env:
        return os.path.expanduser(env)
    if spec is True:
        return os.path.expanduser(_DEFAULT_DIR)
    return None


def resolve(spec: Any = None) -> "ExecutableCache | None":
    """An :class:`ExecutableCache` for the spec, or None when disabled."""
    if isinstance(spec, ExecutableCache):
        return spec
    root = cache_dir(spec)
    return ExecutableCache(root) if root else None


def env_fingerprint() -> dict:
    """What must match for a cached library to be loadable: the torch
    and CUDA versions, the ``nvcc`` release that builds the libraries,
    and the platform, card, compute capability and device count."""
    cuda = torch.cuda.is_available()
    fp: dict[str, Any] = {"torch": torch.__version__,
                          "cuda": torch.version.cuda,
                          "nvcc": build.nvcc_release(),
                          "platform": "cuda" if cuda else "cpu"}
    if cuda:
        index = torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(index)
        fp.update(device_kind=torch.cuda.get_device_name(index),
                  capability=f"{major}.{minor}",
                  num_devices=torch.cuda.device_count())
    else:
        fp.update(device_kind="cpu", capability=None, num_devices=1)
    return fp


def env_tag(env: Mapping) -> str:
    """A digest of the validated fields of an environment: the directory
    its libraries are kept under."""
    return hashlib.sha256(json.dumps(
        [env.get(f) for f in _ENV_FIELDS]).encode()).hexdigest()[:16]


def spec_str(spec: Any) -> str:
    """A PartitionSpec as JAX's ``str`` renders it
    (``PartitionSpec(('data', 'fsdp'),)``, a lone axis bare:
    ``PartitionSpec('data',)``)."""
    return "PartitionSpec" + repr(tuple(
        e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec))


def plan_blob(plan: Any) -> dict:
    """JSON-able identity of a ShardPlan for the cache key: strategy,
    mesh factorization, remat/zero1, and a digest of the full per-param
    spec tree (two plans that shard even one tensor differently are
    separate programs)."""
    specs = sorted(plan.param_specs.items())
    opt = (sorted(plan.opt_spec_tree.items())
           if plan.opt_spec_tree is not None else [])
    digest = hashlib.sha256(json.dumps(
        [[p, str(s)] for p, s in specs + opt]).encode()).hexdigest()[:16]
    return {
        "strategy": plan.strategy,
        "mesh": {a: int(n) for a, n in plan.degrees.items()},
        "batch_spec": spec_str(plan.batch_spec),
        "remat": bool(plan.remat),
        "zero1": bool(plan.zero1),
        "specs": digest,
    }


def executable_key(kind: str, signature: str, topo_fp: Mapping,
                   program: Mapping, tags: Mapping | None = None) -> str:
    """Cache key for one entry: the tune-cache key over (params
    signature, topology fingerprint, {kind, program, tags})."""
    return tune_cache.cache_key(
        signature, topo_fp,
        {"kind": kind, "program": dict(program), "tags": dict(tags or {})})


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def library_manifest(names: Sequence[str]) -> list[dict]:
    """Name, file (its source digest), size and sha256 of each built
    library in ``ops/build``'s directory."""
    out = []
    for name in names:
        path = build.library_path(name)
        data = path.read_bytes()
        out.append({"name": name, "file": path.name, "bytes": len(data),
                    "sha256": _sha256(data)})
    return out


class ExecutableCache:
    """The on-disk cache: index + payload files under one root."""

    def __init__(self, root: str, *, max_index_bytes: int | None = None):
        self.root = os.path.expanduser(root)
        self.index_path = os.path.join(self.root, "index.jsonl")
        if max_index_bytes is None:
            try:
                max_index_bytes = int(os.environ.get(
                    _ENV_MAX, str(_DEFAULT_INDEX_MAX)))
            except ValueError:
                max_index_bytes = _DEFAULT_INDEX_MAX
        self.max_index_bytes = max_index_bytes

    # -- records -------------------------------------------------------------

    def library_file(self, env: Mapping, lib: Mapping) -> str:
        """The path, under the root, of one library of a record whose
        environment is ``env``."""
        return os.path.join(_LIBS, env_tag(env), lib["file"])

    def payload_files(self, rec: Mapping) -> list[str]:
        """The library files a record points at, relative to the root."""
        env = rec.get("env") or {}
        return [self.library_file(env, lib) for lib in rec.get("libs") or ()]

    def lookup(self, key: str) -> dict | None:
        """Latest index record for ``key`` (no liveness check)."""
        return tune_cache.lookup(key, path=self.index_path)

    def entries(self) -> dict[str, dict]:
        """key -> latest record, for every key in the index."""
        out: dict[str, dict] = {}
        if not os.path.isfile(self.index_path):
            return out
        with open(self.index_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("key") is not None:
                    out.pop(rec["key"], None)  # move to last occurrence
                    out[rec["key"]] = rec.get("record") or {}
        return out

    def check_live(self, rec: Mapping) -> str | None:
        """None when the entry is loadable here/now; else the mismatch
        reason (the ``export.stale`` payload)."""
        now = env_fingerprint()
        stored = rec.get("env") or {}
        for field in _ENV_FIELDS:
            a, b = stored.get(field), now.get(field)
            if a != b:
                return f"{field}: cached {a!r} != current {b!r}"
        for lib in rec.get("libs") or ():
            current = build.library_path(lib["name"]).name
            if lib.get("file") != current:
                return (f"source digest: cached {lib.get('file')!r} != "
                        f"current {current!r} (csrc/ changed)")
        for f in self.payload_files(rec):
            if not os.path.isfile(os.path.join(self.root, f)):
                return f"payload file missing: {f}"
        return None

    # -- payloads ------------------------------------------------------------

    def _read(self, env: Mapping, lib: Mapping) -> bytes:
        """One library's bytes, checked against the record's sha256."""
        with open(os.path.join(self.root, self.library_file(env, lib)),
                  "rb") as f:
            data = f.read()
        if _sha256(data) != lib["sha256"]:
            raise ValueError(f"{lib['file']}: sha256 mismatch (torn payload)")
        return data

    def load(self, key: str, rec: Mapping, *,
             check_load: bool | None = None) -> list[dict]:
        """Install an already-validated entry's libraries where
        ``ops.build.library_path`` looks for them (each checked against
        the record's sha256) and return their manifest.  Raises on a
        torn or missing library — callers treat that as stale.
        ``check_load`` (default: on a card) opens each installed library
        with ``ctypes``; one that fails to load journals
        ``export.fallback`` and is built from the sources instead, once a
        process (a later entry holding it keeps the built one)."""
        env = rec.get("env") or {}
        libs = list(rec.get("libs") or ())
        blobs = {lib["name"]: self._read(env, lib) for lib in libs}
        for lib in libs:
            if lib["name"] not in _fell_back:
                _install(build.library_path(lib["name"]), blobs[lib["name"]],
                         lib["sha256"])
        if check_load is None:
            check_load = torch.cuda.is_available()
        if check_load:
            _check_loadable([lib["name"] for lib in libs])
        return libs

    def install_cached(self, names: Sequence[str], *,
                       check_load: bool | None = None) -> list[str]:
        """On a miss: install each named library that is not built yet
        but that a live entry of this environment already holds (its
        file name is the current source digest, its bytes match the
        sha256).  Returns the names installed; the rest need a build."""
        now = env_fingerprint()
        held: dict[str, dict] = {}
        for rec in self.entries().values():
            env = rec.get("env") or {}
            if any(env.get(f) != now.get(f) for f in _ENV_FIELDS):
                continue
            for lib in rec.get("libs") or ():
                held[lib.get("file")] = lib
        done = []
        for name in names:
            path = build.library_path(name)
            lib = held.get(path.name)
            if name in _fell_back or path.exists() or lib is None:
                continue
            try:
                data = self._read(now, lib)
            except (OSError, ValueError):
                continue  # torn or gone: built from the sources
            _install(path, data, lib["sha256"])
            done.append(name)
        if check_load is None:
            check_load = torch.cuda.is_available()
        if check_load and done:
            _check_loadable(done)
        return done

    def store(self, key: str, libraries: Sequence[str], *, kind: str,
              meta: Mapping | None = None) -> dict:
        """Write each named built library under the environment's
        directory (unless the same bytes are there), then append the
        index record that points at them.  Returns the record."""
        env = env_fingerprint()
        libs = library_manifest(libraries)
        for lib in libs:
            _install(os.path.join(self.root, self.library_file(env, lib)),
                     build.library_path(lib["name"]).read_bytes(),
                     lib["sha256"])
        rec = {
            "kind": kind,
            "env": env,
            "created": time.time(),
            "payload_bytes": sum(lib["bytes"] for lib in libs),
            "libs": libs,
            "meta": dict(meta or {}),
        }
        os.makedirs(self.root, exist_ok=True)
        tune_cache.store(key, rec, path=self.index_path, max_bytes=0)
        self._maybe_compact()
        return rec

    def put_record(self, key: str, rec: Mapping) -> None:
        """Append a JSON-only record (no payload) — e.g. cached
        ``cost_analysis`` results riding in the same index."""
        os.makedirs(self.root, exist_ok=True)
        tune_cache.store(key, rec, path=self.index_path, max_bytes=0)
        self._maybe_compact()

    def touch(self, key: str) -> None:
        """Record a cache hit: re-append the entry's record with a
        fresh ``last_hit`` timestamp.  GC evicts by last-hit age, so a
        hot entry stays resident however old its build is."""
        rec = self.lookup(key)
        if rec is None:
            return
        rec = dict(rec)
        rec["last_hit"] = time.time()
        tune_cache.store(key, rec, path=self.index_path, max_bytes=0)
        self._maybe_compact()

    # -- maintenance ---------------------------------------------------------

    def _maybe_compact(self) -> None:
        if not self.max_index_bytes:
            return
        try:
            if os.path.getsize(self.index_path) < self.max_index_bytes:
                return
        except OSError:
            return
        self.compact()

    def _sweep(self, records) -> tuple[int, int]:
        """Delete every library file under ``libs/`` that none of
        ``records`` points at; returns (files removed, bytes freed)."""
        live = {f for rec in records for f in self.payload_files(rec)}
        removed = freed = 0
        top = os.path.join(self.root, _LIBS)
        for dirpath, _, files in os.walk(top, topdown=False):
            for name in files:
                path = os.path.join(dirpath, name)
                if (name.endswith(".tmp")  # another process's install
                        or os.path.relpath(path, self.root) in live):
                    continue
                try:
                    size = os.path.getsize(path)
                    os.remove(path)
                except OSError:
                    continue
                removed += 1
                freed += size
            if dirpath != top:
                try:
                    os.rmdir(dirpath)  # only when empty
                except OSError:
                    pass
        return removed, freed

    def compact(self) -> dict:
        """Dedup-compact the index (tune-cache contract) and delete
        library files no surviving record points at."""
        stats = tune_cache.compact_jsonl(
            self.index_path, max_bytes=self.max_index_bytes)
        stats["orphan_payloads_removed"] = self._sweep(
            self.entries().values())[0]
        obs_journal.event("export.compact", path=self.index_path, **stats)
        return stats

    def gc(self, max_age_s: float) -> dict:
        """Drop every entry neither hit nor created within
        ``max_age_s``, rewrite the index without it and delete the
        library files no kept entry points at (``tadnn export --gc``).
        Age is measured from the latest ``last_hit`` (``touch`` on every
        hit) falling back to ``created``, so anything still being loaded
        survives indefinitely while one-off experiments age out.
        Journals ``export.gc``; returns the stats dict."""
        now = time.time()
        entries = self.entries()
        keep = {key: rec for key, rec in entries.items()
                if now - float(rec.get("last_hit") or rec.get("created")
                               or 0.0) <= max_age_s}
        dropped = len(entries) - len(keep)
        freed = 0
        if dropped and os.path.isfile(self.index_path):
            tmp = f"{self.index_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                for key, rec in keep.items():
                    f.write(json.dumps({"key": key, "record": rec}) + "\n")
            os.replace(tmp, self.index_path)
            freed = self._sweep(keep.values())[1]
        stats = {"scanned": len(entries), "dropped": dropped,
                 "kept": len(keep), "payload_bytes_freed": freed,
                 "max_age_s": max_age_s}
        obs_journal.event("export.gc", path=self.index_path, **stats)
        return stats

    def verify(self) -> list[dict]:
        """Liveness report for every entry: which would load here/now
        and which are stale (``tadnn export --verify``)."""
        out = []
        for key, rec in self.entries().items():
            reason = self.check_live(rec)
            out.append({
                "key": key,
                "kind": rec.get("kind"),
                "created": rec.get("created"),
                "payload_bytes": rec.get("payload_bytes"),
                "live": reason is None,
                "reason": reason,
            })
        return out


def _install(path, data: bytes, sha256: str) -> None:
    """Write a library's bytes to ``path`` atomically, unless the same
    bytes are already there."""
    path = Path(path)
    if path.exists() and _sha256(path.read_bytes()) == sha256:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _check_loadable(names: Sequence[str]) -> None:
    """Open each installed library with ``ctypes``; one that fails is
    journaled once (``export.fallback``) and built from the sources."""
    import ctypes

    for name in names:
        if name in _fell_back:
            continue
        path = build.library_path(name)
        try:
            ctypes.CDLL(str(path))
        except OSError as e:
            obs_journal.event("export.fallback", fn=f"lib{name}",
                              error=f"{type(e).__name__}: {e}")
            _fell_back.add(name)
            path.unlink(missing_ok=True)
            build.build([name])

