"""Cache-first kernel builds: hit -> install the cached libraries,
miss -> build them with ``nvcc``, pack, store.

``cached_compile`` is the one entry point every wired-in site uses
(``AutoDistribute.init`` / ``export_step``, ``ServeEngine.__init__``,
the launcher's prewarm, ``tadnn export``).  The journal tells the whole
story per call:

- ``export.hit``    the libraries installed in ``deserialize_s`` (the
  cold-start win: a copy and a sha256 against an ``nvcc`` build);
- ``export.miss``   key not present, paying the build of each library
  no other live entry holds (those are installed from the cache);
- ``export.stale``  key present but the torch/CUDA/``nvcc`` versions or
  the card moved on, a library's sources changed, or the payload is
  torn or missing — skipped LOUDLY, rebuilt from ``csrc/`` and
  overwritten;
- ``export.store``  fresh libraries packed (``compile_s``,
  ``payload_bytes``);
- ``export.error``  the build itself failed — nothing is cached, and the
  kernels build at their first launch as without a cache;
- ``export.fallback`` a cached library that ``ctypes`` would not load —
  built from the sources instead (``ExecutableCache.load``).

A "compile" is the ``nvcc`` build of the kind's kernel sources through
``ops.build.build``; a kind that launches no kernel (the CPU, a model
without attention) stores an entry with an empty manifest.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

from ..obs import journal as obs_journal
from ..ops import build
from . import cache as cache_mod

# sources rebuilt for a stale entry in this process: a source two stale
# kinds share (K4's, for serve_decode and serve_prefill) builds once
_rebuilt: set[str] = set()


@dataclasses.dataclass
class ExportResult:
    """Outcome of one cache-first build."""

    key: str
    kind: str
    source: str  # "hit" (installed from the cache) | "compile" (built)
    compiled: Any  # the libraries' manifest
    compile_s: float | None = None
    deserialize_s: float | None = None
    payload_bytes: int | None = None
    stale_reason: str | None = None

    def to_json(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name != "compiled"}
        return {k: v for k, v in out.items() if v is not None}


def cached_compile(libraries: Sequence[str], *,
                   cache: "cache_mod.ExecutableCache | None",
                   kind: str, key: str) -> ExportResult | None:
    """Install-or-build the kernel libraries of one kind.

    ``libraries`` are ``csrc/`` source names (``flash_attention_sm90``).
    Returns None when the build fails — nothing lands in the cache and
    the kernels build at their first launch, as without a cache."""
    libraries = list(libraries)
    stale_reason = None
    if cache is not None:
        rec = cache.lookup(key)
        if rec is None:
            obs_journal.event("export.miss", kind=kind, key=key)
        else:
            reason = cache.check_live(rec)
            if reason is None:
                t0 = time.perf_counter()
                try:
                    libs = cache.load(key, rec)
                except Exception as e:
                    reason = f"deserialize failed: {type(e).__name__}: {e}"
                else:
                    dt = time.perf_counter() - t0
                    obs_journal.event(
                        "export.hit", kind=kind, key=key, deserialize_s=dt,
                        payload_bytes=rec.get("payload_bytes"))
                    try:
                        cache.touch(key)  # GC retention runs on last hit
                    except OSError:
                        pass  # read-only cache dir: hit still served
                    return ExportResult(
                        key, kind, "hit", libs, deserialize_s=dt,
                        payload_bytes=rec.get("payload_bytes"))
            stale_reason = reason
            obs_journal.event("export.stale", kind=kind, key=key,
                              reason=reason)
    t0 = time.perf_counter()
    try:
        todo = libraries
        if stale_reason is None and cache is not None:
            # a library another live entry holds is installed, not built
            installed = cache.install_cached(libraries)
            todo = [n for n in libraries if n not in installed]
        if todo:
            # a stale entry is rebuilt from the sources, never reused
            fresh = [n for n in todo if n not in _rebuilt]
            if stale_reason is not None and fresh:
                build.build(fresh, force=True)
                _rebuilt.update(fresh)
            build.build(todo)
        libs = cache_mod.library_manifest(libraries)
    except Exception as e:
        obs_journal.event("export.error", kind=kind, key=key,
                          error=f"{type(e).__name__}: {e}")
        return None
    compile_s = time.perf_counter() - t0
    res = ExportResult(key, kind, "compile", libs, compile_s=compile_s,
                       stale_reason=stale_reason)
    if cache is not None:
        try:
            rec = cache.store(key, libraries, kind=kind,
                              meta={"compile_s": compile_s})
        except Exception as e:
            # a read-only cache dir must not take down the run — the
            # build already succeeded
            obs_journal.event("export.error", kind=kind, key=key,
                              error=f"store failed: "
                                    f"{type(e).__name__}: {e}")
        else:
            res.payload_bytes = rec.get("payload_bytes")
            obs_journal.event(
                "export.store", kind=kind, key=key, compile_s=compile_s,
                payload_bytes=rec.get("payload_bytes"),
                file=",".join(cache.payload_files(rec)))
    return res
