"""The export cache: what a cold start compiles, kept across processes.

The JAX package serializes the compiled XLA executables of the train
step and of the serving traces, so a restart deserializes in
milliseconds instead of recompiling.  The port compiles no program: it
runs eagerly, and what its cold start pays is the ``nvcc`` build of the
hand-written kernels it launches (``ops/build.py``).  So an entry here
lists those kernel libraries (``lib<name>_<digest>.so``: K1-K3's for a
train step, K4's for the serving kinds) by name, source digest, size and
sha256, each library kept once however many entries point at it, under
the key JAX uses: the parameter signature, the topology fingerprint and
the program blob (the plan, the batch signature, accumulation,
precision, pipeline and sequence settings, the kind and the tags),
through the tuning cache's machinery (``tune/cache.py``).

A hit installs the libraries where ``ops.build.library_path`` looks for
them, so no ``nvcc`` runs; a miss builds only the libraries no live
entry holds yet: ``AutoDistribute(export_cache=...)``'s
``init``, ``ServeEngine(export_cache=...)`` and the launcher's workers
and prewarms go cache-first.  The toolkit, torch and the card are
validated at load, not keyed: an entry from another version or card, a
library whose sources changed in ``csrc/``, or a torn or missing
payload is skipped loudly (``export.stale``), rebuilt from the sources
and overwritten.  CLI: ``tadnn export``.
"""

from .aot import ExportResult, cached_compile
from .cache import (
    ExecutableCache,
    cache_dir,
    env_fingerprint,
    executable_key,
    plan_blob,
    resolve,
)

__all__ = [
    "ExecutableCache",
    "ExportResult",
    "cache_dir",
    "cached_compile",
    "env_fingerprint",
    "executable_key",
    "plan_blob",
    "resolve",
]
