"""Build and load the package's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (it
may include headers of ``csrc/``, such as ``sm90_common.cuh``).  It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library at
first use, and loaded with ``ctypes``.  In a checkout the libraries
go to ``build/torch_kernels/`` at its root; an installed copy (no
``pyproject.toml`` beside the package) uses PyTorch's extensions cache
instead (``$TORCH_EXTENSIONS_DIR``, else ``~/.cache/torch_extensions``),
since its own directory may not be writable.  The library's file name
carries a digest of the source, the ``csrc/`` headers it includes and
the flags, so an edited source or header is rebuilt and a stale library
is never loaded.  Several sources build in
parallel, one ``nvcc`` each (:func:`build`).  :func:`set_build_dir`
points a process's builds elsewhere (``topology.
enable_compilation_cache``: a persistent directory shared by runs), and
``nvcc_invocations`` counts the ``nvcc`` processes this module started,
so a start whose libraries came from the export cache (``export/``)
can show that it compiled nothing.

``torch.utils.cpp_extension.load`` would compile PyTorch's headers into
every build; the plain C interface keeps each build to one short
``nvcc`` (``time_kernel_build.py`` at the root of a checkout times both
routes on the card).

Nothing here runs at import time: the CPU tests import every module,
and a machine without ``nvcc`` never reaches this code unless a kernel
is launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
if (_ROOT / "pyproject.toml").exists():
    BUILD_DIR = _ROOT / "build" / "torch_kernels"
else:
    BUILD_DIR = Path(os.environ.get("TORCH_EXTENSIONS_DIR") or Path.home()
                     / ".cache" / "torch_extensions") / "tadnn_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
nvcc_invocations = 0  # nvcc processes started by this module


def set_build_dir(path) -> Path:
    """Build to and load from ``path`` in this process (made at the first
    build); returns it."""
    global BUILD_DIR
    BUILD_DIR = Path(os.path.expanduser(str(path)))
    return BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, not under CUDA_HOME): the CUDA "
            "kernels are built from csrc/ at first use and need the CUDA "
            "toolkit")
    return path


_release = None


def nvcc_release() -> str | None:
    """The CUDA toolkit's release that ``nvcc`` builds with, read without
    starting ``nvcc``: ``version.json``'s ``cuda_nvcc`` beside its
    ``bin/``, else ``CUDA_VERSION`` of the toolkit's ``include/cuda.h``
    (major.minor); ``nvcc --version`` only where neither is there.  None
    without a toolkit."""
    global _release, nvcc_invocations
    if _release is None:
        try:
            nvcc = _nvcc()
        except RuntimeError:
            return None
        root = Path(nvcc).resolve().parent.parent
        try:
            _release = json.loads((root / "version.json").read_text())[
                "cuda_nvcc"]["version"]
        except (OSError, ValueError, KeyError, TypeError):
            try:
                m = re.search(rb"#define\s+CUDA_VERSION\s+(\d+)",
                              (root / "include" / "cuda.h").read_bytes())
            except OSError:
                m = None
            if m:
                v = int(m.group(1))
                _release = f"{v // 1000}.{v % 1000 // 10}"
            else:
                nvcc_invocations += 1
                out = subprocess.run([nvcc, "--version"],
                                     capture_output=True, text=True).stdout
                m = re.search(r"V(\d+\.\d+\.\d+)", out)
                _release = m.group(1) if m else out.strip()[-40:]
    return _release


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every ``csrc/`` header it includes, at any depth."""
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _LOCAL_INCLUDE.findall(seen[path]):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source, included
    headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in _sources(CSRC_DIR / f"{name}.cu", {}).items():
        h.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str], *, ptxas_verbose: bool = False,
          force: bool = False) -> dict[str, str]:
    """Compile every named source that has no current library (``force``:
    every named source), all ``nvcc`` processes started together.
    Returns each name's compiler output (empty for a library that was
    already built).  Raises with the compiler's message if any build
    fails."""
    global nvcc_invocations
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
        nvcc_invocations += 1
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
            continue
        # publish atomically: a concurrent build never sees a torn file
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
