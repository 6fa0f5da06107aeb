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
parallel, one ``nvcc`` each (:func:`build`).

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


def build(names: list[str], *, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every named source that has no current library, all
    ``nvcc`` processes started together.  Returns each name's compiler
    output (empty for a library that was already built).  Raises with
    the compiler's message if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
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
