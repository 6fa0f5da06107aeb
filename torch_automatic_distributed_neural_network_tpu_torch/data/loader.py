"""Token-corpus data loader with a native C++ fast path (the JAX
package's ``data/loader.py``; batches bit-identical to its).

- a flat binary token-file format ("TADN" v1: header + little-endian
  uint16/uint32 tokens) written by :func:`write_token_file`;
- :class:`TokenFileDataset`, step-indexed (Trainer protocol) so a
  resumed run replays identical batches — window ``w`` of epoch ``e``
  maps through a deterministic affine shuffle ``(a_e * w + c_e) %
  n_windows`` seeded by splitmix64;
- a **native C++ backend** (``csrc/tadnn_loader.cpp``, the package's own
  copy of the JAX package's ``native/tadnn_loader.cpp``): mmap +
  background prefetch thread, compiled with ``g++`` at first use into the
  directory the CUDA kernels build to (``ops/build.py``: ``build/
  torch_kernels/`` in a checkout), keyed by a digest of the source, and
  bound with ctypes.  The pure-numpy fallback implements the identical
  determinism contract, so the backend is a pure speed choice.

Per-host input sharding: :func:`shard_for_host` slices a global batch
to this process's rows and marks them (:class:`HostBatch`), which
``AutoDistribute.step`` then takes as they are.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from typing import Any

import numpy as np
import torch

from ..utils.device import process_count as _process_count
from ..utils.device import process_index as _process_index
from ..utils.device import resolve_device

_MAGIC = 0x4E444154  # "TADN"
_HEADER = np.dtype([
    ("magic", "<u4"), ("version", "<u4"), ("dtype_bytes", "<u4"),
    ("pad", "<u4"), ("n_tokens", "<u8"),
])

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "tadnn_loader.cpp",
)
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _so_target() -> str:
    """Where the loader builds to: the kernels' build directory, the
    file name keyed by the source and the flags, so an edited source is
    rebuilt and a stale library never loaded."""
    from ..ops.build import BUILD_DIR

    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return str(BUILD_DIR / f"libtadnn_loader_{h.hexdigest()[:16]}.so")

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class TokenFileWriter:
    """Streaming TADN v1 writer: append token chunks in bounded memory.

    Writes the header with a zero count up front, streams every
    ``append`` straight to disk, and patches ``n_tokens`` on close — so
    tokenizing a corpus much larger than RAM never concatenates it
    in-memory (data/text.py rides this).
    """

    def __init__(self, path: str, dtype=np.uint32):
        dtype = np.dtype(dtype)
        if dtype not in (np.dtype(np.uint16), np.dtype(np.uint32)):
            raise ValueError(f"TADN dtype must be uint16/uint32, got {dtype}")
        self._dtype = dtype
        self.n_tokens = 0
        self._f = open(path, "wb")
        self._write_header()

    def _write_header(self) -> None:
        header = np.zeros((), _HEADER)
        header["magic"] = _MAGIC
        header["version"] = 1
        header["dtype_bytes"] = self._dtype.itemsize
        header["n_tokens"] = self.n_tokens
        self._f.write(header.tobytes())

    def append(self, tokens) -> None:
        tokens = np.asarray(tokens).ravel()
        if tokens.size == 0:
            return
        lo, hi = int(tokens.min()), int(tokens.max())
        if lo < 0:
            raise ValueError("tokens must be non-negative")
        # batch() hands out int32 buffers (the token dtype); an
        # id >= 2^31 would silently wrap negative on read.
        limit = min(2**31, 2 ** (8 * self._dtype.itemsize))
        if hi >= limit:
            limit_str = "2**31" if limit == 2**31 else str(limit)
            raise ValueError(
                f"token id {hi} >= {limit_str} does not fit the file "
                f"dtype {self._dtype.name} / the loader's int32 batches"
            )
        self._f.write(tokens.astype(self._dtype).tobytes())
        self.n_tokens += int(tokens.size)

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.seek(0)
        self._write_header()  # patch the real count
        self._f.close()

    def __enter__(self) -> "TokenFileWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a TADN v1 token file; dtype picked from the token range."""
    tokens = np.asarray(tokens).ravel()
    dtype = np.uint16 if (
        tokens.size == 0 or int(tokens.max()) < 2**16) else np.uint32
    with TokenFileWriter(path, dtype=dtype) as w:
        w.append(tokens)


_build_lock = threading.Lock()
_lib: Any = None
_lib_failed = False


def _native_lib() -> Any | None:
    """Compile (once) and load the native loader; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            # inside the try: an unwritable build dir must mean 'native
            # unavailable' (numpy fallback), not a crash
            so = _so_target()
            if not os.path.exists(so):
                # compile to a private temp path, then atomically publish:
                # concurrent processes each build their own temp and the
                # last os.replace wins — no half-written .so is visible
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_GXX_FLAGS, _SOURCE, "-o", tmp],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.tadnn_loader_open.restype = ctypes.c_void_p
            lib.tadnn_loader_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_int,
            ]
            lib.tadnn_loader_n_windows.restype = ctypes.c_int64
            lib.tadnn_loader_n_windows.argtypes = [ctypes.c_void_p]
            lib.tadnn_loader_batch.restype = ctypes.c_int
            lib.tadnn_loader_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.tadnn_loader_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib_failed = True
    return _lib


class TokenFileDataset:
    """Step-indexed LM batches from a TADN token file.

    ``batch(i)`` -> ``{"input_ids": int32 [batch, seq_len+1]}`` — the
    ``seq_len+1`` window feeds next_token_loss's shift.  ``backend`` is
    'auto' (native if it builds, else numpy), 'native' (error if the C++
    loader is unavailable) or 'numpy'.

    ``device``: the device the batches feed (default ``cuda``, raising
    without it; ``cpu`` for a CPU run).  For a card each batch is a
    numpy view of pinned host memory, which the step copies to the card
    by DMA.
    """

    step_indexed = True  # Trainer protocol: .batch(i) is keyed by step

    def __init__(
        self,
        path: str,
        seq_len: int,
        batch_size: int,
        *,
        seed: int = 0,
        backend: str = "auto",
        prefetch: int = 4,
        device=None,
    ):
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(
                f"backend must be 'auto', 'native' or 'numpy', got {backend!r}"
            )
        self.device = resolve_device(device)
        self.path = path
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed & _MASK64

        header_arr = np.fromfile(path, dtype=_HEADER, count=1)
        if (
            header_arr.size != 1
            or header_arr[0]["magic"] != _MAGIC
            or header_arr[0]["version"] != 1
            or header_arr[0]["dtype_bytes"] not in (2, 4)
        ):
            raise ValueError(f"{path} is not a TADN v1 token file")
        header = header_arr[0]
        self.n_tokens = int(header["n_tokens"])
        self._dtype = np.uint16 if header["dtype_bytes"] == 2 else np.uint32
        if self.n_tokens < seq_len + 1:
            raise ValueError(
                f"{path}: {self.n_tokens} tokens < one window ({seq_len + 1})"
            )
        self.n_windows = (self.n_tokens - 1) // seq_len

        self._handle = None
        self._tokens = None
        lib = _native_lib() if backend in ("auto", "native") else None
        if lib is not None:
            self._handle = lib.tadnn_loader_open(
                path.encode(), seq_len, batch_size, self.seed, prefetch
            )
        if backend == "native" and not self._handle:
            raise RuntimeError("native loader unavailable (g++ build failed?)")
        if not self._handle:
            self._tokens = np.memmap(
                path, dtype=self._dtype, mode="r",
                offset=_HEADER.itemsize, shape=(self.n_tokens,),
            )

    @property
    def backend(self) -> str:
        return "native" if self._handle else "numpy"

    def _epoch_params(self, epoch: int) -> tuple[int, int]:
        s = _splitmix64(
            (self.seed ^ ((epoch * 0x5851F42D4C957F2D + 1) & _MASK64))
            & _MASK64
        )
        a = (_splitmix64(s) % self.n_windows) | 1
        while np.gcd(a, self.n_windows) != 1:
            a += 2
        a = a % self.n_windows or 1
        c = _splitmix64((s + 1) & _MASK64) % self.n_windows
        return a, c

    def _window_start(self, global_row: int) -> int:
        epoch, w = divmod(global_row, self.n_windows)
        a, c = self._epoch_params(epoch)
        return ((a * w + c) % self.n_windows) * self.seq_len

    def batch(self, step: int) -> dict:
        width = self.seq_len + 1
        # int32 buffer filled in place (tokens < 2^31, so the uint32 view
        # the native side writes through is layout-identical — no copy)
        out = torch.empty((self.batch_size, width), dtype=torch.int32,
                          pin_memory=self.device.type == "cuda").numpy()
        if self._handle:
            rc = _native_lib().tadnn_loader_batch(
                self._handle, step,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            )
            if rc != 0:
                raise RuntimeError(f"native loader failed at step {step}")
        else:
            for r in range(self.batch_size):
                start = self._window_start(step * self.batch_size + r)
                out[r] = self._tokens[start:start + width]
        if self._dtype is np.uint32 and out.min() < 0:
            # a uint32 id >= 2^31 wrapped negative through the int32 view
            # (file written by a foreign tool — write_token_file rejects
            # such ids at write time)
            raise ValueError(
                f"{self.path}: token id >= 2**31 at step {step} does not "
                "fit the loader's int32 batches"
            )
        return {"input_ids": out}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def close(self) -> None:
        if self._handle:
            _native_lib().tadnn_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class HostBatch(dict):
    """A batch that holds this process's rows only (:func:`shard_for_host`).
    ``AutoDistribute.step`` and ``eval_step`` take it as it is; a plain
    mapping is the global batch, of which every rank keeps its rows."""


_BATCH_AXES = ("data", "fsdp", "expert")  # the planner's batch spec order


def shard_for_host(batch: dict, *, process_index: int | None = None,
                   process_count: int | None = None,
                   mesh: Any = None) -> HostBatch:
    """Slice a global batch to this process's rows (the multi-process
    input path, the JAX package's ``shard_for_host``).

    Without ``mesh``: part ``process_index`` of ``process_count`` equal
    parts, as in the JAX package (default: this process's rank and the
    world size; one process keeps the whole batch).  That is right when
    every process sits on the batch axes (dp, fsdp, a hybrid of the
    two).  With ``mesh`` (a plan's ``DeviceMesh``): the rows of this
    rank's coordinate on the batch axes, data-major, which
    ``Execution.local_rows`` picks from a global batch.  Under a tensor
    axis the ranks of one tensor group then hold the same rows (one
    device a process, where a JAX host feeds all of its devices)."""
    if mesh is not None:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        axes = [a for a in _BATCH_AXES if sizes.get(a, 1) > 1]
        pc = math.prod(sizes[a] for a in axes)
        pi = 0
        for a in axes:
            pi = pi * sizes[a] + mesh.get_local_rank(a)
    else:
        pi = _process_index() if process_index is None else process_index
        pc = _process_count() if process_count is None else process_count
    if pc == 1:
        return HostBatch(batch)

    def slc(x):
        n = x.shape[0]
        if n % pc:
            raise ValueError(f"batch dim {n} not divisible by {pc} hosts")
        per = n // pc
        return x[pi * per:(pi + 1) * per]

    return HostBatch({k: slc(v) for k, v in batch.items()})
