"""Per-process sharded checkpointing with resharding restore (the JAX
package's ``training/shards.py``, in its layout).

``CheckpointManager`` (checkpoint.py) coordinates its saves: every rank
takes part in one logical save.  The launcher needs the opposite
discipline — **barrier-free** per-process saves — so a straggler or a
SIGKILLed process can never leave a torn step the others believe
committed.  This module implements that format:

- ``<dir>/<step>/meta.json``: written by host 0 at dispatch; records the
  expected world size, the mesh degrees, every leaf's global shape,
  dtype and spec (``planner.spec_to_json``), and the run config;
- ``<dir>/<step>/host-<i>.npz``: process *i*'s replica-0 shards (the
  raw bytes of each, so a bf16 leaf keeps its bits: numpy has no
  bf16), written off the training thread, fsynced and renamed into
  place;
- ``<dir>/<step>/host-<i>.json``: process *i*'s completion marker — the
  shard index plus the sha256 of the npz — written only after the npz
  is durable.  **A step is committed iff meta.json and every expected
  host marker exist**; no barrier runs at save time, the completion
  predicate is evaluated at restore time instead.

A process's shards of a leaf are read off the leaf itself: a plain
tensor is replicated (process 0 writes it whole); a ``DTensor`` of a
plan writes its local shard where its coordinate is 0 on every mesh dim
that replicates it, at the global offset its placements give.  Under a
pipeline a process holds another stage's layers as meta tensors (never
written), and the state marks which of its leaves it persists
(``_tadnn_persist``: the owning stage's, the replicated ones on stage 0).  The
spec recorded in ``meta.json`` names, per dim, the mesh axes of degree
above 1 that shard it.

Restore is resharding-first: the shards of every process are
reassembled into whole host arrays, then each live leaf takes its own
slice (a ``DTensor`` its local shard's box), so a step written under dp
on 4 processes restores under fsdp on 2, under dp + ZeRO-1 on 4, and on
one process.  Integrity extends the fallback chain: markers carry the
npz sha256s, coverage is checked against ``planner.leaf_shard_slices``,
and a torn shard quarantines the step (``<step>.corrupt`` and a
``ckpt.corrupt`` journal event) so ``restore_or_init`` falls back one
save interval.

:class:`ShardedCheckpoint` implements the ``CheckpointManager`` protocol
(save / restore into the live state / latest_step / quarantine / wait),
so the Trainer and ``restore_or_init`` drive it unchanged.  Its
logical-host mode (``host=``/``world=`` in one process) is the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..obs import journal as obs_journal
from ..utils.device import (
    group_up,
    host_allgather,
    is_dtensor,
    local_shard,
    process_count,
    process_index,
)
from . import resilience

SHARD_FORMAT_VERSION = 1

_META = "meta.json"

# numpy storage of each torch dtype: the bytes are kept, never the values
_NP_STORAGE = {
    "float32": np.float32, "float64": np.float64, "float16": np.float16,
    "bfloat16": np.uint16, "int64": np.int64, "int32": np.int32,
    "int16": np.int16, "int8": np.int8, "uint8": np.uint8, "bool": np.bool_,
}


def _host_npz(i: int) -> str:
    return f"host-{int(i)}.npz"


def _host_marker(i: int) -> str:
    return f"host-{int(i)}.json"


def _fsync_write(path: str, data: bytes) -> None:
    """Write ``data`` durably: tmp file, flush+fsync, rename into place,
    fsync the directory so the rename itself is durable."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _leaf_owner(path: str, world: int) -> int:
    """Stable owner host of a leaf in logical-host mode — a pure hash of
    the leaf path (no Python hash randomization), so every host and
    every restart partitions the tree identically."""
    h = hashlib.blake2b(path.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") % max(int(world), 1)


def _mesh_axes(t: torch.Tensor) -> dict[str, int]:
    """The named mesh axes of a ``DTensor`` and their degrees."""
    if not is_dtensor(t):
        return {}
    mesh = t.device_mesh
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _spec_of(t: torch.Tensor) -> list:
    """The leaf's spec in ``planner.spec_to_json`` form: per dim, the
    mesh axes of degree above 1 that shard it (mesh order)."""
    if not is_dtensor(t):
        return []
    sizes = _mesh_axes(t)
    dims: list = [None] * t.dim()
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard() and sizes[name] > 1:
            d = pl.dim
            dims[d] = name if dims[d] is None else (
                [*dims[d], name] if isinstance(dims[d], list)
                else [dims[d], name])
    while dims and dims[-1] is None:
        dims.pop()
    return dims


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, str(int(step)))


def read_meta(directory: str, step: int) -> dict | None:
    try:
        with open(os.path.join(step_dir(directory, step), _META)) as f:
            meta = json.load(f)
        if not isinstance(meta.get("leaves"), dict):
            return None
        return meta
    except (OSError, ValueError):
        return None


def is_complete(directory: str, step: int) -> bool:
    """The barrier-free completion predicate: meta + every expected
    host's marker + shard file present.  A host that died mid-write left
    no marker, so the step simply never commits — nothing to roll back."""
    meta = read_meta(directory, step)
    if meta is None:
        return False
    d = step_dir(directory, step)
    for i in range(int(meta.get("world", 0))):
        if not (os.path.isfile(os.path.join(d, _host_marker(i)))
                and os.path.isfile(os.path.join(d, _host_npz(i)))):
            return False
    return True


def list_complete_steps(directory: str) -> list[int]:
    return [s for s in resilience.list_steps(directory)
            if is_complete(directory, s)]


def _read_markers(directory: str, step: int, world: int) -> list[dict]:
    d = step_dir(directory, step)
    markers = []
    for i in range(world):
        with open(os.path.join(d, _host_marker(i))) as f:
            markers.append(json.load(f))
    return markers


def verify_step(directory: str, step: int) -> list[str]:
    """Problems (empty = verified) for one committed sharded step:
    markers parse, shard-file sha256s match, and the recorded slices
    tile every leaf exactly as the writer's spec says they should
    (``planner.leaf_shard_slices`` — the reshard-slicing contract)."""
    from .. import planner

    meta = read_meta(directory, step)
    if meta is None:
        return ["missing or torn meta.json"]
    problems: list[str] = []
    d = step_dir(directory, step)
    try:
        markers = _read_markers(directory, step, int(meta["world"]))
    except (OSError, ValueError, KeyError) as e:
        return [f"missing/torn host marker: {type(e).__name__}: {e}"]
    covered: dict[str, set] = {}
    for m in markers:
        npz = os.path.join(d, _host_npz(int(m["host"])))
        try:
            digest = _sha256_file(npz)
        except OSError as e:
            problems.append(f"host {m['host']}: unreadable shard file "
                            f"({e})")
            continue
        if digest != m.get("sha256"):
            problems.append(f"host {m['host']}: shard file checksum "
                            "mismatch (torn write?)")
        for s in m.get("shards", ()):
            covered.setdefault(s["leaf"], set()).add(
                tuple((int(a), int(b)) for a, b in s["index"]))
    degrees = meta.get("degrees") or {}
    for path, info in meta["leaves"].items():
        want = set(
            planner.leaf_shard_slices(
                info["shape"], planner.spec_from_json(info.get("spec", [])),
                degrees,
            )
        )
        got = covered.get(path, set())
        if got != want:
            problems.append(
                f"leaf {path}: shard coverage mismatch "
                f"({len(got)} recorded vs {len(want)} expected slices)"
            )
    return problems


def verify_directory(directory: str) -> dict:
    """Sharded-format twin of ``resilience.verify_directory`` — same
    report shape, so ``resilience.format_doctor`` renders it."""
    steps = resilience.list_steps(directory)
    chain = []
    for s in reversed(steps):
        if not is_complete(directory, s):
            chain.append({"step": int(s), "ok": False, "verified": False,
                          "problems": ["incomplete (missing host marker "
                                       "— straggler or dead host)"]})
            continue
        problems = verify_step(directory, s)
        chain.append({"step": int(s), "ok": not problems,
                      "verified": not problems, "problems": problems})
    quarantined = sorted(
        name for name in (os.listdir(directory)
                          if os.path.isdir(directory) else [])
        if ".corrupt" in name and os.path.isdir(os.path.join(directory, name))
    )
    best = next((v["step"] for v in chain if v["ok"]), None)
    return {
        "directory": os.path.abspath(directory),
        "steps": chain,
        "quarantined": quarantined,
        "healthy": best is not None,
        "best_step": best,
    }


# package-level alias: training.verify_sharded_directory (the unsuffixed
# name collides with resilience.verify_directory in training/__init__)
verify_sharded_directory = verify_directory


def tear_shard(directory: str, step: int, host: int = 0) -> bool:
    """Chaos fault: truncate one host's shard file of a committed step in
    place — what a crash between the array write and the fsync leaves.
    The marker still carries the intact file's sha256, so verification
    catches it and the step quarantines."""
    path = os.path.join(step_dir(directory, step), _host_npz(host))
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 3)
        return True
    except OSError:
        return False


@dataclasses.dataclass
class _SaveJob:
    step: int
    host: int
    arrays: dict  # npz key -> host tensor (its bytes are written)
    marker: dict
    submitted: float


class ShardedCheckpoint:
    """Barrier-free per-process sharded checkpoints (module docstring).

    CheckpointManager-protocol compatible: ``restore_or_init`` and the
    Trainer drive it unchanged.  ``save`` copies this process's
    replica-0 shards to host memory (the step updates its state in
    place) and hands the npz, the hash and the marker to a background
    thread; ``wait()`` drains it.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 integrity: bool = True, host: int | None = None,
                 world: int | None = None):
        """``host``/``world`` default to the process's rank and the world
        size (a real process group).  Set explicitly in a single process
        they give **logical-host mode**, as in the JAX package: each
        process computes the whole deterministic trajectory alone but
        persists only the leaves it owns (a stable hash of the leaf path
        mod world), so the cross-process completion and integrity
        protocol runs for real without collectives."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.integrity = integrity
        self._host = host
        self._world = world
        os.makedirs(self.directory, exist_ok=True)
        self._q: "queue.Queue[_SaveJob | None]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._closed = False

    @property
    def host(self) -> int:
        return process_index() if self._host is None else int(self._host)

    @property
    def world(self) -> int:
        return process_count() if self._world is None else int(self._world)

    # -- async writer -------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="tadnn-shard-writer")
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is not None:
                    self._finalize(job)
            except BaseException as e:  # surfaced by wait()/next save
                self._error = e
            finally:
                self._q.task_done()
            if job is None:
                return

    def _finalize(self, job: _SaveJob) -> None:
        t0 = time.monotonic()
        d = step_dir(self.directory, job.step)
        npz_path = os.path.join(d, _host_npz(job.host))
        tmp = npz_path + ".tmp"
        arrays = {k: t.contiguous().reshape(-1).view(torch.uint8).numpy()
                  for k, t in job.arrays.items()}
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, npz_path)
        _fsync_dir(d)
        job.marker["sha256"] = _sha256_file(npz_path)
        job.marker["written_at"] = time.time()
        _fsync_write(os.path.join(d, _host_marker(job.host)),
                     json.dumps(job.marker).encode())
        obs_journal.event(
            "ckpt.async_save", step=int(job.step), host=int(job.host),
            queue_depth=self._q.qsize(),
            off_thread_s=round(time.monotonic() - t0, 6),
            dispatch_to_durable_s=round(time.monotonic() - job.submitted, 6),
            bytes=int(sum(a.nbytes for a in arrays.values())),
        )
        if job.host == 0:
            self._gc()

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- protocol -----------------------------------------------------------

    def save(self, step: int, state: Any, config: dict | None = None,
             force: bool = False) -> bool:
        self._raise_pending()
        step = int(step)
        if is_complete(self.directory, step) and not force:
            return False
        host, world = self.host, self.world
        logical = self._world is not None and process_count() == 1
        with obs_journal.span("ckpt.save", step=step, sharded=True) as rec:
            d = step_dir(self.directory, step)
            os.makedirs(d, exist_ok=True)
            shards: list[dict] = []
            arrays: dict[str, torch.Tensor] = {}
            leaves_meta: dict[str, dict] = {}
            degrees: dict[str, int] = {}
            pending = []
            for path, leaf in resilience.flatten_state(state).items():
                t = resilience.as_tensor(leaf)
                degrees.update(_mesh_axes(t))
                leaves_meta[path] = {"shape": list(t.shape),
                                     "dtype": _dtype_name(t.dtype),
                                     "spec": _spec_of(t)}
                if logical and _leaf_owner(path, world) != host:
                    continue  # another logical host persists this leaf
                # under a pipeline the state marks what this process
                # persists (core.AutoDistribute._mark_writers); another
                # stage's layer is a meta tensor here
                persist = getattr(leaf, "_tadnn_persist", None)
                if t.is_meta or persist is False:
                    continue
                local, offsets, replica0 = local_shard(t)
                if not replica0 or (not is_dtensor(t) and not logical
                                    and host != 0 and not persist):
                    continue  # another replica persists these bytes
                pending.append((path, local, offsets, t.dtype))
            # copy to host NOW: the next step updates these tensors in
            # place before the writer thread runs
            pin = any(local.is_cuda for _, local, _, _ in pending)
            for path, local, offsets, dtype in pending:
                key = f"s{len(shards)}"
                host_t = torch.empty(local.shape, dtype=dtype,
                                     pin_memory=pin)
                host_t.copy_(local.detach(), non_blocking=pin)
                arrays[key] = host_t
                shards.append({
                    "k": key, "leaf": path,
                    "index": [[o, o + n] for o, n in
                              zip(offsets, local.shape)],
                    "dtype": _dtype_name(dtype),
                })
            if pin:
                torch.cuda.synchronize()
            if host == 0:
                self._write_meta(step, world, config, leaves_meta, degrees)
            job = _SaveJob(
                step=step, host=host, arrays=arrays,
                marker={"version": SHARD_FORMAT_VERSION, "step": step,
                        "host": host, "world": world, "shards": shards},
                submitted=time.monotonic(),
            )
            self._ensure_thread()
            self._q.put(job)
            rec["queued"] = True
            rec["n_shards"] = len(shards)
        return True

    def _write_meta(self, step: int, world: int, config: dict | None,
                    leaves_meta: dict, degrees: dict) -> None:
        meta = {
            "version": SHARD_FORMAT_VERSION,
            "step": int(step),
            "world": int(world),
            "degrees": degrees,
            "written_at": time.time(),
            "config": config if config is not None else {},
            "leaves": leaves_meta,
        }
        _fsync_write(os.path.join(step_dir(self.directory, step), _META),
                     json.dumps(meta).encode())

    def latest_step(self) -> int | None:
        steps = list_complete_steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return list_complete_steps(self.directory)

    def reload(self) -> None:  # directory is rescanned on every call
        return None

    def wait(self) -> None:
        with obs_journal.span("ckpt.wait", sharded=True):
            self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._closed:
            return
        self._q.join()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=10)
        self._closed = True

    def quarantine(self, step: int, reason: str = "") -> None:
        """Move a step out of the chain, never under the writer: host 0
        renames it.  Under a process group every rank calls this at the
        same point (the verdict was agreed) and waits for the rename at a
        barrier; a logical host waits (up to a minute) for that rename
        and only then does it itself."""
        self._q.join()
        src = step_dir(self.directory, step)
        if self._world is None and group_up():
            if self.host == 0:
                resilience.quarantine_step(self.directory, step, reason)
            host_allgather(None)  # a barrier on the host group
            return
        if self.host != 0:
            deadline = time.monotonic() + 60.0
            while os.path.isdir(src) and time.monotonic() < deadline:
                time.sleep(0.05)
            if not os.path.isdir(src):
                return
        resilience.quarantine_step(self.directory, step, reason)

    def _gc(self) -> None:
        steps = list_complete_steps(self.directory)
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(step_dir(self.directory, s), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def restore(self, state: Any, step: int | None = None, *,
                verify: bool | None = None) -> Any:
        """Reassemble every leaf from all hosts' shards and write each
        live leaf's own slice of it into ``state`` in place (resharding
        across mesh and plan changes is the normal path, not a special
        case); returns the restored state.  Every name, shape and dtype
        is checked before any live tensor is touched, and under a process
        group the ranks agree on that verdict first (every rank calls
        ``restore`` at the same point), so no rank restores a step
        another rejects."""
        from .checkpoint import _rebuild

        self._raise_pending()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(
                f"No complete sharded checkpoint in {self.directory}")
        verify = self.integrity if verify is None else verify
        with obs_journal.span("ckpt.restore", step=step,
                              sharded=True) as rec:
            error = None
            try:
                assembled = self._checked(state, step, verify, rec)
            except (resilience.CheckpointCorruptError,
                    *resilience.RESTORE_ERRORS) as e:
                error = e
            if self._world is None and group_up():
                verdicts = host_allgather(None if error is None else
                                          resilience.describe_error(error))
                other = next((v for v in verdicts if v), None)
                if error is None and other is not None:
                    error = resilience.CheckpointCorruptError(
                        f"sharded step {step} failed on another rank: {other}")
            if error is not None:
                raise error
            live = resilience.flatten_state(state)
            with torch.no_grad():
                for path, leaf in live.items():
                    if not isinstance(leaf, torch.Tensor):
                        continue
                    local, offsets, _ = local_shard(leaf)
                    box = tuple(slice(o, o + n)
                                for o, n in zip(offsets, local.shape))
                    local.copy_(assembled[path][box].to(local.dtype))
            return _rebuild(state, assembled)

    def _checked(self, state: Any, step: int, verify: bool,
                 rec: dict) -> dict[str, torch.Tensor]:
        """Step ``step`` verified and assembled, every live leaf's name
        and shape found in it; raises what a restore must not pass."""
        if not is_complete(self.directory, step):
            raise FileNotFoundError(
                f"step {step} in {self.directory} is incomplete")
        if verify:
            problems = verify_step(self.directory, step)
            rec["verified"] = not problems
            if problems:
                raise resilience.CheckpointCorruptError(
                    f"sharded step {step} failed verification: "
                    + "; ".join(problems[:4])
                    + (f" (+{len(problems) - 4} more)"
                       if len(problems) > 4 else "")
                )
        meta = read_meta(self.directory, step)
        assembled = self._assemble(step, meta)
        live = resilience.flatten_state(state)
        missing = sorted(set(live) - set(assembled))
        if missing:
            raise KeyError(f"leaves {missing[:4]} missing from sharded "
                           f"step {step}")
        for path, leaf in live.items():
            want = resilience.as_tensor(leaf)
            arr = assembled[path]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"leaf {path}: checkpoint shape {tuple(arr.shape)} "
                    f"vs target {tuple(want.shape)}")
        return assembled

    def _assemble(self, step: int, meta: dict) -> dict[str, torch.Tensor]:
        """Whole host tensors per leaf path, from every host's shard
        file."""
        d = step_dir(self.directory, step)
        out: dict[str, torch.Tensor] = {}
        for m in _read_markers(self.directory, step, int(meta["world"])):
            with np.load(os.path.join(d, _host_npz(int(m["host"])))) as z:
                for s in m.get("shards", ()):
                    path = s["leaf"]
                    info = meta["leaves"].get(path)
                    if info is None:
                        raise KeyError(f"shard for unknown leaf {path}")
                    if path not in out:
                        out[path] = torch.empty(
                            tuple(info["shape"]),
                            dtype=_torch_dtype(info["dtype"]))
                    idx = tuple(slice(a, b) for a, b in s["index"])
                    shape = tuple(b - a for a, b in s["index"])
                    data = np.frombuffer(
                        z[s["k"]].tobytes(),
                        dtype=_NP_STORAGE[s["dtype"]]).reshape(shape)
                    out[path][idx] = torch.from_numpy(data.copy()).view(
                        _torch_dtype(s["dtype"]))
        return out

    def restore_config(self, step: int | None = None) -> dict | None:
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        meta = read_meta(self.directory, step)
        if meta is None:
            obs_journal.event("ckpt.restore_config_failed", step=int(step),
                              error="missing or torn meta.json")
            return None
        return meta.get("config")

    def __enter__(self) -> "ShardedCheckpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
