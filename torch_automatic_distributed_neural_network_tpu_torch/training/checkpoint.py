"""Checkpoint / resume on ``torch.distributed.checkpoint`` (the JAX
package's ``training/checkpoint.py``, whose Orbax manager this replaces).

Layout, as the JAX package writes it::

    <dir>/<step>/state      the train state's named leaves (DCP: .metadata
                            and __0_0.distcp)
    <dir>/<step>/config     the run config (JSON)
    <dir>/manifest-<step>.json   per-leaf sha256 (resilience.py)

Saves are asynchronous.  The step updates its state in place, so
``save`` first copies every leaf to host memory (pinned on a card, one
copy per leaf, one wait) and returns; a writer thread then hashes that
snapshot, writes it into ``<step>.tmp``, syncs the files, renames
the directory to ``<step>`` and only then writes the manifest — a crash
at any point leaves either no step or a step whose manifest vouches for
data already on disk.  The next step may change the live tensors as
soon as ``save`` returns.

One process, no process group: DCP writes alone (it warns "assuming the
intent is to save in a single process").  With a process group up the
save is coordinated, as orbax's is in the JAX package: every rank calls
``save`` at the same step, the snapshot keeps a sharded leaf a
``DTensor`` (its local shard in host memory), and DCP writes each rank's
shards (a replicated leaf once) into one ``<step>.tmp``; rank 0 then
publishes the directory and the manifest, whose entries are per shard
(``leaf``, ``offsets``) for a sharded leaf.  DCP's planning collectives
and the commit barriers run on a gloo group of the writer's own
(``new_group`` at construction), never on the group the training step
uses, so a save in flight cannot interleave with the step's
collectives.  Restore loads into the live layout (DCP reshards), checks
the shards each rank holds against the manifest, and the ranks agree
on the verdict before any live tensor is touched.  Barrier-free
per-process checkpoints are ``training/shards.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import TYPE_CHECKING, Any

import torch

from ..obs import journal as obs_journal
from ..utils.device import (
    group_up,
    host_allgather,
    is_dtensor,
    local_shard,
    process_index,
    resolve_device,
)
from . import resilience

if TYPE_CHECKING:  # runtime import would be circular (core -> training)
    from ..core import AutoDistribute, TrainState

RESTORE_ERRORS = resilience.RESTORE_ERRORS


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _rebuild(tree: Any, values: dict[str, Any], prefix: str = "") -> Any:
    """``tree`` with every int leaf replaced by ``values[path]`` (tensor
    leaves were already written in place), mirroring
    :func:`resilience.flatten_state`'s paths."""
    def path(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), values, path(f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path(i))
                          for i, v in enumerate(tree))
    if isinstance(tree, int):
        return int(values[prefix].item())
    return tree


def _load_into(state: Any, leaves: dict[str, torch.Tensor]) -> Any:
    """Write restored ``leaves`` into ``state``: every name, shape and
    dtype is checked before any tensor is touched, so a step that does
    not fit leaves the live state as it was."""
    live = resilience.flatten_state(state)
    missing, unexpected = sorted(set(live) - set(leaves)), sorted(
        set(leaves) - set(live))
    if missing or unexpected:
        raise KeyError(f"checkpoint leaves do not match the state: missing "
                       f"{missing[:4]}, unexpected {unexpected[:4]}")
    for name, leaf in live.items():
        want = resilience.as_tensor(leaf)
        got = leaves[name]
        if want.shape != got.shape or want.dtype != got.dtype:
            raise ValueError(
                f"leaf {name}: checkpoint {tuple(got.shape)} {got.dtype}, "
                f"state {tuple(want.shape)} {want.dtype}")
    with torch.no_grad():
        for name, leaf in live.items():
            if is_dtensor(leaf):
                leaf.to_local().copy_(leaves[name].to_local())
            elif isinstance(leaf, torch.Tensor):
                leaf.copy_(leaves[name])
    return _rebuild(state, leaves)


def _host_like(leaf: Any) -> torch.Tensor:
    """An empty host tensor laid out as ``leaf``: a ``DTensor`` of the
    same mesh and placements whose local shard lives in host memory (DCP
    reads and writes it there), else a plain host tensor."""
    t = resilience.as_tensor(leaf)
    if not is_dtensor(t):
        return torch.empty(t.shape, dtype=t.dtype)
    from torch.distributed.tensor import DTensor

    local = torch.empty(t.to_local().shape, dtype=t.dtype)
    return DTensor(local, t._spec, requires_grad=False)


def _shard_checksums(leaves: dict[str, torch.Tensor]) -> dict[str, dict]:
    """Manifest entries of this rank's part of named host ``leaves``:
    a plain leaf whole (keyed by its path), a ``DTensor``'s replica-0
    local shard keyed ``path@offsets`` with its ``leaf`` and ``offsets``
    (entries of other ranks fill in the rest)."""
    out = {}
    for path, t in leaves.items():
        if not is_dtensor(t):
            out[path] = resilience.leaf_checksums({path: t})[path]
            continue
        local, offsets, replica0 = local_shard(t)
        if not replica0:
            continue
        entry = resilience.leaf_checksums({path: local})[path]
        entry.update(leaf=path, offsets=list(offsets))
        out[f"{path}@{','.join(map(str, offsets))}"] = entry
    return out


class CheckpointManager:
    """Asynchronous checkpoints of a ``TrainState``, keeping the newest
    ``max_to_keep`` steps.

    With ``integrity=True`` (default) every save also writes a per-leaf
    sha256 manifest (``manifest-<step>.json``, resilience.py) and
    restore verifies the restored leaves against it, raising
    :class:`resilience.CheckpointCorruptError` on mismatch.  Steps saved
    without a manifest restore unverified.

    ``device``: the device of the states it saves and restores (default
    ``cuda``, raising without it; ``cpu`` for a CPU run).  On a card the
    snapshot goes to pinned host memory.  Made while a process group is
    up, every rank makes one (in the same order as its other groups: it
    makes the writer's own gloo group) and the saves are coordinated
    (module docstring).
    """

    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: int = 3,
        save_interval_steps: int = 0,
        integrity: bool = True,
        device=None,
    ):
        self.directory = os.path.abspath(directory)
        self.integrity = integrity
        self.max_to_keep = max_to_keep
        self.device = resolve_device(device)
        self._interval = save_interval_steps or 1
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()  # guards _steps (writer GC vs caller)
        self._steps = set(resilience.list_steps(self.directory))
        self._queue: "queue.Queue[tuple | None]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # the writer's own gloo group: DCP's planning collectives and the
        # commit barriers run on it from the writer thread
        self._group = (torch.distributed.new_group(backend="gloo")
                       if group_up() else None)

    # -- save -----------------------------------------------------------------

    def _snapshot(self, state: Any) -> dict[str, torch.Tensor]:
        """Every leaf of ``state`` copied to host memory (a ``DTensor``'s
        local shard, kept a ``DTensor``), complete when this returns."""
        pin = self.device.type == "cuda"
        out = {}
        for name, leaf in resilience.flatten_state(state).items():
            t = resilience.as_tensor(leaf)
            if t.is_meta:
                continue  # another pipeline stage's layer: its owner saves
            local = t.to_local() if is_dtensor(t) else t
            host = torch.empty(local.shape, dtype=t.dtype, pin_memory=pin)
            host.copy_(local, non_blocking=pin)
            if is_dtensor(t):
                from torch.distributed.tensor import DTensor

                host = DTensor(host, t._spec, requires_grad=False)
            out[name] = host
        if pin:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def save(self, step: int, state: "TrainState",
             config: dict | None = None, force: bool = False) -> bool:
        """Snapshot ``state`` and queue its write as step ``step``.
        Returns False (and saves nothing) for a step not after the latest
        or off ``save_interval_steps``, unless ``force``."""
        self._raise_pending()
        step = int(step)
        latest = self.latest_step()
        if not force and ((latest is not None and latest >= step)
                          or step % self._interval):
            return False
        if step in self.all_steps():
            raise ValueError(f"checkpoint step {step} already exists in "
                             f"{self.directory}")
        # the span covers the snapshot only; the write lands in wait()
        with obs_journal.span("ckpt.save", step=step) as rec:
            snapshot = self._snapshot(state)
            with self._lock:
                self._steps.add(step)
            self._ensure_writer()
            self._queue.put((step, snapshot,
                             config if config is not None else {},
                             time.monotonic()))
            # the bytes written are journaled with the write itself
            # (ckpt.async_save), as the event schema declares them
            rec["saved"] = True
            rec["manifest_queued"] = self.integrity
        return True

    # -- the writer thread ----------------------------------------------------

    def _ensure_writer(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._write_loop, daemon=True,
                name="tadnn-ckpt-writer")
            self._thread.start()

    def _write_loop(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is not None:
                    self._write(*job)
            except BaseException as e:  # raised by wait() / the next save
                self._error = e
                with self._lock:
                    self._steps.discard(job[0])
            finally:
                self._queue.task_done()
            if job is None:
                return

    def _barrier(self) -> None:
        if self._group is not None:
            torch.distributed.barrier(group=self._group)

    def _write(self, step: int, snapshot: dict, config: dict,
               submitted: float) -> None:
        import torch.distributed.checkpoint as dcp

        t0 = time.monotonic()
        lead = process_index() == 0
        final = os.path.join(self.directory, str(step))
        # one directory for every rank's files; DCP's planning (which
        # needs rank 0) runs before any rank writes
        tmp = f"{final}.tmp"
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
        leaves = None
        if self.integrity:
            parts = self._gather(_shard_checksums(snapshot))
            leaves = {k: v for part in parts for k, v in part.items()}
        state_dir = os.path.join(tmp, "state")
        # FileSystemWriter syncs each file it writes
        dcp.save(snapshot, checkpoint_id=state_dir,
                 process_group=self._group, no_dist=self._group is None)
        if lead:
            with open(os.path.join(tmp, "config"), "w") as f:
                json.dump(config, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            _fsync(state_dir)
            _fsync(tmp)
            os.replace(tmp, final)  # publish atomically
            _fsync(self.directory)
            if leaves is not None:
                # the manifest's existence implies the data is durable
                resilience.write_manifest(self.directory, step, None,
                                          leaves=leaves)
        self._barrier()  # every rank's step is committed past here
        obs_journal.event(
            "ckpt.async_save", step=step,
            queue_depth=self._queue.qsize(),
            bytes=sum(resilience.as_tensor(local_shard(t)[0]).nbytes
                      for t in snapshot.values()),
            off_thread_s=round(time.monotonic() - t0, 6),
            dispatch_to_durable_s=round(time.monotonic() - submitted, 6),
        )
        self._gc()

    def _gc(self) -> None:
        """Drop the oldest committed steps beyond ``max_to_keep``, and
        their manifests (rank 0 deletes; every rank forgets them)."""
        steps = resilience.list_steps(self.directory)
        drop = steps[:-self.max_to_keep] if self.max_to_keep else []
        self._barrier()  # no rank lists the directory while it shrinks
        if process_index() == 0:
            for step in drop:
                shutil.rmtree(os.path.join(self.directory, str(step)),
                              ignore_errors=True)
                try:
                    os.remove(resilience.manifest_path(self.directory,
                                                       step))
                except FileNotFoundError:
                    pass
        with self._lock:
            self._steps.difference_update(drop)

    # -- the chain ------------------------------------------------------------

    def latest_step(self) -> int | None:
        with self._lock:
            return max(self._steps) if self._steps else None

    def all_steps(self) -> list[int]:
        with self._lock:
            return sorted(self._steps)

    def _drain(self) -> None:
        self._queue.join()

    def reload(self) -> None:
        """Re-scan the directory (after an external change, e.g. a
        quarantine rename)."""
        self._drain()
        with self._lock:
            self._steps = set(resilience.list_steps(self.directory))

    def quarantine(self, step: int, reason: str = "") -> None:
        """Move a corrupt step out of the chain (resilience.py), never
        under the writer; rank 0 renames it while the others wait."""
        self._drain()
        if process_index() == 0:
            resilience.quarantine_step(self.directory, step, reason)
        self._barrier()
        self.reload()

    # -- restore --------------------------------------------------------------

    def restore(self, state: "TrainState", step: int | None = None, *,
                verify: bool | None = None) -> "TrainState":
        """Restore step ``step`` (default: the latest) into ``state``:
        its tensors are overwritten in place (the module's parameters
        among them) and its ints replaced; returns the restored state.

        ``verify`` (default: the manager's ``integrity`` flag) re-hashes
        every restored leaf against the step's manifest; a mismatch raises
        CheckpointCorruptError before ``state`` is touched.  Steps without
        a manifest pass through unverified.
        """
        self._drain()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        verify = self.integrity if verify is None else verify
        with obs_journal.span("ckpt.restore", step=int(step)) as rec:
            # one process reads the step as it was written (its own
            # metadata: an extra leaf or another dtype is caught below);
            # a group reads it into the live layout (DCP reshards)
            leaves = (resilience._raw_restore_state(self.directory, step)
                      if self._group is None
                      else self._load_sharded(state, step))
            manifest = (resilience.read_manifest(self.directory, step)
                        if verify else None)
            if manifest is not None:
                problems = [p for part in self._gather(
                    resilience.verify_tree(leaves, manifest)) for p in part]
                rec["verified"] = not problems
                if problems:
                    raise resilience.CheckpointCorruptError(
                        f"step {step} failed integrity verification: "
                        + "; ".join(problems[:4])
                        + (f" (+{len(problems) - 4} more)"
                           if len(problems) > 4 else "")
                    )
            return _load_into(state, leaves)

    def _load_sharded(self, state: Any, step: int) -> dict:
        """Step ``step`` read by every rank into host tensors laid out as
        ``state``'s leaves (DCP reshards a step written under another
        plan)."""
        import torch.distributed.checkpoint as dcp

        leaves = {name: _host_like(leaf) for name, leaf
                  in resilience.flatten_state(state).items()}
        dcp.load(leaves, checkpoint_id=os.path.join(
            self.directory, str(int(step)), "state"),
                 process_group=self._group)
        return leaves

    def _gather(self, obj: Any) -> list:
        """``obj`` from every rank over the writer's group (``[obj]`` in
        one process), so that all ranks take one verdict."""
        if self._group is None:
            return [obj]
        gathered = [None] * torch.distributed.get_world_size(self._group)
        torch.distributed.all_gather_object(gathered, obj, group=self._group)
        return gathered

    def restore_config(self, step: int | None = None) -> dict | None:
        self._drain()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        try:
            with open(os.path.join(self.directory, str(int(step)),
                                   "config")) as f:
                return json.load(f)
        except RESTORE_ERRORS as e:
            # a missing/torn config is survivable (the caller gets None
            # and proceeds with defaults) but never silent
            obs_journal.event(
                "ckpt.restore_config_failed", step=int(step),
                error=resilience.describe_error(e),
            )
            return None

    def wait(self) -> None:
        """Block until every queued save is durable; raises a writer
        failure."""
        with obs_journal.span("ckpt.wait"):
            self._drain()
        self._raise_pending()

    def close(self) -> None:
        self._drain()
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=10)
        self._raise_pending()


def agreed_latest_step(ckpt: Any) -> int | None:
    """The newest step every process sees committed: the oldest of the
    processes' newest steps (a ``ShardedCheckpoint`` marker may land in
    one rank's scan and not yet in another's), None when one has none.
    Every process of a group calls it at the same point."""
    steps = host_allgather(ckpt.latest_step())
    return None if None in steps else min(steps)


def restore_or_init(
    ad: "AutoDistribute",
    ckpt: CheckpointManager | None,
    rng,
    sample_batch,
) -> "tuple[TrainState, bool]":
    """Resume from the newest *intact* checkpoint, else fresh init.
    Returns (state, resumed).

    Fallback chain (resilience.py): the latest step is tried first; a
    step that fails to restore or fails integrity verification is
    quarantined (renamed ``<step>.corrupt``, ``ckpt.corrupt`` journal
    event) and the next-older step is tried, so a partial write during
    preemption degrades to losing one save interval instead of the run.
    The fresh init is the template every restore writes into; a failed
    restore leaves it untouched, so with no intact step it is the state.
    Under a process group the ranks walk the chain together: each step
    tried is :func:`agreed_latest_step`, and the restore's verdict is
    every rank's.
    """
    state = ad.init(rng, sample_batch)
    if ckpt is None:
        return state, False
    while True:
        step = agreed_latest_step(ckpt)
        if step is None:
            return state, False
        try:
            state = ckpt.restore(state, step=step)
        except (resilience.CheckpointCorruptError, *RESTORE_ERRORS) as e:
            ckpt.quarantine(step, reason=resilience.describe_error(e))
            continue
        ad.adopt_state(state)
        return state, True
