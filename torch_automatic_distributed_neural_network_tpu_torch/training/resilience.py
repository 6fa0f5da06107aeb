"""Resilience layer: checkpoint integrity, restart policy, anomaly
rollback, and a deterministic chaos harness (the JAX package's
``training/resilience.py`` over ``torch.distributed.checkpoint``).

- **Integrity manifest**: every ``CheckpointManager.save`` writes a
  per-leaf sha256 manifest next to the step (``manifest-<step>.json``);
  restore re-hashes the restored leaves against it, so silent
  corruption is caught before training resumes on garbage.
  ``restore_or_init`` walks the **fallback chain** latest→older,
  quarantining bad steps (``<step>.corrupt`` rename + ``ckpt.corrupt``
  journal event) instead of dying.
- **RestartPolicy**: exponential backoff with *deterministic* jitter
  (hash of seed×attempt, so tests can assert the schedule) and a restart
  budget over a rolling window, consumed by
  ``elastic.run_with_recovery``.
- **AnomalyGuard**: rolling loss statistics; on NaN/Inf or a spike the
  Trainer restores the last *verified* checkpoint and skips the
  offending batch window — deterministic under step-indexed data.
- **ChaosPlan**: seeded fault injection (step exceptions, torn
  checkpoint writes, NaN batches, stalled steps), so every recovery path
  above has a kill-and-resume test on the CPU.

A train state is checkpointed as its **named leaves**: the
``TrainState`` flattened through its fields, dict keys and tuple
indices into ``"params/<name>"``, ``"opt_state/0/mu/<name>"``,
``"opt_state/0/count"``, ``"step"``, ``"seed"`` (the JAX package's
normalized key paths).  Python ints (the step, the seed, the optimizer
counts) become 0-d int64 tensors on disk and ints again on restore.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pickle
import time
from collections import deque
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch.distributed.checkpoint.api import CheckpointException

from ..obs import journal as obs_journal

MANIFEST_VERSION = 1

# What ``torch.distributed.checkpoint`` raises on a torn, truncated or
# missing step: FileNotFoundError (OSError) for a missing file,
# pickle.UnpicklingError or EOFError for torn ``.metadata``, and
# CheckpointException (a BaseException, not an Exception) wrapping the
# reader's RuntimeError for a torn ``.distcp``; ValueError/KeyError/
# TypeError/IndexError for a step whose leaves do not fit the state.
# The fallback chain treats exactly these as "this step is bad, try an
# older one", and ``restore_config`` as "no config".
RESTORE_ERRORS = (OSError, ValueError, KeyError, TypeError, IndexError,
                  pickle.UnpicklingError, EOFError, CheckpointException)


def describe_error(e: BaseException) -> str:
    """``Type: message`` of a restore failure on one line; for a
    CheckpointException, of the reader's own exception inside it."""
    if isinstance(e, CheckpointException) and e.failures:
        inner = next(iter(e.failures.values()))
        inner = inner[0] if isinstance(inner, tuple) else inner
        return f"{type(e).__name__}: {describe_error(inner)}"
    text = str(e).strip().splitlines()
    return f"{type(e).__name__}: {text[0] if text else ''}"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step failed integrity verification."""


class StallError(RuntimeError):
    """Raised (asynchronously) when the watchdog escalates a stall —
    a RuntimeError so the default ``run_with_recovery`` retriable set
    treats it like any other wedged-runtime failure."""


# -- named leaves and the per-leaf integrity manifest ------------------------


def flatten_state(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` over dataclass fields, dict keys and list/tuple
    indices, joined by ``/``.  Leaves are tensors and Python ints; None
    and empty containers have none."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key, value in items:
        out.update(flatten_state(value, f"{prefix}/{key}" if prefix
                                 else str(key)))
    return out


def as_tensor(leaf: Any) -> torch.Tensor:
    """A leaf as a detached tensor (a Python int as 0-d int64)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int64)
    raise TypeError(f"a state leaf must be a tensor or an int, got "
                    f"{type(leaf).__name__}")


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes in host memory, as a uint8 array (bf16 has no
    numpy dtype, so the hash reads bytes, never values)."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def leaf_checksums(tree: Any) -> dict[str, dict]:
    """``{path: {sha256, shape, dtype}}`` for every leaf of ``tree`` (a
    ``TrainState`` or already-named leaves).  Hashes the host
    representation, so the digest does not depend on the device."""
    out: dict[str, dict] = {}
    for path, leaf in flatten_state(tree).items():
        t = as_tensor(leaf)
        out[path] = {
            "sha256": hashlib.sha256(_host_bytes(t)).hexdigest(),
            "shape": list(t.shape),
            "dtype": _dtype_name(t.dtype),
        }
    return out


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"manifest-{int(step)}.json")


def write_manifest(directory: str, step: int, tree: Any,
                   extra: dict | None = None, *,
                   leaves: dict | None = None) -> str:
    """Atomically (tmp+fsync+rename) write the integrity manifest for
    ``step``.  ``leaves`` short-circuits the checksum pass with values
    computed earlier (the checkpoint writer hashes its host snapshot)."""
    path = manifest_path(directory, step)
    doc = {
        "version": MANIFEST_VERSION,
        "step": int(step),
        "written_at": time.time(),
        "leaves": leaf_checksums(tree) if leaves is None else leaves,
        **(extra or {}),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(directory: str, step: int) -> dict | None:
    """The manifest for ``step``, or None (missing / unparseable — a
    torn manifest must not block the fallback chain, the step itself
    just restores unverified)."""
    try:
        with open(manifest_path(directory, step)) as f:
            doc = json.load(f)
        if not isinstance(doc.get("leaves"), dict):
            return None
        return doc
    except (OSError, ValueError):
        return None


def verify_tree(tree: Any, manifest: dict) -> list[str]:
    """Problems (empty = verified) comparing ``tree``'s leaves against a
    manifest from :func:`write_manifest`."""
    want = manifest.get("leaves", {})
    got = leaf_checksums(tree)
    problems = []
    for path in sorted(set(want) - set(got)):
        problems.append(f"missing leaf {path}")
    for path in sorted(set(got) - set(want)):
        problems.append(f"unexpected leaf {path}")
    for path in sorted(set(want) & set(got)):
        if want[path]["sha256"] != got[path]["sha256"]:
            problems.append(f"checksum mismatch at {path}")
    return problems


# -- fallback chain / quarantine ---------------------------------------------


def list_steps(directory: str) -> list[int]:
    """Committed step numbers in a checkpoint directory, ascending.
    Quarantined (``<step>.corrupt``) and in-progress (``<step>.tmp-*``)
    directories are excluded."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.isdigit() and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(name))
    return sorted(steps)


def quarantine_step(directory: str, step: int, reason: str = "") -> str:
    """Rename a corrupt/torn step (and its manifest) out of the chain.

    ``<dir>/<step>`` -> ``<dir>/<step>.corrupt`` (``.corrupt2``... if a
    previous quarantine of the same step exists), so the evidence
    survives for `doctor` forensics but latest-step scans and the
    fallback walk never pick it up again.
    """
    src = os.path.join(directory, str(int(step)))
    dst = src + ".corrupt"
    n = 1
    while os.path.exists(dst):
        n += 1
        dst = f"{src}.corrupt{n}"
    if os.path.exists(src):
        os.replace(src, dst)
    man = manifest_path(directory, step)
    if os.path.exists(man):
        os.replace(man, man + ".corrupt")
    obs_journal.event("ckpt.corrupt", step=int(step), reason=reason,
                      quarantined=os.path.basename(dst))
    return dst


# -- doctor: directory verification ------------------------------------------


def _raw_restore_state(directory: str, step: int) -> dict[str, torch.Tensor]:
    """A step's ``state`` item as named host tensors — the doctor path,
    independent of any model code: shapes and dtypes come from the
    checkpoint's own metadata."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(directory, str(int(step)), "state")
    meta = dcp.FileSystemReader(path).read_metadata()
    leaves = {}
    for name, m in meta.state_dict_metadata.items():
        if not hasattr(m, "properties"):
            raise ValueError(f"leaf {name} is not a tensor")
        leaves[name] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
    # one process, no process group: the port's checkpoints are written
    # by a single process (multi-process sharding is ROADMAP Queue 1
    # item 3)
    dcp.load(leaves, checkpoint_id=path, no_dist=True)
    return leaves


def verify_step(directory: str, step: int) -> dict:
    """Verdict dict for one step: ``{step, ok, verified, problems}``.

    ``ok`` = the step restores (and matches its manifest when one
    exists); ``verified`` = a manifest was present and every leaf
    checksum matched.
    """
    manifest = read_manifest(directory, step)
    problems: list[str] = []
    try:
        tree = _raw_restore_state(directory, step)
    except RESTORE_ERRORS as e:
        return {"step": int(step), "ok": False, "verified": False,
                "problems": [f"restore failed: {describe_error(e)}"]}
    if manifest is not None:
        problems = verify_tree(tree, manifest)
    return {
        "step": int(step),
        "ok": not problems,
        "verified": manifest is not None and not problems,
        "problems": problems,
    }


def verify_directory(directory: str) -> dict:
    """Walk the fallback chain (latest → oldest) and verify every step.

    Returns ``{directory, steps: [verdicts newest-first], quarantined,
    healthy, best_step}`` — ``healthy`` means at least one step is
    restorable, ``best_step`` is the newest such step (what
    ``restore_or_init`` would resume from).
    """
    steps = list_steps(directory)
    chain = [verify_step(directory, s) for s in reversed(steps)]
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


def format_doctor(report: dict) -> str:
    """Human rendering of :func:`verify_directory` (the `doctor`
    output): the fallback chain newest-first with per-step verdicts."""
    lines = [f"checkpoint directory: {report['directory']}"]
    if not report["steps"] and not report["quarantined"]:
        lines.append("no checkpoint steps found")
        return "\n".join(lines)
    lines.append("fallback chain (newest first):")
    for v in report["steps"]:
        mark = ("ok, verified" if v["verified"]
                else "ok, no manifest" if v["ok"] else "CORRUPT")
        lines.append(f"  step {v['step']:>8}  [{mark}]")
        for p in v["problems"][:4]:
            lines.append(f"      - {p}")
        if len(v["problems"]) > 4:
            lines.append(f"      - ... {len(v['problems']) - 4} more")
    for q in report["quarantined"]:
        lines.append(f"  quarantined: {q}")
    lines.append(
        f"restore would resume from step {report['best_step']}"
        if report["healthy"]
        else "NO restorable step — restore_or_init would fall back to "
             "fresh init"
    )
    return "\n".join(lines)


# -- restart policy -----------------------------------------------------------


@dataclasses.dataclass
class RestartPolicy:
    """Backoff + budget for ``run_with_recovery``.

    Delay before retry ``n`` (1-based) is ``base * factor**(n-1)``
    clamped to ``max_s``, then jittered by ±``jitter`` — the jitter is
    a pure hash of ``(seed, n)``, so every process computes the same
    schedule and tests can assert it exactly.  The budget is a rolling
    window: more than ``max_restarts`` failures inside ``window_s``
    seconds gives up.

    ``sleep``/``clock`` are injectable for deterministic tests.
    """

    max_restarts: int = 2
    window_s: float = 3600.0
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    jitter: float = 0.1
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._failures: deque[float] = deque()

    def delay_s(self, attempt: int) -> float:
        """Deterministic backoff delay before retry ``attempt`` (>=1)."""
        if self.backoff_base_s <= 0:
            return 0.0
        base = min(
            self.backoff_base_s * self.backoff_factor ** max(attempt - 1, 0),
            self.backoff_max_s,
        )
        if not self.jitter:
            return base
        h = hashlib.blake2b(
            f"{self.seed}:{attempt}".encode(), digest_size=8
        ).digest()
        frac = int.from_bytes(h, "big") / 2**64  # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * frac - 1.0))

    def note_failure(self, now: float | None = None) -> bool:
        """Record a failure; True when the rolling-window budget is
        exhausted (the caller should re-raise instead of retrying)."""
        now = self.clock() if now is None else now
        self._failures.append(now)
        while self._failures and now - self._failures[0] > self.window_s:
            self._failures.popleft()
        return len(self._failures) > self.max_restarts

    @property
    def recent_failures(self) -> int:
        return len(self._failures)


# -- anomaly rollback ---------------------------------------------------------


@dataclasses.dataclass
class AnomalyConfig:
    """Loss-anomaly guard knobs (Trainer ``cfg.anomaly``).

    A loss is anomalous when it is non-finite, or exceeds the rolling
    mean by ``spike_sigma`` rolling standard deviations (with an
    ``abs(mean) * spike_rel_floor`` floor on the deviation).  At least
    ``min_history`` healthy losses must be seen before spike detection
    arms; NaN/Inf always triggers.
    """

    window: int = 32
    spike_sigma: float = 6.0
    spike_rel_floor: float = 0.05
    min_history: int = 8
    max_rollbacks: int = 2  # per fit(); beyond this the anomaly raises


class AnomalyGuard:
    """Rolling loss statistics + anomaly verdicts (pure host math)."""

    def __init__(self, cfg: AnomalyConfig):
        self.cfg = cfg
        self._window: deque[float] = deque(maxlen=cfg.window)
        self.rollbacks = 0

    def check(self, loss: float) -> str | None:
        """``None`` when healthy (the loss joins the rolling window),
        else the anomaly reason (``'non-finite'`` / ``'spike'``) — the
        anomalous value is NOT admitted to the window."""
        if not math.isfinite(loss):
            return "non-finite"
        n = len(self._window)
        if n >= max(self.cfg.min_history, 2):
            mean = sum(self._window) / n
            var = sum((x - mean) ** 2 for x in self._window) / n
            floor = abs(mean) * self.cfg.spike_rel_floor
            threshold = mean + self.cfg.spike_sigma * max(
                math.sqrt(var), floor, 1e-12
            )
            if loss > threshold:
                return "spike"
        self._window.append(loss)
        return None


# -- chaos harness ------------------------------------------------------------


def _fires(seed: int, kind: str, step: int, p: float) -> bool:
    """Deterministic per-(seed, kind, step) Bernoulli draw — stable
    across processes (no Python hash randomization)."""
    if p <= 0:
        return False
    if p >= 1:
        return True
    h = hashlib.blake2b(f"{seed}:{kind}:{step}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2**64 < p


class ChaosFault(RuntimeError):
    """Raised by the chaos harness's injected step exceptions (a
    RuntimeError: retriable under the default run_with_recovery set)."""


@dataclasses.dataclass
class ChaosPlan:
    """Seeded fault schedule — the FaultInjector generalization.

    Faults fire either at the explicit ``*_at`` steps or with per-step
    probability ``p_*`` drawn deterministically from ``seed``.  Kinds:
    ``exception`` (the step callback raises :class:`ChaosFault`),
    ``torn_ckpt`` (the newest committed step is torn right after it
    lands), ``nan`` (``ChaosData`` poisons that step's batch) and
    ``stall`` (the callback sleeps ``stall_s``).  The orchestrator kinds
    (``sigkill``, ``journal_partition``, ``shard_tear``) are scheduled
    the same way; the launcher that fires them is not ported yet
    (ROADMAP Queue 1 item 3).
    """

    seed: int = 0
    exception_at: tuple[int, ...] = ()
    torn_ckpt_at: tuple[int, ...] = ()
    nan_at: tuple[int, ...] = ()
    stall_at: tuple[int, ...] = ()
    sigkill_at: tuple[int, ...] = ()
    journal_partition_at: tuple[int, ...] = ()
    shard_tear_at: tuple[int, ...] = ()
    p_exception: float = 0.0
    p_torn_ckpt: float = 0.0
    p_nan: float = 0.0
    p_stall: float = 0.0
    p_sigkill: float = 0.0
    p_journal_partition: float = 0.0
    p_shard_tear: float = 0.0
    stall_s: float = 0.0
    chaos_host: int = 0  # which host orchestrator faults target

    def fires(self, kind: str, step: int) -> bool:
        at = getattr(self, f"{kind}_at")
        return step in at or _fires(self.seed, kind, step,
                                    getattr(self, f"p_{kind}"))

    ORCHESTRATOR_KINDS = ("sigkill", "journal_partition", "shard_tear")


def tear_checkpoint(directory: str, step: int, *, seed: int = 0,
                    fraction: float = 1.0) -> int:
    """Simulate a torn/partial checkpoint write: truncate (a seeded
    subset of) the files under ``<directory>/<step>`` to a third of
    their length, in place — ``.metadata`` and the ``.distcp`` data of
    the state, and the config.  The step directory stays committed, as a
    crash between the data write and a durable flush leaves it.  Returns
    the number of files torn."""
    root = os.path.join(directory, str(int(step)))
    targets = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            targets.append(os.path.join(dirpath, name))
    targets.sort()  # os.walk order is fs-dependent; a seeded partial
    # tear has to hit the same files on every run
    torn = 0
    for i, path in enumerate(targets):
        if fraction < 1.0 and not _fires(seed, f"tear:{i}", step, fraction):
            continue
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size // 3)
            torn += 1
        except OSError:
            continue
    return torn


class ChaosInjector:
    """Trainer callback driving a :class:`ChaosPlan`'s exception /
    stall / torn-checkpoint faults (NaN faults live in ChaosData —
    they must enter through the batch, not the host loop).

    Each (kind, step) fault fires at most once per process, so a
    restarted run replaying the same step does not loop forever on the
    same injected failure.
    """

    def __init__(self, plan: ChaosPlan, *, ckpt: Any = None):
        self.plan = plan
        self.ckpt = ckpt  # CheckpointManager, for torn_ckpt faults
        self.fired: set[tuple[str, int]] = set()

    def _once(self, kind: str, step: int) -> bool:
        if (kind, step) in self.fired or not self.plan.fires(kind, step):
            return False
        self.fired.add((kind, step))
        obs_journal.event("resilience.chaos", kind=kind, step=step)
        return True

    def __call__(self, step: int, state: Any, metrics: dict) -> None:
        if self.ckpt is not None and self._once("torn_ckpt", step):
            self.ckpt.wait()  # the async save must land before we tear it
            latest = self.ckpt.latest_step()
            if latest is not None:
                tear_checkpoint(self.ckpt.directory, latest,
                                seed=self.plan.seed)
        if self._once("stall", step) and self.plan.stall_s > 0:
            time.sleep(self.plan.stall_s)
        if self._once("exception", step):
            raise ChaosFault(f"chaos: injected exception at step {step}")


def _poison(x: Any) -> Any:
    """NaNs in place of a floating leaf (numpy array or tensor)."""
    if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
        return np.full_like(x, np.nan)
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return torch.full_like(x, float("nan"))
    return x


class ChaosData:
    """Step-indexed data wrapper that poisons scheduled batches with
    NaNs (every float leaf) — downstream the loss goes NaN and the
    anomaly guard's rollback path gets exercised end-to-end.

    Skip-aware: the Trainer's anomaly rollback shifts batch indices
    past a poisoned window, so the replayed steps see clean batches.
    """

    step_indexed = True

    def __init__(self, data: Any, plan: ChaosPlan):
        if not getattr(data, "step_indexed", False):
            raise ValueError("ChaosData needs a step-indexed source "
                             "(deterministic chaos requires batch(i))")
        self.data = data
        self.plan = plan

    def batch(self, step: int) -> Any:
        b = self.data.batch(step)
        if not self.plan.fires("nan", step):
            return b
        return {k: _poison(v) for k, v in b.items()}

    def __iter__(self) -> Iterator[Any]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
