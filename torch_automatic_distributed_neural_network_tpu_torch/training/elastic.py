"""Failure detection + elastic recovery (the JAX package's
``training/elastic.py``).

The pieces:

- **Heartbeat**: each process writes a small JSON beat (host, step,
  time) to a shared directory; any process — or an external supervisor —
  can detect a stale peer.
- **StepWatchdog**: in-process stall detector — if no training step
  completes within ``timeout_s`` (hung collective, wedged runtime), the
  watchdog fires a callback (default: loud stderr report) so the run can
  be killed and resumed instead of hanging silently.
- **run_with_recovery**: the recovery primitive.  Re-invokes the training
  function after a failure; the Trainer's checkpoint-restore path
  (checkpoint.restore_or_init) brings the run back to the last intact
  saved step.
- **FaultInjector**: deterministic fault injection for kill-and-resume
  tests.
- **PreemptionGuard**: cooperative SIGTERM drain.  Maintenance events
  and spot reclamation deliver SIGTERM with a grace window; the guard
  converts it into a flag the train loop polls each step, so the
  Trainer saves a final checkpoint and returns cleanly instead of dying
  mid-step and losing everything since the last periodic save.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, Callable

from ..obs import journal as obs_journal
from ..utils.device import process_index
from .resilience import RestartPolicy, StallError


class InjectedFault(RuntimeError):
    """Raised by FaultInjector; distinguishable from real failures."""


@dataclasses.dataclass
class FaultInjector:
    """Train-loop callback that kills the run at a chosen step, once.

    Use as a Trainer callback: ``Trainer(..., callbacks=[FaultInjector(5)])``.
    """

    at_step: int
    exc: type[BaseException] = InjectedFault
    fired: bool = False

    def __call__(self, step: int, state: Any, metrics: dict) -> None:
        if not self.fired and step == self.at_step:
            self.fired = True
            raise self.exc(f"injected fault at step {step}")


class Heartbeat:
    """Periodic liveness beat to ``directory/host_<idx>.json``.

    The directory is expected to be shared across hosts (a network file
    system) in multi-host runs; ``stale_hosts`` reads every peer's beat and
    returns those older than ``max_age_s``.
    """

    def __init__(self, directory: str, *, interval_s: float = 10.0,
                 host_index: int | None = None):
        self.directory = directory
        self.interval_s = interval_s
        self.host_index = (process_index() if host_index is None
                           else host_index)
        self._step = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"host_{self.host_index}.json")

    def set_step(self, step: int) -> None:
        self._step = step

    def _write(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            # pid lets a cross-process supervisor match the beat to the
            # worker it spawned (a stale file from a previous cohort has
            # a dead/foreign pid); mono is this
            # process's monotonic clock, immune to wall-clock jumps when
            # comparing two beats from the SAME writer
            json.dump({"host": self.host_index, "step": self._step,
                       "time": time.time(), "pid": os.getpid(),
                       "mono": time.monotonic()}, f)
        os.replace(tmp, self.path)

    def start(self) -> "Heartbeat":
        self._write()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)
        try:
            self._write()  # final beat records the last step
        except OSError:
            # best-effort: a torn-down/unmounted shared dir at shutdown
            # must not turn a clean exit into a crash
            pass

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @staticmethod
    def read_all(directory: str) -> dict[int, dict]:
        beats: dict[int, dict] = {}
        if not os.path.isdir(directory):
            return beats
        for name in os.listdir(directory):
            if name.startswith("host_") and name.endswith(".json"):
                try:
                    with open(os.path.join(directory, name)) as f:
                        b = json.load(f)
                    beats[int(b["host"])] = b
                except (ValueError, KeyError, OSError):
                    continue  # torn write — next beat will fix it
        return beats

    @staticmethod
    def stale_hosts(directory: str, *, max_age_s: float) -> list[int]:
        """Hosts whose last beat is older than ``max_age_s``.

        Beats carry the writer's wall clock, so staleness needs a
        reference clock that survives skew.  A host is reported stale only
        if it is stale against BOTH the local clock and the newest beat in
        the directory: a local clock running ahead flags everyone against
        the local reference but not against the newest peer beat, and one
        peer with a fast (or corrupt future-stamped) clock flags everyone
        against the peer reference but not against the local clock — a
        single bad clock, wherever it lives, cannot poison detection.
        Beats still assume roughly NTP-grade sync; size ``max_age_s``
        (several beat intervals) to absorb residual skew.
        """
        beats = Heartbeat.read_all(directory)
        ref_local = time.time()

        def is_stale(h: int, b: dict) -> bool:
            if ref_local - b["time"] <= max_age_s:
                return False
            # peer reference excludes the candidate's own beat, so a dead
            # host alone in the directory is still detectable
            others = [p["time"] for hh, p in beats.items() if hh != h]
            return not others or max(others) - b["time"] > max_age_s

        return sorted(h for h, b in beats.items() if is_stale(h, b))


class StepWatchdog:
    """Fires ``on_stall`` if no ``beat()`` arrives within ``timeout_s``.

    Catches hung collectives / wedged device runtimes, which otherwise
    block the single controller forever with no error.  Default action
    reports loudly to stderr; pass ``on_stall`` to escalate (e.g.
    ``os._exit`` so a supervisor restarts the job).
    """

    def __init__(self, timeout_s: float,
                 on_stall: Callable[[float], None] | None = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or self._default_stall
        self.stalled = False
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _default_stall(self, age_s: float) -> None:
        obs_journal.event("watchdog.stall", age_s=age_s,
                          timeout_s=self.timeout_s)
        print(
            f"[tadnn watchdog] no step completed for {age_s:.1f}s "
            f"(timeout {self.timeout_s}s) — training appears stalled",
            file=sys.stderr, flush=True,
        )

    def beat(self) -> None:
        self._last = time.monotonic()

    def start(self) -> "StepWatchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        poll = min(1.0, self.timeout_s / 4)
        while not self._stop.wait(poll):
            age = time.monotonic() - self._last
            if age > self.timeout_s:
                self.stalled = True
                self.on_stall(age)
                self._last = time.monotonic()  # report once per timeout

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class PreemptionGuard:
    """Cooperative SIGTERM/SIGUSR1 drain flag (see module docstring).

    Signal handlers only install on the main thread (a Python
    constraint); elsewhere ``install`` is a no-op and ``requested``
    stays False — background-thread training loops keep working, just
    without the drain.  ``request()`` lets tests (or a cluster agent
    with its own notification channel) trip the flag directly.

    Multi-host note: each host sees only its own signal.  The drain is
    cooperative and assumes the orchestrator signals every host of the
    job; the final
    checkpoint save is the usual path.
    """

    def __init__(self, signals: tuple[int, ...] | None = None):
        import signal as _signal

        self._signal = _signal
        self._signals = (
            signals if signals is not None
            else (_signal.SIGTERM, _signal.SIGUSR1)
        )
        self._requested = threading.Event()
        self._prev: dict[int, Any] = {}

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self._signals:
            try:
                self._prev[sig] = self._signal.signal(sig, self._on_signal)
            except (ValueError, OSError):  # non-main thread / exotic sig
                pass
        return self

    def _on_signal(self, signum, frame) -> None:
        self._requested.set()
        obs_journal.event("preempt.signal", signum=int(signum))
        print(
            f"[tadnn] received signal {signum}: draining — will "
            f"checkpoint and exit after the current step",
            file=sys.stderr, flush=True,
        )
        # compose with an outer supervisor: chain to whatever handler
        # was installed before us (SIG_DFL/SIG_IGN are ints, skipped)
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def request(self) -> None:
        """Trip the drain flag programmatically (tests, cluster agents)."""
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                self._signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def run_with_recovery(
    fit: Callable[[], Any],
    *,
    max_restarts: int = 2,
    retriable: tuple[type[BaseException], ...] = (
        RuntimeError,  # wedged runtime / hung collective / Injected/Stall
        OSError,       # lost shared storage, dropped connections
        TimeoutError,
    ),
    on_restart: Callable[[int, BaseException], None] | None = None,
    policy: RestartPolicy | None = None,
) -> Any:
    """Invoke ``fit`` and restart it after retriable failures.

    ``fit`` must be resumable — e.g. a closure over ``Trainer.fit`` with a
    CheckpointManager, which restores the latest intact checkpoint on
    re-entry (restore_or_init).

    ``policy`` (resilience.RestartPolicy) adds exponential backoff with
    deterministic jitter and a restart budget over a rolling window; it
    owns ``max_restarts`` when given.  Without one, the legacy behavior
    is kept: up to ``max_restarts`` immediate retries (no backoff, no
    window — every failure counts forever).  StallError from the
    watchdog-escalation hook (trainer ``watchdog_escalate``) is a
    RuntimeError, so a hung run killed by its own watchdog lands on
    this same retriable path.

    The default ``retriable`` set covers infrastructure-style failures
    only: deterministic errors — the trainer's NaN guard
    (FloatingPointError), shape/value errors — would replay identical
    batches to an identical failure under step-indexed data, wasting
    ``max_restarts`` compile+restore cycles.  Widen explicitly (e.g.
    ``retriable=(Exception,)``) if your data source is nondeterministic
    and a retry can genuinely change the outcome.
    """
    if policy is None:
        # legacy semantics: immediate retries, budget over all time
        policy = RestartPolicy(max_restarts=max_restarts,
                               window_s=float("inf"),
                               backoff_base_s=0.0, jitter=0.0)
    attempt = 0
    while True:
        try:
            return fit()
        except retriable as e:
            attempt += 1
            gave_up = policy.note_failure()
            delay = 0.0 if gave_up else policy.delay_s(attempt)
            obs_journal.event(
                "elastic.restart", attempt=attempt,
                max_restarts=policy.max_restarts,
                window_failures=policy.recent_failures,
                delay_s=delay,
                error=f"{type(e).__name__}: {e}",
                gave_up=gave_up,
            )
            if gave_up:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            elif process_index() == 0:
                print(f"[tadnn elastic] restart {attempt}"
                      f"/{policy.max_restarts} (window "
                      f"{policy.recent_failures}) after "
                      f"{type(e).__name__}: {e}"
                      + (f"; backing off {delay:.2f}s" if delay else ""),
                      file=sys.stderr, flush=True)
            if delay > 0:
                policy.sleep(delay)
