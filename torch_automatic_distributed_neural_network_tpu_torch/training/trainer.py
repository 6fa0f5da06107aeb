"""Training loop with metrics, checkpointing and debug guards (the JAX
package's ``training/trainer.py`` over the port's ``AutoDistribute``,
one device a process, one process or several).

The loop is deliberately thin: ``AutoDistribute.step`` is the hot path;
everything here runs on the host between steps and touches device data
as rarely as possible (the loss is fetched every ``log_every`` steps, or
every step when ``anomaly`` is on), so the card keeps running ahead of
the host.

Guards:

- NaN/Inf loss detection with a configurable action (raise/warn);
- anomaly rollback (``cfg.anomaly``): rolling loss statistics; on a
  spike or NaN the last verified checkpoint is restored and the
  offending batch window skipped (resilience.py) — recovery instead of
  a crash, deterministic under step-indexed data;
- the cross-process parameter-divergence check (``divergence_every``):
  every rank sums |param| in fp32 over the whole of each parameter (a
  sharded one reduced over its shards first, so replicas compare the
  same global value) and the sums are all-gathered and held equal to
  rtol 1e-6; a no-op on one process, as in the JAX package;
- the preemption drain agrees across processes: the ranks OR their
  SIGTERM flags by an all-gather every ``preempt_check_every`` steps, on
  the same schedule everywhere, and stop after the same step.  These
  agreements run on CPU tensors over a gloo group
  (``utils.device.host_group``);
- determinism: the per-step dropout generators derive from the state's
  seed and step counter, so restarts reproduce;
- profiler-traced steps: every ``trace_every_n``-th step after the
  first runs under a ``torch.profiler`` capture (``obs.trace``), fenced,
  journaled as ``trace.step``; its wall time goes to goodput's ``trace``
  bucket.  A failed capture journals ``trace.error`` and keeps the
  step's result, as in the JAX package.
- preflight: before step 0 the static plan + graph + memory + dtype
  lint (``analysis.preflight``: the step traced on fake tensors, nothing
  runs) journals its findings and memory estimate;
  ``preflight_action="raise"`` turns an error finding (a predicted OOM
  against ``preflight_budget``) into :class:`analysis.PreflightError`,
  and an analyzer crash journals ``lint.skipped`` and never blocks
  training.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Any, Callable, Iterable

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..obs import GoodputMeter
from ..obs import journal as obs_journal
from ..utils.device import (
    host_allgather,
    is_dtensor,
    process_count,
    process_index,
)
from .checkpoint import (
    RESTORE_ERRORS,
    CheckpointManager,
    agreed_latest_step,
    restore_or_init,
)
from .metrics import MetricsLogger
from .resilience import (
    AnomalyConfig,
    AnomalyGuard,
    CheckpointCorruptError,
    StallError,
    describe_error,
)

if TYPE_CHECKING:  # runtime import would be circular (core -> training)
    from ..core import AutoDistribute, TrainState
    from ..obs import Journal

@dataclasses.dataclass
class TrainerConfig:
    steps: int = 1000
    log_every: int = 10
    ckpt_every: int = 0  # 0 = no checkpointing
    nan_action: str = "raise"  # 'raise' | 'warn' | 'ignore'
    divergence_every: int = 0  # 0 = off; N = check params hash every N
    # None = off; AnomalyConfig() = rollback-on-loss-anomaly (checks the
    # loss every step, which syncs host and device — resilience.py)
    anomaly: AnomalyConfig | None = None
    watchdog_timeout_s: float = 0.0  # 0 = off; stall detector (elastic.py)
    # escalate a watchdog stall into a StallError raised in the training
    # thread, feeding run_with_recovery's retriable path instead of only
    # reporting to stderr
    watchdog_escalate: bool = False
    heartbeat_dir: str = ""  # "" = off; shared-dir liveness beats
    # heartbeat cadence; the launcher's watchdog grace must be a few
    # multiples of this, so fast smoke runs shrink both together
    heartbeat_interval_s: float = 10.0
    # heartbeat host id; None = the torch.distributed rank (0 alone)
    heartbeat_host: "int | None" = None
    eval_every: int = 0  # 0 = off; run evaluate(eval_data) every N steps
    eval_batches: int = 8  # batches per periodic evaluation
    preempt_drain: bool = True  # SIGTERM -> checkpoint + clean return
    # the drain agreement across processes is a host-blocking all-gather,
    # amortized to every N steps (the same on every rank: a local flag
    # never starts an all-gather off the schedule, or the ranks hang).
    # Drain latency is then up to N step times, which must fit the
    # preemptor's grace window.  One process checks its flag every step.
    preempt_check_every: int = 8
    # static plan/graph/mem/dtype lint (analysis.preflight) before
    # step 0: trace-only, nothing runs
    preflight: bool = True
    preflight_action: str = "warn"  # 'warn' | 'raise'
    # memory budget for the preflight's memory layer (bytes or '16GiB');
    # None = the detected chip's ChipSpec.  With preflight_action='raise',
    # a predicted OOM (ML001) aborts before step 0.
    preflight_budget: "int | str | None" = None
    # lint codes the preflight suppresses (e.g. ('PL005',)); unknown
    # codes raise, as in `tadnn check --ignore`
    preflight_ignore: "tuple[str, ...]" = ()
    # profile every Nth steady-state step with obs/trace (0 = off).  The
    # traced step is fenced under a torch.profiler capture, so its wall
    # time lands in the 'trace' goodput bucket, never 'step'.  Defaults
    # from TADNN_TRACE_EVERY_N so `tadnn trace <script.py>` can
    # instrument an unmodified training script.
    trace_every_n: int = dataclasses.field(
        default_factory=lambda: _env_int("TADNN_TRACE_EVERY_N"))
    trace_dir: str = ""  # profiler logdir ("" = a fresh temp dir per trace)


def _env_int(name: str) -> int:
    try:
        return int(os.environ.get(name, "0") or 0)
    except ValueError:
        return 0


def _is_step_indexed(data: Any) -> bool:
    """Step-indexed source: declares ``step_indexed = True`` and has a
    ``.batch(i)`` method (an explicit marker — ``.batch(n)`` on common
    iterables like tf.data means a batch-size transform)."""
    return bool(getattr(data, "step_indexed", False)) and callable(
        getattr(data, "batch", None)
    )


class Trainer:
    def __init__(
        self,
        ad: "AutoDistribute",
        cfg: "TrainerConfig | None" = None,
        *,
        metrics: MetricsLogger | None = None,
        ckpt: CheckpointManager | None = None,
        items_per_step: int | None = None,
        run_config: dict | None = None,
        callbacks: "list[Callable[[int, TrainState, dict], None]] | None" = None,
        eval_data: Any = None,
        journal: "Journal | None" = None,
    ):
        self.ad = ad
        self.cfg = cfg if cfg is not None else TrainerConfig()
        self.metrics = metrics
        self.ckpt = ckpt
        self.items_per_step = items_per_step
        self.run_config = run_config
        self.callbacks = list(callbacks or [])
        self.eval_data = eval_data
        self.journal = journal  # installed as the default sink during fit()
        self.goodput: dict | None = None  # last fit()'s wall-clock breakdown
        self.preempt = None  # PreemptionGuard, installed during fit()
        self._batch_offset = 0  # anomaly rollback's batch-window skip

    def evaluate(
        self, data: Any, n_batches: int, *, state: "TrainState",
    ) -> dict:
        """Mean forward-only metrics over ``n_batches`` of ``data``
        (step-indexed source or iterable) using ``ad.eval_step`` —
        deterministic (no dropout), no optimizer/state mutation."""
        indexed = _is_step_indexed(data)
        it = None if indexed else iter(data)
        totals: dict[str, float] = {}
        n = 0
        for i in range(n_batches):
            try:
                batch = data.batch(i) if indexed else next(it)
            except StopIteration:
                break
            m = self.ad.eval_step(state, batch)
            for k, v in m.items():
                try:
                    totals[k] = totals.get(k, 0.0) + float(v)
                except (TypeError, ValueError):
                    pass
            n += 1
        if n == 0:
            import warnings

            warnings.warn(
                "evaluate() got no batches — a one-shot eval_data "
                "iterator is exhausted; pass a step-indexed source or a "
                "re-iterable so periodic eval keeps data",
                stacklevel=2,
            )
        return {f"eval_{k}": v / max(n, 1) for k, v in totals.items()}

    def fit(
        self,
        data: "Iterable[Any] | Any",
        *,
        rng: torch.Generator | None = None,
        state: "TrainState | None" = None,
    ) -> "TrainState":
        """Run the training loop.

        ``rng``: the generator a fresh init draws the weights from
        (default: seed 0 on the trainer's device, as the JAX package's
        ``key(0)``); ``state``: start from this state instead of
        restoring or initializing one.

        ``data`` is either an iterable of batches or a step-indexed source
        (``step_indexed = True`` and a ``.batch(i)`` method, like the
        data.synthetic classes — an explicit marker, because ``.batch(n)``
        on common iterables like tf.data means a batch-size transform).
        Prefer step-indexed with checkpointing: a resumed run then sees
        exactly the batches an uninterrupted run would have seen at each
        step (elastic parity, SURVEY.md §5); a plain iterator restarts
        from its beginning on resume.

        Observability: ``self.journal`` (when given) is installed as the
        process-global journal for the duration, so checkpoint spans and
        elastic events land in one file; wall-clock is bucketed into a
        goodput breakdown (``self.goodput``, also journaled as a
        ``goodput`` event).
        """
        with obs_journal.as_default(self.journal):
            try:
                return self._fit(data, rng=rng, state=state)
            finally:
                if self.metrics:
                    # run teardown owns the JSONL handle (metrics.close
                    # is idempotent; a later fit() just loses file
                    # logging, never crashes)
                    self.metrics.close()

    def _preflight(self, batch: Any, rng=None) -> None:
        """Static plan + graph + memory + dtype lint against the built
        plan and a trace of the step on fake tensors
        (``analysis.preflight``) — nothing is allocated or executed.
        ``preflight_action='warn'`` prints findings and continues;
        ``'raise'`` escalates error-severity findings (including a
        predicted OOM against ``preflight_budget``) to
        :class:`analysis.PreflightError`.  A crash in the analyzer
        itself never blocks training."""
        from .. import analysis

        try:
            findings = analysis.preflight(
                self.ad, batch, rng=rng,
                budget=self.cfg.preflight_budget,
                ignore=self.cfg.preflight_ignore,
            )
        except Exception as e:
            obs_journal.event("lint.skipped", phase="preflight",
                              layer="preflight",
                              error=f"{type(e).__name__}: {e}")
            return
        if findings and process_index() == 0:
            for f in findings:
                print(f"preflight: {f.format()}", file=sys.stderr)
        if self.cfg.preflight_action == "raise" and any(
                f.severity == analysis.ERROR for f in findings):
            raise analysis.PreflightError(findings)

    def _fit(
        self,
        data: "Iterable[Any] | Any",
        *,
        rng: torch.Generator | None = None,
        state: "TrainState | None" = None,
    ) -> "TrainState":
        cfg = self.cfg
        meter = GoodputMeter()
        indexed = _is_step_indexed(data)
        data_iter = None if indexed else iter(data)
        first = None
        resumed = False
        self._batch_offset = 0  # advanced by anomaly rollbacks (skip window)
        if state is None:
            with meter.measure("input_stall"):
                try:
                    first = data.batch(0) if indexed else next(data_iter)
                except StopIteration:
                    raise ValueError("data is empty: the iterator yielded "
                                     "no batches") from None
            if rng is None:
                rng = torch.Generator(device=self.ad.device).manual_seed(0)
            # init + (maybe) checkpoint restore: warm-up, one bucket
            with meter.measure("compile"):
                state, resumed = restore_or_init(
                    self.ad, self.ckpt, rng, first
                )
            start = int(state.step)
            if resumed:
                # a prior run's anomaly rollback shifted the batch
                # schedule; resume must replay the same shift or the
                # trajectories diverge (saved by _ckpt_config)
                saved_cfg = self.ckpt.restore_config(start)
                if saved_cfg and saved_cfg.get("_batch_offset"):
                    self._batch_offset = int(saved_cfg["_batch_offset"])
                if process_index() == 0:
                    print(f"resumed from step {start}")
        else:
            start = int(state.step)
        if cfg.preflight:
            pf_batch = first
            if pf_batch is None and indexed:
                try:
                    pf_batch = data.batch(start + self._batch_offset)
                except Exception:
                    pf_batch = None
            if pf_batch is not None:
                # shares the compile bucket: trace-time work before step 0
                with meter.measure("compile"):
                    self._preflight(pf_batch, rng)
        from ..core import mesh_degrees

        plan = self.ad.plan
        obs_journal.event(
            "run_start", start_step=start, steps=cfg.steps, resumed=resumed,
            strategy=(plan.strategy if plan else None),
            mesh=(mesh_degrees(plan.mesh) if plan else None),
        )
        last_done = start

        from .elastic import Heartbeat, PreemptionGuard, StepWatchdog

        # The watchdog is armed after the first step completes: the first
        # step builds the CUDA kernels at first use (tens of seconds),
        # which a steady-state timeout would misreport as a stall.
        watchdog: StepWatchdog | None = None
        on_stall = (self._stall_escalator() if cfg.watchdog_escalate
                    else None)
        guard = AnomalyGuard(cfg.anomaly) if cfg.anomaly else None
        heartbeat = (Heartbeat(cfg.heartbeat_dir,
                               interval_s=cfg.heartbeat_interval_s,
                               host_index=cfg.heartbeat_host).start()
                     if cfg.heartbeat_dir else None)
        self.preempt = (PreemptionGuard().install()
                        if cfg.preempt_drain else None)
        exhausted = False
        try:
            if self.metrics:
                self.metrics.start_step()
            if start < cfg.steps:
                try:
                    if not indexed:
                        batch = (first if first is not None
                                 else next(data_iter))
                    elif start == 0 and first is not None:
                        # _batch_offset is necessarily 0 here (a shifted
                        # resume has start > 0), so first == batch(0)
                        batch = first
                    else:
                        batch = data.batch(start + self._batch_offset)
                except StopIteration:
                    obs_journal.event("data_exhausted", step=start,
                                      saved=False)
                    return state
            pending_done = None
            i = start
            while i < cfg.steps:
                # traced steps skip i == start: the first step builds the
                # kernels and would profile the build, not the step
                traced = bool(cfg.trace_every_n and i != start
                              and (i - start) % cfg.trace_every_n == 0)
                t0 = time.perf_counter()
                if traced:
                    state, step_metrics = self._traced_step(state, batch, i)
                else:
                    state, step_metrics = self.ad.step(state, batch)
                dur = time.perf_counter() - t0
                # the first step of a fit builds the kernels at first use
                # and warms cuBLAS and the allocator: warm-up, not goodput;
                # a traced step is fenced and profiled: overhead, not goodput
                meter.add("compile" if i == start
                          else ("trace" if traced else "step"), dur)
                last_done = i + 1
                if guard is not None:
                    rolled = self._maybe_rollback(guard, state, step_metrics,
                                                  i, indexed)
                    if rolled is not None:
                        state, i = rolled
                        last_done = i
                        batch = data.batch(i + self._batch_offset)
                        continue
                if i + 1 < cfg.steps:
                    try:
                        with meter.measure("input_stall"):
                            batch = (data.batch(i + 1 + self._batch_offset)
                                     if indexed else next(data_iter))
                    except StopIteration:
                        # plain iterator ran dry mid-run: finish this
                        # step's bookkeeping, then save + return cleanly
                        # at the bottom of the loop body
                        exhausted = True
                if cfg.watchdog_timeout_s:
                    # Beat on step *completion*, not dispatch — a hung
                    # kernel must stop the beats (elastic.py).  Wait for
                    # the PREVIOUS step: step i is already enqueued, so
                    # waiting for i-1 keeps one step of host/device
                    # overlap instead of serializing the launches.
                    if pending_done is not None:
                        with meter.measure("step"):
                            pending_done()
                        if watchdog is None:
                            watchdog = StepWatchdog(
                                cfg.watchdog_timeout_s, on_stall=on_stall
                            ).start()
                        watchdog.beat()
                    pending_done = self._done_marker()
                if heartbeat:
                    heartbeat.set_step(i + 1)
                if cfg.log_every and (
                    i % cfg.log_every == 0 or i == cfg.steps - 1
                ):
                    self._guard_nan(step_metrics, i)
                    if self.metrics:
                        self.metrics.log_step(
                            i, step_metrics, self.items_per_step or 0
                        )
                if cfg.divergence_every and i % cfg.divergence_every == 0:
                    self._guard_divergence(state, i)
                slow_block = False
                if (
                    cfg.eval_every and self.eval_data is not None
                    and (i + 1) % cfg.eval_every == 0
                ):
                    with meter.measure("eval"):
                        ev = self.evaluate(
                            self.eval_data, cfg.eval_batches, state=state
                        )
                    slow_block = True
                    if self.metrics:
                        self.metrics.log_eval(i + 1, ev)
                    elif process_index() == 0:
                        print(f"step {i + 1} " + "  ".join(
                            f"{k} {v:.4f}" for k, v in ev.items()))
                if (
                    self.ckpt and cfg.ckpt_every
                    and (i + 1) % cfg.ckpt_every == 0
                ):
                    with meter.measure("checkpoint"):
                        self.ckpt.save(i + 1, state,
                                       config=self._ckpt_config())
                    slow_block = True
                for cb in self.callbacks:
                    cb(i + 1, state, step_metrics)
                if self.preempt is not None and self._drain_agreed(i + 1):
                    # graceful drain: save where we are and return; the
                    # recovery path (restore_or_init / run_with_recovery)
                    # resumes from exactly this step on the next start
                    obs_journal.event("preempt.drain", step=i + 1,
                                      saved=bool(self.ckpt))
                    if self.ckpt:
                        # the periodic block above may have saved this
                        # very step; the manager refuses to overwrite it
                        with meter.measure("checkpoint"):
                            if self.ckpt.latest_step() != i + 1:
                                self.ckpt.save(i + 1, state,
                                               config=self._ckpt_config(),
                                               force=True)
                            self.ckpt.wait()
                    if process_index() == 0:
                        print(f"preemption drain: stopped after step "
                              f"{i + 1}"
                              + (", checkpoint saved" if self.ckpt
                                 else " (no checkpoint manager)"))
                    return state
                if slow_block and self.metrics:
                    # eval/checkpoint wall time must not bleed into the
                    # next training record's step_time/MFU
                    self.metrics.start_step()
                if exhausted:
                    obs_journal.event("data_exhausted", step=i + 1,
                                      saved=bool(self.ckpt))
                    if self.ckpt:
                        with meter.measure("checkpoint"):
                            if self.ckpt.latest_step() != i + 1:
                                self.ckpt.save(i + 1, state,
                                               config=self._ckpt_config(),
                                               force=True)
                            self.ckpt.wait()
                    if process_index() == 0:
                        print(f"data exhausted after step {i + 1}"
                              + (", checkpoint saved" if self.ckpt
                                 else " (no checkpoint manager)"))
                    return state
                i += 1
            if cfg.watchdog_timeout_s and pending_done is not None:
                # flush the lag-one beat: the final step (the only step,
                # when resuming one short of cfg.steps) must arm/beat the
                # watchdog so a hang in the closing save/wait is detected
                with meter.measure("step"):
                    pending_done()
                if watchdog is None:
                    watchdog = StepWatchdog(cfg.watchdog_timeout_s,
                                            on_stall=on_stall).start()
                watchdog.beat()
            if self.ckpt and cfg.ckpt_every:
                with meter.measure("checkpoint"):
                    if self.ckpt.latest_step() != cfg.steps:
                        self.ckpt.save(cfg.steps, state,
                                       config=self._ckpt_config(),
                                       force=True)
                    self.ckpt.wait()
        finally:
            if watchdog:
                watchdog.stop()
            if heartbeat:
                heartbeat.stop()
            if self.preempt is not None:
                self.preempt.uninstall()
            if self.ckpt:
                # barrier for in-flight async saves: a recovery restart
                # must not race the pending commit (elastic.py)
                with meter.measure("checkpoint"):
                    self.ckpt.wait()
            summary = meter.summary()
            self.goodput = summary
            obs_journal.event("goodput", **summary)
            # the port runs the step eagerly: it traces and compiles
            # nothing (the kernels it builds are counted nowhere here)
            obs_journal.event("run_end", stop_step=last_done, n_compiles=0,
                              recompiles=0, export=None)
        return state

    def _traced_step(self, state, batch, i: int):
        """One profiler-instrumented step (cfg.trace_every_n): capture a
        device timeline around it and journal the ``trace.step``
        attribution record.  A profiler failure falls back to the plain
        step — tracing must never take down training."""
        from ..obs import trace as obs_trace

        captured = {}

        def step_fn(s, b):
            out = self.ad.step(s, b)
            captured["out"] = out
            return out

        try:
            state, _ = obs_trace.trace_steps(
                step_fn, state, batch, steps=1, first_step=i,
                flops_per_step=(self.metrics.flops_per_step
                                if self.metrics else None),
                logdir=self.cfg.trace_dir or None,
                device=self.ad.device,
            )
            return state, captured["out"][1]
        except Exception as e:  # noqa: BLE001 — any capture failure
            obs_journal.event("trace.error", step=i,
                              error=f"{type(e).__name__}: {e}")
            if "out" in captured:
                # the step itself ran; only the capture/attribution died.
                # Reuse its result: the step updated the state in place
                return captured["out"]
            return self.ad.step(state, batch)

    def _done_marker(self):
        """A callable that returns once the step just enqueued is done
        on the device (a CUDA event; on the CPU the step already is)."""
        if self.ad.device.type != "cuda":
            return lambda: None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.ad.device))
        return ev.synchronize

    def _ckpt_config(self) -> dict | None:
        """run_config to store with a checkpoint; carries the anomaly
        rollback's batch-offset so a resumed run replays the same
        (shifted) batch schedule."""
        if not self._batch_offset:
            return self.run_config
        return {**(self.run_config or {}),
                "_batch_offset": self._batch_offset}

    def _stall_escalator(self):
        """on_stall callback that raises StallError *in the training
        thread*: the loop is blocked inside a hung dispatch, so the
        watchdog thread plants an async exception that surfaces at the
        next bytecode boundary and feeds run_with_recovery's retriable
        path (elastic.py)."""
        import ctypes

        import threading

        tid = threading.get_ident()  # the thread running fit()

        def escalate(age_s: float) -> None:
            obs_journal.event("resilience.stall_escalation", age_s=age_s,
                              timeout_s=self.cfg.watchdog_timeout_s)
            print(
                f"[tadnn watchdog] escalating stall ({age_s:.1f}s) to "
                f"StallError in the training thread",
                file=sys.stderr, flush=True,
            )
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(StallError)
            )

        return escalate

    def _maybe_rollback(
        self, guard: AnomalyGuard, state: "TrainState",
        step_metrics: dict, i: int, indexed: bool,
    ) -> "tuple[TrainState, int] | None":
        """Anomaly check for the step just taken; on anomaly, restore
        the last verified checkpoint and shift the batch schedule past
        the offending window.  Returns (restored_state, resume_i) to
        roll back, None to continue.  Raises when rollback is
        impossible (no checkpoint / plain iterator / budget spent) —
        the legacy nan-guard crash semantics."""
        loss = step_metrics.get("loss")
        if loss is None:
            return None
        reason = guard.check(float(loss))  # device sync, documented
        if reason is None:
            return None
        anomaly_step = i + 1  # the step the bad batch produced
        can = self.ckpt is not None and indexed
        if can:
            guard.rollbacks += 1
        if not can or guard.rollbacks > self.cfg.anomaly.max_rollbacks:
            raise FloatingPointError(
                f"loss anomaly ({reason}) at step {anomaly_step} and "
                + ("rollback budget exhausted "
                   f"({self.cfg.anomaly.max_rollbacks})" if can else
                   "no rollback path (needs a CheckpointManager and "
                   "step-indexed data)")
            )
        self.ckpt.wait()  # in-flight saves must commit before we walk
        restored, r = self._restore_last_verified(state)
        if restored is None:
            raise FloatingPointError(
                f"loss anomaly ({reason}) at step {anomaly_step} and no "
                "intact checkpoint to roll back to"
            )
        skipped = anomaly_step - r
        self._batch_offset += skipped
        obs_journal.event(
            "resilience.rollback", reason=reason, loss=float(loss),
            at_step=anomaly_step, to_step=r, skipped_batches=skipped,
            batch_offset=self._batch_offset, rollback=guard.rollbacks,
        )
        if process_index() == 0:
            print(f"[tadnn] loss anomaly ({reason}) at step "
                  f"{anomaly_step}: rolled back to step {r}, skipping "
                  f"{skipped} batch(es)", file=sys.stderr, flush=True)
        return restored, r

    def _restore_last_verified(
        self, state: "TrainState",
    ) -> "tuple[TrainState | None, int | None]":
        """Walk the fallback chain newest→oldest with verification,
        quarantining corrupt steps (restore_or_init's walk, the ranks
        together, written into the live state's tensors)."""
        while True:
            step = agreed_latest_step(self.ckpt)
            if step is None:
                return None, None
            try:
                restored = self.ckpt.restore(state, step=step)
            except (CheckpointCorruptError, *RESTORE_ERRORS) as e:
                self.ckpt.quarantine(step, reason=describe_error(e))
                continue
            self.ad.adopt_state(restored)
            return restored, step

    def _drain_agreed(self, step: int) -> bool:
        """Cross-process agreement on the preemption drain.

        Each process sees only its own SIGTERM, and signals can land on
        opposite sides of a step boundary: the ranks must agree on WHICH
        step to stop after, or they run mismatched collectives and hang.
        One process: the local flag.  Several: an all-gather OR of the
        flags on a deterministic schedule (every ``preempt_check_every``
        steps, identical on every rank, so they stay in lockstep)."""
        if process_count() == 1:
            return self.preempt.requested
        every = max(1, self.cfg.preempt_check_every)
        if step % every != 0:
            return False
        return any(host_allgather(bool(self.preempt.requested)))

    # -- guards -------------------------------------------------------------

    def _guard_nan(self, metrics: dict, step: int) -> None:
        if self.cfg.nan_action == "ignore":
            return
        loss = metrics.get("loss")
        if loss is None:
            return
        val = float(loss)
        if math.isfinite(val):
            return
        msg = f"Non-finite loss {val} at step {step}"
        if self.cfg.nan_action == "raise":
            raise FloatingPointError(msg)
        import warnings

        warnings.warn(msg)

    def _guard_divergence(self, state: "TrainState", step: int) -> None:
        """Cross-process parameter agreement (several processes only): the
        sum of |param| in fp32 over every parameter, a sharded one summed
        over its shards first (``full_tensor`` of the partial sums, as
        JAX's ``jnp.sum`` of a global array), all-gathered and held equal
        to rtol 1e-6."""
        if process_count() == 1:
            return
        with torch.no_grad():
            total = torch.zeros((), dtype=torch.float32)
            for p in state.params.values():
                s = p.detach().float().abs().sum()
                if is_dtensor(s):
                    s = s.full_tensor()
                total = total + s.cpu()
        gathered = np.asarray(host_allgather(float(total)))
        if not np.allclose(gathered, gathered[0], rtol=1e-6):
            raise RuntimeError(
                f"Parameter divergence across hosts at step {step}: "
                f"{gathered}")

