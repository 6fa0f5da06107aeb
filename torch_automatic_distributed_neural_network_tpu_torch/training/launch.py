"""Elastic multi-process launcher (``tadnn launch``; the JAX package's
``training/launch.py``).

The **launcher** (:class:`Launcher`, run in a plain supervisor process
that never touches a CUDA device) spawns N worker processes, one device
each, which form one ``torch.distributed`` process group — NCCL with the
card ``LOCAL_RANK`` names (the default), or gloo on the CPU when the
caller asks for it (``simulate=True``) — and supervises them across failures:

- **liveness** comes from the workers' Heartbeat files (pid + monotonic
  stamp): a worker whose heartbeat step stops advancing past the
  watchdog grace is hung (a collective wedged after a peer died), a
  worker whose process exits non-zero is dead;
- **recovery** is cohort-granular: any worker death or hang kills the
  whole cohort (survivors are blocked in collectives with a dead peer
  anyway), charges the :class:`resilience.RestartPolicy` budget, and
  respawns — workers resume from the last committed sharded checkpoint
  (``training/shards.py``) through the Trainer's ``restore_or_init``;
- **elasticity**: with ``elastic=True`` a host death shrinks the next
  cohort to the surviving world size; the respawned workers re-plan
  (``strategy='auto'``) at the new world, and the resharding restore
  re-slices the old world's shards onto the new plan;
- **chaos**: the ChaosPlan's process-boundary faults — SIGKILL right
  after a step (latched once a launch), partitioning a host's journal,
  tearing a per-host shard file — keyed on observed heartbeat steps, so
  runs are seeded and reproducible.

Workers train the JAX package's launcher workload (GPT-2 ``test`` at
vocab 512, seq 33, batch 16, SGD at 0.1) on step-indexed synthetic data,
each on its own rows (``data.shard_for_host``), so a resumed run replays
exactly the batches an uninterrupted run would have seen: the
acceptance bar is **bitwise-identical** per-step losses between a chaos
run and a clean run (``Launcher.run`` returns them; ``--smoke``
compares the two end to end).

A deliberate difference from the JAX package: its CPU backend cannot
run computations across processes, so a simulated JAX cohort is made of
*logical* hosts that each compute the whole trajectory; here the
simulated cohort is a real gloo process group, and every collective
runs between the workers.

Per-host journals land as ``journal_host<i>.jsonl`` in the launch dir
and are merged (``obs.aggregate``) at the end; the launcher's own events
(``launch.*``) go to ``journal_launcher.jsonl``.  ``launch_doctor``
reads the heartbeats and the persisted ``launch_state.json`` for
``doctor --launch-dir``.

**The export cache** (``export_cache``, ``export/``): the cohort shares
one cache directory (``TADNN_EXPORT_CACHE`` in the workers' environment,
``--export-cache`` on their command line), so every worker's
``AutoDistribute.init`` goes cache-first on the kernel libraries its
step launches, and a restarted cohort installs them instead of running
``nvcc``.  With ``elastic=True`` the launcher also prewarms the nearest
shrink worlds in the background (a ``--prewarm`` process per world:
``AutoDistribute.export_step(world=N)`` stores the entry under the key
an N-worker cohort looks up), so a scale-down restart opens on
``export.hit``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from typing import Any

from ..obs import journal as obs_journal
from . import shards
from .resilience import ChaosPlan, RestartPolicy

_PKG = "torch_automatic_distributed_neural_network_tpu_torch"

HEARTBEAT_DIRNAME = "heartbeats"
CKPT_DIRNAME = "ckpt"
STATE_FILE = "launch_state.json"


@dataclasses.dataclass
class LaunchConfig:
    """One launch: world shape, training length, failure budget, chaos."""

    launch_dir: str
    hosts: int = 1  # worker processes, one device each
    steps: int = 8
    ckpt_every: int = 2
    strategy: str = "auto"  # 'auto' re-plans per cohort
    zero1: bool = False
    seed: int = 0
    max_restarts: int = 2
    elastic: bool = False  # shrink the cohort after a host death
    min_hosts: int = 1
    watchdog_s: float = 120.0  # no step progress within this -> hung
    spawn_grace_s: float = 300.0  # import + kernel build before first beat
    heartbeat_interval_s: float = 0.5
    round_timeout_s: float = 900.0
    worker_restarts: int = 0  # in-process run_with_recovery budget
    chaos: ChaosPlan | None = None
    simulate: bool = False  # NCCL, a card a worker; True: gloo on the CPU
    # the cohort's export cache dir (export/): workers go cache-first on
    # their kernels' build, restarted cohorts hit instead of rebuilding,
    # and with elastic=True the likely shrink worlds are prewarmed
    export_cache: str | None = None
    # worker model/data (the launcher workload; small on purpose)
    vocab_size: int = 512
    seq_len: int = 33
    batch_size: int = 16
    lr: float = 0.1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _worker_env(cfg: LaunchConfig, rank: int) -> dict:
    """A worker's environment: the package importable, one card a worker
    by ``LOCAL_RANK`` (one host), NCCL errors raised rather than hung
    on, one CPU thread a worker on the simulated (CPU) cohort."""
    env = dict(os.environ)
    root = _repo_root()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [root, env.get("PYTHONPATH", "")] if p)
    env["LOCAL_RANK"] = str(rank)
    env["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "1"
    if cfg.simulate:
        env["OMP_NUM_THREADS"] = "1"
    if cfg.export_cache:
        env["TADNN_EXPORT_CACHE"] = os.path.expanduser(cfg.export_cache)
    return env


def read_heartbeats(launch_dir: str) -> dict[int, dict]:
    """Per-host heartbeat records from the launch dir (elastic.Heartbeat
    format: host, step, time, pid, mono), read without touching a
    device, so the supervisor process stays light."""
    d = os.path.join(launch_dir, HEARTBEAT_DIRNAME)
    beats: dict[int, dict] = {}
    if not os.path.isdir(d):
        return beats
    for name in os.listdir(d):
        m = re.fullmatch(r"host_(\d+)\.json", name)
        if not m:
            continue
        try:
            with open(os.path.join(d, name)) as f:
                beats[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue  # mid-replace or torn — next poll sees it
    return beats


class Launcher:
    """Spawn and supervise a worker cohort (module docstring)."""

    def __init__(self, cfg: LaunchConfig):
        if not cfg.simulate:
            import torch

            if not torch.cuda.is_available():  # makes no CUDA context
                raise RuntimeError(
                    "NCCL workers need a card a worker (the default) but "
                    "torch.cuda.is_available() is False; pass "
                    "simulate=True (--simulate) for gloo workers on the CPU")
        self.cfg = cfg
        self.launch_dir = os.path.abspath(cfg.launch_dir)
        os.makedirs(self.launch_dir, exist_ok=True)
        self.policy = RestartPolicy(max_restarts=cfg.max_restarts,
                                    backoff_base_s=0.05, backoff_max_s=1.0,
                                    seed=cfg.seed)
        self.journal = obs_journal.Journal(
            os.path.join(self.launch_dir, "journal_launcher.jsonl"),
            host0_only=False, meta={"role": "launcher"})
        self._chaos_fired: set[tuple[str, int]] = set()
        self._prewarm_procs: list[subprocess.Popen] = []
        self._prewarmed: set[int] = set()
        self._state: dict = {
            "max_restarts": cfg.max_restarts,
            "restarts_used": 0,
            "rounds": [],
            "world_history": [],
            "last_failure": None,
            "done": False,
            "ok": None,
        }

    # -- state persistence (doctor --launch-dir reads this) ----------------

    def _save_state(self) -> None:
        path = os.path.join(self.launch_dir, STATE_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._state, f, indent=1)
        os.replace(tmp, path)

    # -- chaos --------------------------------------------------------------

    def _fire_chaos(self, beats: dict[int, dict],
                    checked: dict[str, int]) -> None:
        """Evaluate the plan's orchestrator faults against each newly
        observed step of the chaos host — every (kind, step) at most
        once per launcher run, so a resumed cohort replaying the
        trigger step isn't re-killed forever."""
        plan = self.cfg.chaos
        if plan is None:
            return
        host = int(plan.chaos_host)
        observed = int(beats.get(host, {}).get("step", -1))
        for kind in ChaosPlan.ORCHESTRATOR_KINDS:
            if kind == "sigkill":
                continue  # delegated to the worker at spawn (_spawn):
                # polling heartbeats can't land a kill right after a step
            for step in range(checked.get(kind, 0), observed + 1):
                if (kind, step) in self._chaos_fired:
                    continue
                if not plan.fires(kind, step):
                    continue
                if self._apply_chaos(kind, step, host):
                    self._chaos_fired.add((kind, step))
            # shard_tear stays pending until a committed step exists to
            # tear; the others are consumed up to the observed step
            if kind != "shard_tear":
                checked[kind] = max(checked.get(kind, 0), observed + 1)

    def _sigkill_schedule(self) -> list[int]:
        """The chaos plan's SIGKILL steps, resolved ahead of time (the
        explicit ``sigkill_at`` list and the seeded ``p_sigkill`` draws)
        so the chaos host can execute them at exactly the scheduled
        step.  Latch markers in the launch dir keep each kill
        once-per-launch across cohort restarts."""
        plan = self.cfg.chaos
        if plan is None or (not plan.sigkill_at and plan.p_sigkill <= 0):
            return []
        return [s for s in range(1, self.cfg.steps + 1)
                if plan.fires("sigkill", s)]

    def _apply_chaos(self, kind: str, step: int, host: int) -> bool:
        if kind == "journal_partition":
            src = os.path.join(self.launch_dir, f"journal_host{host}.jsonl")
            dst = src.replace(".jsonl", ".partitioned")
            try:
                os.replace(src, dst)  # worker's open fd keeps writing to
                # the renamed file; the merge just can't see it any more
            except OSError:
                return True
            self.journal.event("launch.chaos", kind=kind, step=step,
                               host=host)
            return True
        if kind == "shard_tear":
            ckpt_dir = os.path.join(self.launch_dir, CKPT_DIRNAME)
            steps = shards.list_complete_steps(ckpt_dir)
            if not steps:
                return False  # nothing committed yet — stay pending
            shards.tear_shard(ckpt_dir, steps[-1], host=host)
            self.journal.event("launch.chaos", kind=kind, step=step,
                               host=host, torn_step=int(steps[-1]))
            return True
        return True

    # -- cohort lifecycle ---------------------------------------------------

    def _spawn(self, world: int, round_idx: int) -> list[subprocess.Popen]:
        cfg = self.cfg
        hb_dir = os.path.join(self.launch_dir, HEARTBEAT_DIRNAME)
        os.makedirs(hb_dir, exist_ok=True)
        for name in os.listdir(hb_dir):  # stale beats from a prior round
            try:
                os.remove(os.path.join(hb_dir, name))
            except OSError:
                pass
        # every cohort is a real process group: gloo on the CPU, NCCL on
        # the cards (the JAX package's CPU cohort is logical instead)
        init = f"tcp://127.0.0.1:{_free_port()}"
        procs = []
        for i in range(world):
            cmd = [
                sys.executable, "-m", f"{_PKG}.training.launch", "--worker",
                "--launch-dir", self.launch_dir,
                "--process-id", str(i), "--num-processes", str(world),
                "--init-method", init,
                "--steps", str(cfg.steps),
                "--ckpt-every", str(cfg.ckpt_every),
                "--strategy", cfg.strategy,
                "--heartbeat-interval-s", str(cfg.heartbeat_interval_s),
                "--collective-timeout-s", str(cfg.watchdog_s),
                "--worker-restarts", str(cfg.worker_restarts),
                "--vocab-size", str(cfg.vocab_size),
                "--seq-len", str(cfg.seq_len),
                "--batch-size", str(cfg.batch_size),
                "--lr", str(cfg.lr),
            ]
            if cfg.zero1:
                cmd.append("--zero1")
            if cfg.simulate:
                cmd.append("--simulate")
            if cfg.export_cache:
                cmd += ["--export-cache",
                        os.path.expanduser(cfg.export_cache)]
            if (cfg.chaos is not None
                    and i == int(cfg.chaos.chaos_host)):
                for s in self._sigkill_schedule():
                    cmd += ["--sigkill-at", str(s)]
            log = open(os.path.join(
                self.launch_dir, f"worker_{i}.log"), "ab")
            procs.append(subprocess.Popen(
                cmd, env=_worker_env(cfg, i), stdout=log,
                stderr=subprocess.STDOUT, cwd=self.launch_dir))
            log.close()  # the child holds its own copy of the fd
        self.journal.event("launch.round", round=round_idx, world=world,
                           coordinator=init, logical=False,
                           pids=[p.pid for p in procs])
        return procs

    def _prewarm(self, world: int) -> None:
        """Background cache-fill for a world size the elastic policy
        may shrink to: a detached ``--prewarm`` process plans the worker
        model at that world and runs the cache-first export
        (``AutoDistribute.export_step(world=)``), so a scale-down restart
        opens on ``export.hit`` instead of an ``nvcc`` build.
        Fire-and-forget — a prewarm failure costs nothing but the warm
        start."""
        cfg = self.cfg
        if not cfg.export_cache or world < 1 or world in self._prewarmed:
            return
        self._prewarmed.add(world)
        cmd = [
            sys.executable, "-m", f"{_PKG}.training.launch", "--worker",
            "--prewarm",
            "--launch-dir", self.launch_dir,
            "--process-id", "0", "--num-processes", str(world),
            "--strategy", cfg.strategy,
            "--vocab-size", str(cfg.vocab_size),
            "--seq-len", str(cfg.seq_len),
            "--batch-size", str(cfg.batch_size),
            "--lr", str(cfg.lr),
            "--export-cache", os.path.expanduser(cfg.export_cache),
        ]
        if cfg.zero1:
            cmd.append("--zero1")
        if cfg.simulate:
            cmd.append("--simulate")
        log = open(os.path.join(self.launch_dir,
                                f"prewarm_w{world}.log"), "ab")
        proc = subprocess.Popen(cmd, env=_worker_env(cfg, 0), stdout=log,
                                stderr=subprocess.STDOUT,
                                cwd=self.launch_dir)
        log.close()
        self._prewarm_procs.append(proc)
        self.journal.event("export.prewarm", world=world, pid=proc.pid)

    def _reap_prewarms(self) -> None:
        """Wait briefly for in-flight prewarms (so no process outlives
        the launcher), then kill stragglers."""
        for p in self._prewarm_procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                    p.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self._prewarm_procs = []

    def _kill_cohort(self, procs: list[subprocess.Popen]) -> None:
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 5.0
        for p in procs:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    p.kill()
                    p.wait(timeout=10)
                except OSError:
                    pass

    def _supervise(self, procs: list[subprocess.Popen]) -> dict:
        """Poll the cohort to completion or first failure.  Returns
        {"ok": bool, "reason", "host", "step", "first_beat_s"}."""
        cfg = self.cfg
        t0 = time.monotonic()
        checked: dict[str, int] = {}
        progress: dict[int, tuple[int, float]] = {}  # host -> (step, when)
        first_beat = None

        def verdict(**kw) -> dict:
            return {"first_beat_s": first_beat, "rc": None, **kw}

        while True:
            beats = read_heartbeats(self.launch_dir)
            now = time.monotonic()
            if beats and first_beat is None:
                first_beat = round(now - t0, 3)
            self._fire_chaos(beats, checked)
            rcs = [p.poll() for p in procs]
            for i, rc in enumerate(rcs):
                if rc is not None and rc != 0:
                    step = int(beats.get(i, {}).get("step", -1))
                    return verdict(ok=False, reason=f"worker exited rc={rc}",
                                   host=i, step=step, rc=rc)
            if all(rc == 0 for rc in rcs):
                return verdict(ok=True, reason="", host=None, step=None)
            for i, beat in beats.items():
                step = int(beat.get("step", 0))
                last = progress.get(i)
                if last is None or step > last[0]:
                    progress[i] = (step, now)
                elif (rcs[i] is None and step < cfg.steps
                        and now - last[1] > cfg.watchdog_s):
                    return verdict(ok=False, host=i, step=step,
                                   reason=(f"worker hung: no step progress "
                                           f"in {cfg.watchdog_s:.0f}s"))
            if not beats and now - t0 > cfg.spawn_grace_s:
                return verdict(ok=False, host=None, step=None,
                               reason=(f"no heartbeat within spawn grace "
                                       f"{cfg.spawn_grace_s:.0f}s"))
            if now - t0 > cfg.round_timeout_s:
                return verdict(ok=False, host=None, step=None,
                               reason=(f"round timeout "
                                       f"{cfg.round_timeout_s:.0f}s"))
            time.sleep(0.05)

    def _collect(self, world: int) -> list[dict]:
        out = []
        for i in range(world):
            path = os.path.join(self.launch_dir, f"result_host{i}.json")
            with open(path) as f:
                out.append(json.load(f))
        return out

    def run(self) -> dict:
        """Run the launch to completion (or budget exhaustion).  Besides
        the JAX package's result, ``rounds_s`` gives each round's
        seconds and its spawn-to-first-heartbeat, and ``resume_s`` the
        seconds from the first failure to the restarted cohort's first
        heartbeat (its restore included)."""
        cfg = self.cfg
        world = int(cfg.hosts)
        round_idx = 0
        restarts = 0
        failed_at = None
        with obs_journal.as_default(self.journal):
            if cfg.elastic and cfg.export_cache:
                # prewarm the nearest shrink worlds while round 0 runs;
                # each world has its own topology fingerprint, so its
                # own key
                for w in list(range(world - 1, cfg.min_hosts - 1, -1))[:2]:
                    self._prewarm(w)
            while True:
                self._state["world_history"].append(world)
                for i in range(world):  # stale results must not satisfy
                    try:                # _collect after a failed round
                        os.remove(os.path.join(
                            self.launch_dir, f"result_host{i}.json"))
                    except OSError:
                        pass
                t_round = time.monotonic()
                procs = self._spawn(world, round_idx)
                verdict = self._supervise(procs)
                self._kill_cohort(procs)
                seconds = round(time.monotonic() - t_round, 3)
                if (failed_at is not None and "resume_s" not in self._state
                        and verdict["first_beat_s"] is not None):
                    self._state["resume_s"] = round(
                        t_round + verdict["first_beat_s"] - failed_at, 3)
                self._state["rounds"].append({
                    "round": round_idx, "world": world,
                    "ok": verdict["ok"], "reason": verdict["reason"],
                    "failed_host": verdict["host"],
                    "failed_step": verdict["step"],
                    "seconds": seconds,
                    "first_beat_s": verdict["first_beat_s"],
                })
                if verdict["ok"]:
                    self._reap_prewarms()
                    results = self._collect(world)
                    self._state.update(done=True, ok=True)
                    self._save_state()
                    final = results[0] if results else {}
                    # a round's result only covers the steps that round
                    # ran; the full trajectory (including pre-restart
                    # rounds) lives in host 0's journal, which appends
                    # across cohorts
                    losses = self._losses_from_journal(
                        host=0) or final.get("losses", {})
                    final_step = final.get("final_step")
                    final_loss = (losses.get(str(final_step))
                                  if final_step is not None else None)
                    self.journal.event(
                        "launch.done", rounds=round_idx + 1,
                        restarts=restarts, world=world,
                        final_step=final_step, final_loss=final_loss)
                    merged = self._merge_journals()
                    return {
                        "ok": True, "world": world, "rounds": round_idx + 1,
                        "restarts_used": restarts,
                        "final_step": final_step,
                        "final_loss": final_loss,
                        "losses": losses,
                        "results": results, "merged_journal": merged,
                        "launch_dir": self.launch_dir,
                        "rounds_s": [
                            {k: r[k] for k in ("round", "seconds",
                                               "first_beat_s")}
                            for r in self._state["rounds"]],
                        "resume_s": self._state.get("resume_s"),
                    }
                if failed_at is None:
                    failed_at = time.monotonic()
                self._state["last_failure"] = {
                    "round": round_idx, "host": verdict["host"],
                    "step": verdict["step"], "reason": verdict["reason"],
                }
                gave_up = self.policy.note_failure()
                restarts += 1
                self._state["restarts_used"] = restarts
                self.journal.event(
                    "launch.restart", round=round_idx, world=world,
                    host=verdict["host"], step=verdict["step"],
                    reason=verdict["reason"], restarts=restarts,
                    max_restarts=cfg.max_restarts, gave_up=gave_up)
                if gave_up:
                    self._reap_prewarms()
                    self._state.update(done=True, ok=False)
                    self._save_state()
                    self._merge_journals()
                    return {
                        "ok": False, "world": world,
                        "rounds": round_idx + 1, "restarts_used": restarts,
                        "error": ("restart budget exhausted: "
                                  + verdict["reason"]),
                        "last_failure": self._state["last_failure"],
                        "launch_dir": self.launch_dir,
                    }
                if (cfg.elastic and verdict["host"] is not None
                        and world > cfg.min_hosts):
                    new_world = world - 1
                    # the next cohort re-plans at the surviving world
                    # (workers run strategy=auto); the resharding
                    # restore re-slices the old world's shards
                    self.journal.event(
                        "launch.replan", world_from=world,
                        world_to=new_world, strategy=cfg.strategy,
                        reason=verdict["reason"])
                    world = new_world
                    # keep one prewarm ahead of the shrink frontier
                    if new_world - 1 >= cfg.min_hosts:
                        self._prewarm(new_world - 1)
                self._save_state()
                self.policy.sleep(self.policy.delay_s(restarts))
                round_idx += 1

    def _losses_from_journal(self, host: int = 0) -> dict[str, float]:
        """Per-step losses from the host's ``launch.step`` events — last
        occurrence wins, so a resumed cohort's replayed steps overwrite
        (and, under the bitwise-parity contract, must equal) the
        pre-kill round's values."""
        path = os.path.join(self.launch_dir, f"journal_host{host}.jsonl")
        out: dict[str, float] = {}
        try:
            records = obs_journal.Journal.read(path)
        except OSError:
            return out  # partitioned/missing journal — degrade to the
            # final round's result losses
        for rec in records:
            if rec.get("name") == "launch.step":
                out[str(rec.get("step"))] = rec.get("loss")
        return out

    def _merge_journals(self) -> str | None:
        self.journal.close()
        try:
            from ..obs import aggregate

            return aggregate.merge_run(self.launch_dir)
        except (OSError, ValueError):
            return None


# ---------------------------------------------------------------------------
# Worker (subprocess entry: python -m <pkg>.training.launch --worker ...)
# ---------------------------------------------------------------------------


class _HostSliced:
    """Step-indexed view of a step-indexed global source, sliced to this
    process's rows (``data.shard_for_host`` on the plan's mesh, so the
    ranks of one tensor group hold the same rows) — resume replays the
    same global batch at the same step whatever the world size, which
    is what makes kill-and-resume (and elastic reshape)
    bitwise-reproducible."""

    step_indexed = True

    def __init__(self, data: Any, ad: Any):
        self._data = data
        self._ad = ad

    def batch(self, i: int) -> dict:
        from ..data import shard_for_host

        if self._ad.plan is None:
            self._ad.build_plan()
        mesh = self._ad.plan.mesh
        return shard_for_host(self._data.batch(i), mesh=(
            None if isinstance(mesh, dict) else mesh))


def _worker_main(args) -> int:
    import datetime

    import torch

    from .. import topology
    from ..core import AutoDistribute
    from ..data.synthetic import SyntheticLM
    from ..models import GPT2
    from ..utils.device import process_count
    from .elastic import run_with_recovery
    from .losses import next_token_loss
    from .optim import sgd
    from .shards import ShardedCheckpoint
    from .trainer import Trainer, TrainerConfig

    if args.simulate:
        torch.set_num_threads(1)
    topology.initialize_distributed(
        backend="gloo" if args.simulate else "nccl",
        init_method=args.init_method, world_size=args.num_processes,
        rank=args.process_id,
        timeout=datetime.timedelta(seconds=args.collective_timeout_s))
    pid = args.process_id
    journal = obs_journal.Journal(
        os.path.join(args.launch_dir, f"journal_host{pid}.jsonl"),
        host0_only=False,
        meta={"host": pid, "world": args.num_processes, "pid": os.getpid()},
    )
    device = "cpu" if args.simulate else None  # None: cuda:LOCAL_RANK
    ad = AutoDistribute(
        GPT2("test", vocab_size=args.vocab_size,
             max_seq_len=args.seq_len - 1),
        optimizer=sgd(args.lr),
        loss_fn=next_token_loss,
        strategy=args.strategy,
        zero1=args.zero1,
        device=device,
        export_cache=args.export_cache or None,
    )
    data = _HostSliced(SyntheticLM(
        vocab_size=args.vocab_size, seq_len=args.seq_len,
        batch_size=args.batch_size), ad)
    ckpt = ShardedCheckpoint(os.path.join(args.launch_dir, CKPT_DIRNAME))
    losses: dict[int, float] = {}
    kill_at = set(args.sigkill_at or ())

    def record(step: int, state, metrics: dict) -> None:
        loss = float(metrics.get("loss", float("nan")))
        losses[step] = loss
        journal.event("launch.step", step=int(step), host=pid, loss=loss)
        if step in kill_at:
            # orchestrator-scheduled hard kill: the latch marker makes
            # it once-per-launch (the resumed cohort replays this step
            # without re-dying); SIGKILL means no drain and no atexit.
            # The saves queued before this step are made durable first,
            # so the restart's resume point is fixed (the newest save
            # before the kill); a torn save is held to the completion
            # markers by ``tear_checkpoint`` and the doctor instead
            marker = os.path.join(
                args.launch_dir, f"chaos_sigkill_h{pid}_s{step}")
            if not os.path.exists(marker):
                ckpt.wait()
                with open(marker, "w") as f:
                    f.write(str(os.getpid()))
                journal.event("launch.chaos", kind="sigkill",
                              step=int(step), host=pid, self_inflicted=True)
                os.kill(os.getpid(), signal.SIGKILL)

    cfg = TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, log_every=0,
        heartbeat_dir=os.path.join(args.launch_dir, HEARTBEAT_DIRNAME),
        heartbeat_interval_s=args.heartbeat_interval_s,
        heartbeat_host=pid,
        preflight=False, preempt_check_every=1,
    )
    trainer = Trainer(ad, cfg, ckpt=ckpt, journal=journal,
                      callbacks=[record])
    state = run_with_recovery(lambda: trainer.fit(data),
                              max_restarts=args.worker_restarts)
    ckpt.wait()
    ckpt.close()
    result = {
        "host": pid,
        "world": args.num_processes,
        "n_devices": process_count(),
        "final_step": int(state.step),
        "final_loss": losses.get(int(state.step)),
        "losses": {str(k): v for k, v in sorted(losses.items())},
        "strategy": ad.plan.strategy if ad.plan else None,
    }
    path = os.path.join(args.launch_dir, f"result_host{pid}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, path)
    journal.close()
    torch.distributed.destroy_process_group()
    return 0


def _prewarm_main(args) -> int:
    """``--prewarm`` entry: plan the exact worker model at the target
    world size (``--num-processes``) without joining a cohort, run the
    cache-first export (:meth:`AutoDistribute.export_step` with
    ``world=``), then exit.  Spawned in the background by an elastic
    launcher so the shrink cohort's kernels are already in the cache
    when a host dies."""
    from ..core import AutoDistribute
    from ..data.synthetic import SyntheticLM
    from ..models import GPT2
    from .losses import next_token_loss
    from .optim import sgd

    journal = obs_journal.Journal(
        os.path.join(args.launch_dir,
                     f"journal_prewarm_w{args.num_processes}.jsonl"),
        host0_only=False,
        meta={"role": "prewarm", "world": args.num_processes,
              "pid": os.getpid()})
    ad = AutoDistribute(
        GPT2("test", vocab_size=args.vocab_size,
             max_seq_len=args.seq_len - 1),
        optimizer=sgd(args.lr),
        loss_fn=next_token_loss,
        strategy=args.strategy,
        zero1=args.zero1,
        device="cpu" if args.simulate else None,
    )
    # the global batch: a worker's rows scale back to it in the key
    batch = SyntheticLM(vocab_size=args.vocab_size, seq_len=args.seq_len,
                        batch_size=args.batch_size).batch(0)
    with obs_journal.as_default(journal):
        info = ad.export_step(None, batch, cache=args.export_cache or True,
                              world=args.num_processes)
        journal.event("export.prewarm_done", world=args.num_processes,
                      key=info.get("key") or "", source=info.get("source"))
    journal.close()
    return 0


# ---------------------------------------------------------------------------
# Doctor (doctor --launch-dir)
# ---------------------------------------------------------------------------


def _pid_alive(pid: int | None) -> bool | None:
    if not pid:
        return None
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return None


def launch_doctor(launch_dir: str) -> dict:
    """Supervision health of a launch dir: per-host last-seen beats,
    restart-budget consumption, and which host broke the cohort."""
    launch_dir = os.path.abspath(launch_dir)
    now = time.time()
    hosts = []
    for i, beat in sorted(read_heartbeats(launch_dir).items()):
        hosts.append({
            "host": i,
            "step": int(beat.get("step", -1)),
            "pid": beat.get("pid"),
            "alive": _pid_alive(beat.get("pid")),
            "age_s": (round(now - beat["time"], 3)
                      if isinstance(beat.get("time"), (int, float))
                      else None),
        })
    state: dict = {}
    try:
        with open(os.path.join(launch_dir, STATE_FILE)) as f:
            state = json.load(f)
    except (OSError, ValueError):
        pass
    ckpt_dir = os.path.join(launch_dir, CKPT_DIRNAME)
    return {
        "directory": launch_dir,
        "hosts": hosts,
        "restarts_used": state.get("restarts_used", 0),
        "max_restarts": state.get("max_restarts"),
        "world_history": state.get("world_history", []),
        "last_failure": state.get("last_failure"),
        "done": state.get("done", False),
        "ok": state.get("ok"),
        "complete_ckpt_steps": (shards.list_complete_steps(ckpt_dir)
                                if os.path.isdir(ckpt_dir) else []),
    }


def format_launch_doctor(doc: dict) -> str:
    lines = [f"launch dir: {doc['directory']}"]
    used, cap = doc.get("restarts_used", 0), doc.get("max_restarts")
    lines.append(f"restart budget: {used}/{cap if cap is not None else '?'}"
                 f" used; worlds: "
                 + (" -> ".join(str(w) for w in doc.get("world_history", []))
                    or "?"))
    for h in doc.get("hosts", []):
        alive = {True: "alive", False: "DEAD", None: "?"}[h["alive"]]
        age = f"{h['age_s']:.1f}s ago" if h.get("age_s") is not None else "?"
        lines.append(f"  host {h['host']}: step {h['step']}, "
                     f"pid {h['pid']} ({alive}), last beat {age}")
    if not doc.get("hosts"):
        lines.append("  (no heartbeats)")
    fail = doc.get("last_failure")
    if fail:
        lines.append(f"last failure: host {fail.get('host')} at step "
                     f"{fail.get('step')} — {fail.get('reason')} "
                     f"(round {fail.get('round')})")
    if doc.get("done"):
        lines.append("run: " + ("COMPLETED ok" if doc.get("ok")
                                else "GAVE UP (budget exhausted)"))
    else:
        lines.append("run: in progress (or killed before completion)")
    steps = doc.get("complete_ckpt_steps", [])
    lines.append(f"committed sharded steps: {steps if steps else 'none'}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# argv entry
# ---------------------------------------------------------------------------


def _worker_argparser():
    import argparse

    p = argparse.ArgumentParser(prog=f"{_PKG}.training.launch")
    p.add_argument("--worker", action="store_true")
    p.add_argument("--launch-dir", required=True)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--init-method", default="",
                   help="the process group's rendezvous (tcp://host:port)")
    p.add_argument("--simulate", action="store_true",
                   help="gloo on the CPU; without it NCCL, the card "
                        "LOCAL_RANK names")
    p.add_argument("--collective-timeout-s", type=float, default=120.0,
                   help="the process group's timeout: a survivor blocked "
                        "in a collective after a peer died raises")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--ckpt-every", type=int, default=2)
    p.add_argument("--strategy", default="auto")
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--heartbeat-interval-s", type=float, default=0.5)
    p.add_argument("--worker-restarts", type=int, default=0)
    p.add_argument("--vocab-size", type=int, default=512)
    p.add_argument("--seq-len", type=int, default=33)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--export-cache", default="",
                   help="the export cache dir (export/): cache-first on "
                        "the step's kernel build")
    p.add_argument("--prewarm", action="store_true",
                   help="plan for --num-processes, export the step's "
                        "kernel libraries into --export-cache, and exit "
                        "(the elastic launcher's background prewarm)")
    p.add_argument("--sigkill-at", type=int, action="append",
                   help="chaos: SIGKILL self right after this step "
                        "(once per launch, latched in the launch dir)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _worker_argparser().parse_args(argv)
    if not args.worker:
        print("this entry point is worker-only; use `launch`",
              file=sys.stderr)
        return 2
    if args.prewarm:
        return _prewarm_main(args)
    return _worker_main(args)


if __name__ == "__main__":
    sys.exit(main())
