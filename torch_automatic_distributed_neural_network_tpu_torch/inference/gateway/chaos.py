"""Chaos-traffic autoscale scenario: the gateway's closed-loop proof.

A scripted traffic schedule — gentle mix, a mid-run flip to a heavy
mix (higher rate AND longer decodes), then back — drives a fleet of
:class:`~.router.SimReplica` under an autoscaling
:class:`~.ingress.Gateway`, everything on one virtual clock:

1. the flip saturates the fleet; measured p99 climbs through the SLO;
2. ``SLOMonitor`` journals ``slo.breach`` after its hysteresis count;
3. the controller replans from the measured mix via the serving
   replay and journals ``gateway.replan`` + ``gateway.scale`` events
   as it grows the fleet;
4. the grown fleet drains the backlog; windows go clean;
   ``slo.recover`` lands.

Because every timestamp, arrival, admission decision and journal
record derives from the injected clock and seeded mixes, running the
scenario twice produces an IDENTICAL event sequence — ``chaos_smoke``
runs it twice and diffs the normalized journals, which is the CI
gate's determinism assertion (no sleeps, no wall-clock reads, no
tolerance bands).

The PyTorch package's copy of the JAX package's
``inference/gateway/chaos.py``: the same scenarios on the port's
``SimReplica`` and ``Gateway``, journaling the same records.
"""

from __future__ import annotations

import dataclasses
import json
import random

from ...obs.journal import Journal
from ...tune.simulate import TrafficMix
from ...tune.slo import SLOSpec
from .controller import AutoscalePolicy
from .fault import BreakerPolicy, HedgePolicy
from .ingress import Gateway, GatewayError
from .router import SimReplica

# shared system-prompt head: identical across every request so the
# radix index (and the router's affinity map) has something to reuse
SHARED_PREFIX = 16


@dataclasses.dataclass(frozen=True)
class ChaosPhase:
    t0: float
    span_s: float
    mix: TrafficMix


def phases(scale: str = "smoke") -> list[ChaosPhase]:
    """The scripted schedule.  ``smoke`` is the CI scenario (2 -> ~8
    replicas); ``light`` is the faster tier-1 test variant."""

    def mix(rate, max_new, seed, n):
        return TrafficMix(rate_per_s=rate, n_requests=n,
                          prompt_mean=24, max_new=max_new,
                          decode_mean=max_new, jitter=0.0, seed=seed,
                          shared_prefix=SHARED_PREFIX)

    if scale == "gentle":
        # no flip: a healthy run whose journal must pass
        # ``tadnn monitor --replay --check`` with exit 0
        return [ChaosPhase(0.0, 4.0, mix(40.0, 8, 11, 200))]
    if scale == "light":
        return [
            ChaosPhase(0.0, 4.0, mix(40.0, 8, 11, 200)),
            ChaosPhase(4.0, 6.0, mix(240.0, 12, 12, 1700)),
            ChaosPhase(10.0, 6.0, mix(40.0, 8, 13, 280)),
        ]
    return [
        ChaosPhase(0.0, 6.0, mix(60.0, 8, 11, 420)),
        ChaosPhase(6.0, 10.0, mix(300.0, 16, 12, 3400)),
        ChaosPhase(16.0, 8.0, mix(60.0, 8, 13, 560)),
    ]


def arrivals(schedule: list[ChaosPhase], *, n_tenants: int = 8
             ) -> list[tuple[float, list[int], int, int, str]]:
    """Flatten the schedule into absolute-time submissions:
    ``(t, prompt, max_new, n_decode, tenant)``.  Prompts share a
    ``SHARED_PREFIX``-token head; tails are unique per request."""
    out: list[tuple[float, list[int], int, int, str]] = []
    uid = 0
    for phase in schedule:
        for arr, n_prompt, max_new, n_dec in phase.mix.sample(
                max_len=256):
            if arr > phase.span_s:
                break
            n_shared = min(SHARED_PREFIX, n_prompt - 1)
            prompt = ([1] * n_shared
                      + [100 + uid] * (n_prompt - n_shared))
            out.append((phase.t0 + arr, prompt, max_new, n_dec,
                        f"t{uid % n_tenants}"))
            uid += 1
    out.sort(key=lambda a: a[0])
    return out


def default_policy(slo_text: str = "p99_ms<=2500", *,
                   max_replicas: int = 8) -> AutoscalePolicy:
    return AutoscalePolicy(
        slo=SLOSpec.parse(slo_text), window_s=1.0,
        breach_after=2, recover_after=2, warmup_windows=1,
        min_replicas=1, max_replicas=max_replicas,
        cooldown_windows=3, scale_in_after=10_000)


def run_scenario(journal: Journal, *, clock: list[float] | None = None,
                 n_replicas: int = 2,
                 policy: AutoscalePolicy | None = None,
                 scale: str = "smoke", tick_s: float = 5e-3,
                 horizon_s: float = 90.0) -> dict:
    """One full pass of the scenario on a virtual clock; returns the
    gateway summary (the journal carries the event record).

    ``clock`` is a one-element list (the mutable time box) so the
    caller can hand the SAME virtual clock to the journal — the
    journal's ``t`` stamps must be virtual or the byte-for-byte
    determinism diff would see wall time."""
    policy = policy or default_policy()
    if clock is None:
        clock = [0.0]

    def now() -> float:
        return clock[0]

    def make(name: str) -> SimReplica:
        return SimReplica(name, n_slots=4, block_size=8, max_len=256,
                          prefill_chunk=8, clock=now, journal=journal)

    replicas = [make(f"replica{i}") for i in range(n_replicas)]
    gw = Gateway(replicas, journal=journal, clock=now,
                 autoscale=policy, make_replica=make, queue_limit=48,
                 step_costs=(tick_s, tick_s))
    plan = arrivals(phases(scale))
    i = 0
    while clock[0] < horizon_s and (i < len(plan) or not gw.idle()):
        t = clock[0]
        while i < len(plan) and plan[i][0] <= t:
            _, prompt, max_new, n_dec, tenant = plan[i]
            try:
                gw.submit(prompt, max_new, tenant=tenant, eos_id=0,
                          n_decode=n_dec)
            except GatewayError:
                pass  # counted by the gateway; journaled
            i += 1
        gw.step()
        clock[0] = t + tick_s
    if gw.controller is not None:
        gw.controller.finish()
    summary = gw.summary()
    summary["offered"] = len(plan)
    summary["virtual_s"] = clock[0]
    return summary


# -- fleet fault scenario -----------------------------------------------------
#
# The second chaos tier: instead of flipping traffic, it breaks the
# FLEET — a seeded plan kills one replica mid-stream (heartbeat
# failover), wedges another (circuit breaker + hedging), and slows a
# third (hedging) — and the gate asserts that every accepted request
# still completes with a token stream bitwise-identical to a
# fault-free run of the same seed.  ``tadnn gateway --chaos`` in CI.


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault on the virtual clock."""

    t: float
    kind: str       # kill | stall | unstall | slow | restore
    replica: int    # index into the initial fleet
    factor: int = 1  # slow-down multiple (kind == "slow")


def fault_plan(seed: int, n_replicas: int) -> list[FaultEvent]:
    """The seeded fault schedule: one kill, one stall/unstall pair,
    one slow/restore pair, on DISTINCT victims, never replica0 (the
    fleet must keep at least one intact survivor so failover has
    somewhere to land).  Same seed -> same plan, byte-for-byte."""
    rng = random.Random(seed)
    victims = list(range(1, n_replicas))
    rng.shuffle(victims)
    events: list[FaultEvent] = []
    if victims:
        events.append(FaultEvent(
            round(rng.uniform(1.0, 2.0), 3), "kill", victims[0]))
    if len(victims) > 1:
        t = round(rng.uniform(0.6, 1.2), 3)
        events.append(FaultEvent(t, "stall", victims[1]))
        events.append(FaultEvent(
            round(t + rng.uniform(0.8, 1.2), 3), "unstall", victims[1]))
    if len(victims) > 2:
        t = round(rng.uniform(0.4, 0.8), 3)
        events.append(FaultEvent(t, "slow", victims[2], factor=64))
        events.append(FaultEvent(
            round(t + rng.uniform(1.0, 1.5), 3), "restore", victims[2]))
    events.sort(key=lambda e: (e.t, e.kind, e.replica))
    return events


def _apply_fault(ev: FaultEvent, replica: SimReplica,
                 journal: Journal) -> None:
    if ev.kind == "kill":
        replica.kill()
    elif ev.kind == "stall":
        replica.stalled = True
    elif ev.kind == "unstall":
        replica.stalled = False
    elif ev.kind == "slow":
        replica.slow_factor = max(1, int(ev.factor))
    elif ev.kind == "restore":
        replica.slow_factor = 1
    else:
        raise ValueError(f"unknown fault kind {ev.kind!r}")
    journal.event("chaos.fault", kind=ev.kind, replica=replica.name,
                  t_fault=ev.t, factor=ev.factor)


def run_fleet_scenario(journal: Journal, *,
                       clock: list[float] | None = None,
                       seed: int = 0, n_replicas: int = 4,
                       faults: bool = True,
                       prefix_cache: bool = True,
                       tick_s: float = 5e-3,
                       horizon_s: float = 30.0
                       ) -> tuple[dict, dict[int, list[int]]]:
    """One pass of the fleet fault scenario; returns ``(summary,
    streams)`` where ``streams`` maps every accepted rid to its
    exactly-once delivered token list (the gateway ledger).

    No rate limit and an effectively unbounded queue: BOTH the faulted
    and the fault-free run must accept the identical request set, or
    per-rid stream parity would be vacuous."""
    if clock is None:
        clock = [0.0]

    def now() -> float:
        return clock[0]

    def make(name: str) -> SimReplica:
        return SimReplica(name, n_slots=4, block_size=8, max_len=256,
                          prefill_chunk=8, prefix_cache=prefix_cache,
                          clock=now, journal=journal)

    replicas = [make(f"replica{i}") for i in range(n_replicas)]
    gw = Gateway(replicas, journal=journal, clock=now,
                 queue_limit=100_000,
                 heartbeat_s=tick_s * 10,
                 hedge=HedgePolicy(after_s=0.2,
                                   max_hedges_per_request=1),
                 breaker=BreakerPolicy(window_s=0.1,
                                       min_observations=10,
                                       failure_rate=0.5,
                                       open_s=0.3, clean_s=0.1),
                 step_costs=(tick_s, tick_s))
    plan = arrivals([ChaosPhase(0.0, 5.0, TrafficMix(
        rate_per_s=80.0, n_requests=400, prompt_mean=24, max_new=12,
        decode_mean=12, jitter=0.0, seed=seed,
        shared_prefix=SHARED_PREFIX))])
    fplan = fault_plan(seed, n_replicas) if faults else []
    expected: dict[int, int] = {}   # rid -> emulated true decode len
    i = f = 0
    while clock[0] < horizon_s and (
            i < len(plan) or f < len(fplan)
            or not gw.idle() or gw._meta):
        t = clock[0]
        while f < len(fplan) and fplan[f].t <= t:
            _apply_fault(fplan[f], replicas[fplan[f].replica], journal)
            f += 1
        while i < len(plan) and plan[i][0] <= t:
            _, prompt, max_new, n_dec, tenant = plan[i]
            try:
                req = gw.submit(prompt, max_new, tenant=tenant,
                                eos_id=0, n_decode=n_dec)
                expected[req.rid] = n_dec
            except GatewayError:
                pass
            i += 1
        gw.step()
        clock[0] = t + tick_s
    summary = gw.summary()
    summary["offered"] = len(plan)
    summary["virtual_s"] = clock[0]
    summary["n_faults"] = len(fplan)
    streams = {rid: gw.delivered(rid) for rid in expected}
    summary["complete"] = all(
        len(streams[rid]) == n_dec and streams[rid][-1] == 0
        for rid, n_dec in expected.items())
    return summary, streams


def fleet_chaos(*, journal_path: str | None = None, seed: int = 0,
                n_replicas: int = 4) -> dict:
    """The ``tadnn gateway --chaos`` CI gate.

    Three runs of the SAME seeded traffic: a fault-free baseline, a
    faulted run journaled to ``journal_path``, and a second faulted
    run in memory.  Holds iff

    - the two faulted runs journal identical normalized event
      sequences AND identical per-rid streams (determinism);
    - every accepted request completed, and each rid's delivered
      stream is bitwise-identical to the fault-free baseline's
      (failover/hedging lost and duplicated nothing);
    - at least one replica was killed while it held in-flight work
      (the kill really was mid-stream)."""

    def one(path: str | None, faults: bool
            ) -> tuple[dict, dict, list[dict]]:
        clock = [0.0]
        j = Journal(path, host0_only=False, clock=lambda: clock[0],
                    meta={"tool": "gateway-fleet-chaos"})
        with j:
            summary, streams = run_fleet_scenario(
                j, clock=clock, seed=seed, n_replicas=n_replicas,
                faults=faults)
        records = (Journal.read(path) if path else list(j.records))
        return summary, streams, records

    s0, st0, _ = one(None, False)
    s1, st1, r1 = one(journal_path, True)
    s2, st2, r2 = one(None, True)
    deterministic = (_normalize(r1) == _normalize(r2) and st1 == st2)
    parity = st1 == st0
    completed = bool(s1["complete"] and s1["done"] == s1["accepted"])
    killed_inflight = any(
        rec.get("name") == "gateway.failover"
        and rec.get("n_requeued", 0) > 0 for rec in r1)
    ok = (deterministic and parity and completed and killed_inflight
          and s0["complete"])
    return {
        "ok": ok,
        "deterministic": deterministic,
        "stream_parity": parity,
        "all_completed": completed,
        "killed_inflight": killed_inflight,
        "baseline_complete": s0["complete"],
        "seed": seed,
        "accepted": s1["accepted"],
        "failovers": s1["failovers"],
        "hedges": s1["hedges"],
        "hedge_wins": s1["hedge_wins"],
        "breakers": s1.get("breakers", {}),
        "n_records": len(r1),
        "fault_plan": [dataclasses.asdict(e)
                       for e in fault_plan(seed, n_replicas)],
        "run": s1,
    }


def _normalize(records: list[dict]) -> list[str]:
    """Canonical form for the determinism diff: drop the one
    legitimately nondeterministic field (wall time) and re-serialize.
    Everything else — virtual timestamps, decisions, counters — must
    match byte-for-byte across runs."""
    out = []
    for rec in records:
        out.append(json.dumps({k: v for k, v in rec.items()
                               if k != "wall"}, default=str))
    return out


def chaos_smoke(*, journal_path: str | None = None,
                n_replicas: int = 2, slo_text: str = "p99_ms<=2500",
                max_replicas: int = 8, scale: str = "smoke",
                autoscale: bool = True) -> dict:
    """Run the scenario TWICE (file-backed then in-memory journal),
    diff the normalized event sequences, and check the closed loop
    actually closed: breach -> replan -> scale -> recover, in order.

    Returns a summary dict with ``ok`` plus per-assertion booleans —
    the CLI smoke prints it as one JSON line and exits nonzero unless
    everything held."""
    policy = (default_policy(slo_text, max_replicas=max_replicas)
              if autoscale else None)

    def one(path: str | None) -> tuple[dict, list[dict]]:
        clock = [0.0]
        # the journal shares the scenario's virtual clock so record
        # ``t`` stamps are event-time, not wall-time — the whole point
        # of the twice-run diff below
        j = Journal(path, host0_only=False, clock=lambda: clock[0],
                    meta={"tool": "gateway-chaos"})
        with j:
            summary = run_scenario(j, clock=clock,
                                   n_replicas=n_replicas,
                                   policy=policy, scale=scale)
        records = (Journal.read(path) if path else list(j.records))
        return summary, records

    s1, r1 = one(journal_path)
    s2, r2 = one(None)
    seq1, seq2 = _normalize(r1), _normalize(r2)
    deterministic = seq1 == seq2

    def first_index(name: str) -> int:
        for idx, rec in enumerate(r1):
            if rec.get("name") == name:
                return idx
        return -1

    i_breach = first_index("slo.breach")
    i_replan = first_index("gateway.replan")
    i_scale = first_index("gateway.scale")
    i_recover = first_index("slo.recover")
    closed_loop = (0 <= i_breach <= i_replan <= i_scale
                   and i_scale <= i_recover) if autoscale else True
    ok = deterministic and closed_loop and s1["done"] > 0
    return {
        "ok": ok,
        "deterministic": deterministic,
        "closed_loop": closed_loop,
        "breach_at": i_breach, "replan_at": i_replan,
        "scale_at": i_scale, "recover_at": i_recover,
        "n_records": len(r1),
        "record_mismatch": (None if deterministic else next(
            (i for i, (a, b) in enumerate(zip(seq1, seq2)) if a != b),
            min(len(seq1), len(seq2)))),
        "names_seen": sorted({rec.get("name") for rec in r1
                              if rec.get("name")}),
        "run": s1,
    }
