"""Closed-loop SLO autoscaler: live windows in, replica resizes out.

This is the piece that turns the observability stack from a report
into a control system.  The controller consumes the SAME telemetry the
offline tools do — ``LiveAggregator`` event-time windows folded from
the gateway's journal stream, judged by ``SLOMonitor``'s hysteresis
state machine — and on a sustained breach asks the planner's serving
replay (``tune/simulate.replay_serve``: the REAL scheduler policy on
virtual time) what the cheapest replica count restoring the SLO is.
The answer becomes a ``gateway.replan`` journal event plus a live
resize: scale-out adds replicas (built by the gateway's replica
factory), scale-in drains the victim through the scheduler's requeue
path and resubmits its requests through the
router.  Scale-in is the mirrored conservative path: only after
``scale_in_after`` consecutive clean windows, and only when the replay
predicts n-1 replicas still meet the SLO.

Everything runs on the gateway's injected clock and pure record
streams — zero wall-clock reads, zero sleeps — so a chaos scenario
(traffic flip → breach → replan → recover) replays byte-identically
in CI.  The prediction source is deliberately the planner, not a
reactive step rule: production autoscalers that resize on raw
utilization oscillate under bursty serving traffic; simulating the
candidate fleet against the measured mix prices queueing effects the
way TorchTitan-style elastic runtimes price reshard cost before
committing (arxiv 2410.06511).

The PyTorch package's copy of the JAX package's
``inference/gateway/controller.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ...obs.live import LiveAggregator
from ...obs.slo_monitor import MonitorPolicy, SLOMonitor
from ...tune.slo import SLOSpec


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs of the closed loop (CLI: ``tadnn gateway --autoscale``)."""

    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)
    window_s: float = 1.0
    breach_after: int = 2         # hysteresis: windows before breach
    recover_after: int = 2        # ... and before recovery
    warmup_windows: int = 1
    min_replicas: int = 1
    max_replicas: int = 8
    # windows to hold fire after any resize (the new fleet needs at
    # least the hysteresis span to show up in the measurements)
    cooldown_windows: int = 4
    # consecutive clean windows before a scale-IN is even considered
    scale_in_after: int = 8
    # degraded modes: consecutive breached windows WITH the fleet
    # already at max_replicas before the controller walks the gateway
    # one degrade level down (shed/starve instead of scale); 0
    # disables.  Each further streak of the same length degrades one
    # more level, and recovery restores one level per clean streak.
    degrade_after: int = 4
    # candidate-evaluation traffic model: the replay must cover a
    # SUSTAINED stretch of the measured arrival rate — a too-short
    # burst drains inside the sim and under-prices queueing, which is
    # exactly the overload case the replan exists for.  ``sim_horizon_s``
    # seconds of traffic, capped at ``sim_requests`` arrivals.
    sim_horizon_s: float = 4.0
    sim_requests: int = 384
    sim_jitter: float = 0.0
    sim_seed: int = 0


class FleetController:
    """Feeds windows to the monitor; resizes the fleet on its verdicts.

    ``offer(record)`` is the only input — the gateway taps its journal
    and pushes every record here.  The controller never reads a clock
    and never sleeps; all its state advances on record event-time.
    """

    def __init__(self, gateway, policy: AutoscalePolicy, *,
                 journal=None):
        self.gateway = gateway
        self.policy = policy
        self.journal = journal
        self.aggregator = LiveAggregator(
            window_s=policy.window_s, clock=None)
        self.monitor = SLOMonitor(
            MonitorPolicy(slo=policy.slo, window_s=policy.window_s,
                          breach_after=policy.breach_after,
                          recover_after=policy.recover_after,
                          warmup_windows=policy.warmup_windows),
            journal=journal)
        self._cooldown = 0
        self._clean_streak = 0
        self._breach_at_max = 0
        self.replans: list[dict] = []
        self.windows_seen = 0

    # -- input ---------------------------------------------------------------

    def offer(self, rec: dict) -> None:
        name = rec.get("name", "")
        if not (isinstance(name, str) and name.startswith("serve.")):
            return
        for window in self.aggregator.add(rec):
            self._on_window(window)

    def finish(self) -> None:
        """Seal the in-progress window (end of a replayed scenario)."""
        w = self.aggregator.flush()
        if w is not None:
            self._on_window(w)

    # -- control law ---------------------------------------------------------

    def _on_window(self, window: dict) -> None:
        self.windows_seen += 1
        incident = self.monitor.observe(window)
        if self._cooldown > 0:
            self._cooldown -= 1
        breach_active = self.monitor.state == "breach"
        if breach_active:
            self._clean_streak = 0
        else:
            self._clean_streak += 1
        self._maybe_degrade(breach_active)
        if self._cooldown > 0:
            return
        n_now = self.gateway.n_active_replicas()
        if (incident and incident["kind"] == "breach") or (
                breach_active and n_now < self.policy.max_replicas):
            self._replan(window, reason="breach")
        elif (self._clean_streak >= self.policy.scale_in_after
              and n_now > self.policy.min_replicas):
            self._replan(window, reason="surplus")

    def _maybe_degrade(self, breach_active: bool) -> None:
        """Degrade ladder: when scaling out is no longer an option
        (breached AND at max_replicas) shedding load is — walk the
        gateway one level per sustained streak, and back one level per
        clean streak.  Degrade is NOT gated on the resize cooldown:
        shedding is the pressure valve for exactly the windows where a
        resize can't help."""
        pol = self.policy
        if pol.degrade_after <= 0 or not hasattr(self.gateway,
                                                 "set_degrade"):
            return
        at_max = (self.gateway.n_active_replicas()
                  >= pol.max_replicas)
        if breach_active and at_max:
            self._breach_at_max += 1
            if self._breach_at_max >= pol.degrade_after:
                self._breach_at_max = 0
                self.gateway.set_degrade(
                    self.gateway.degrade_level + 1,
                    reason="sustained breach at max fleet")
        else:
            self._breach_at_max = 0
            if (self.gateway.degrade_level > 0
                    and self._clean_streak >= pol.recover_after):
                self._clean_streak = 0
                self.gateway.set_degrade(
                    self.gateway.degrade_level - 1,
                    reason="slo recovered")

    def _replan(self, window: dict, *, reason: str) -> None:
        """Ask the serving replay for the cheapest compliant fleet
        shape under the measured traffic, journal the decision, and
        resize if it differs from the current fleet."""
        from ...tune.simulate import replay_serve

        pol = self.policy
        traffic = self.gateway.traffic_snapshot()
        n_now = self.gateway.n_active_replicas()
        if traffic["rate_per_s"] <= 0:
            return
        requests = self._candidate_requests(traffic)
        shape = self.gateway.replica_shape()
        candidates: list[dict] = []
        chosen = None
        for n in range(pol.min_replicas, pol.max_replicas + 1):
            # each replica sees a 1/n share of the measured arrivals:
            # same request list, arrival spacing stretched by n
            share = [(t * n, p, m, d) for t, p, m, d in requests]
            sim = replay_serve(
                share,
                n_slots=shape["n_slots"],
                block_size=shape["block_size"],
                max_len=shape["max_len"],
                admission=shape["admission"],
                prefill_chunk=shape["prefill_chunk"],
                prefill_chunks_per_step=shape["prefill_chunks_per_step"],
                decode_step_s=shape["decode_step_s"],
                prefill_chunk_s=shape["prefill_chunk_s"],
                prefix_cache=shape["prefix_cache"],
                shared_prefix=traffic.get("shared_prefix", 0),
            )
            pred = {
                "tok_s_per_chip": sim["tokens_per_s"],
                "p99_s": sim["p99_s"],
                "ttft_p99_s": sim["ttft_p99_s"],
                "itl_p99_s": sim["itl_p99_s"],
            }
            ok, violations = pol.slo.evaluate(pred)
            ok = ok and not sim["stalled"]
            candidates.append({
                "n_replicas": n, "ok": ok,
                "p99_s": sim["p99_s"], "ttft_p99_s": sim["ttft_p99_s"],
                "tok_s": sim["tokens_per_s"],
                "stalled": sim["stalled"],
                "violations": violations})
            if ok and chosen is None:
                chosen = n
                # later (larger) fleets only cost more; stop at the
                # cheapest compliant shape unless we still need the
                # full candidate table for the journal — we don't
                break
        if chosen is None:
            # nothing compliant within the cap: saturate at max — a
            # breached SLO with a maxed fleet is a capacity incident,
            # not a control error
            chosen = pol.max_replicas
        if reason == "breach":
            # a breach replan only ever grows the fleet: the replay
            # prices the CURRENT arrival rate, but the backlog that
            # tripped the SLO still has to drain — shrinking now would
            # re-breach immediately.  Scale-in waits for the surplus
            # path's clean-window streak.
            chosen = max(chosen, n_now)
        rec = {"reason": reason, "source": "tune.simulate.replay_serve",
               "current": n_now, "chosen": chosen,
               "window": window.get("window"),
               "rate_per_s": traffic["rate_per_s"],
               "prompt_mean": traffic["prompt_mean"],
               "decode_mean": traffic["decode_mean"],
               "candidates": candidates}
        self.replans.append(rec)
        if self.journal is not None:
            self.journal.event("gateway.replan", **rec)
        if chosen != n_now:
            self.gateway.scale_to(chosen, reason=reason)
        self._cooldown = pol.cooldown_windows

    def _candidate_requests(self, traffic: dict[str, Any]
                            ) -> list[tuple[float, int, int, int]]:
        from ...tune.simulate import TrafficMix

        pol = self.policy
        rate = max(traffic["rate_per_s"], 1e-6)
        n_req = max(32, min(pol.sim_requests,
                            int(rate * pol.sim_horizon_s)))
        mix = TrafficMix(
            rate_per_s=rate,
            n_requests=n_req,
            prompt_mean=max(1, int(traffic["prompt_mean"])),
            max_new=max(1, int(traffic["max_new"])),
            decode_mean=max(1, int(traffic["decode_mean"])),
            jitter=pol.sim_jitter, seed=pol.sim_seed,
            shared_prefix=int(traffic.get("shared_prefix", 0)))
        return mix.sample(max_len=self.gateway.replica_shape()["max_len"])

    def stats(self) -> dict:
        return {
            "windows": self.windows_seen,
            "replans": len(self.replans),
            "breaches": sum(1 for i in self.monitor.incidents
                            if i["kind"] == "breach"),
            "recoveries": sum(1 for i in self.monitor.incidents
                              if i["kind"] == "recover"),
            "state": self.monitor.state,
        }
