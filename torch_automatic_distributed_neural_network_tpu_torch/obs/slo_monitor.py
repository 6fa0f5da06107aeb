"""Continuous SLO monitoring over serving journals (``tadnn monitor``).

The offline planner (``tadnn simulate``) evaluates an
:class:`~..tune.slo.SLOSpec` against *predicted* serving numbers.
This module closes the loop on the live side: fold a journal's
``serve.*`` events into rolling windows (obs/live) and evaluate the
SAME spec against each window's measured aggregates — one SLO
language for planning and production, the precondition the ROADMAP's
closed-loop autoscaling item names.

Three pieces:

- :class:`SLOMonitor` — per-window evaluation with hysteresis: a
  breach incident only after ``breach_after`` consecutive violating
  windows, recovery only after ``recover_after`` clean ones, so one
  noisy window cannot flap an alert.  Incidents are journaled as
  ``slo.breach`` / ``slo.recover`` events (renderable by ``tadnn
  report``) and collected for the summary.
- :func:`drift_check` — planner drift: replay the committed
  SERVE_BENCH config through ``tune/simulate`` and compare its
  predicted throughput against the journal's measured throughput; a
  ratio outside the 2x band journals ``simulate.drift`` — the
  check-simulate falsification loop, run against live traffic.
- :func:`monitor_records` — the loop: records in (a finished list
  or a live ``Journal.follow`` tail), summary dict out.  Everything is
  event-time, so ``--replay`` over a committed journal is
  deterministic — the CI gate replays the serve smoke's journal and
  fails the build on any breach.

The first ``warmup_windows`` traffic-bearing windows are reported but
not SLO-evaluated: they carry the jit compiles, the same reasoning
that makes bench_serve discard its warm phase.

Pure stdlib (tune/simulate is imported lazily, only under drift
checking); safe on a machine with no accelerator runtime.

The PyTorch package's copy of the JAX package's ``obs/slo_monitor.py``,
on the port's ``LiveAggregator``, ``SLOSpec`` and ``replay_bench_record``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

from ..tune.slo import SLOSpec
from . import journal as journal_mod
from .live import LiveAggregator

# measured/predicted throughput ratio allowed before the planner is
# declared drifted — same band as obs/report.check_simulate
DRIFT_BAND = 2.0


@dataclasses.dataclass(frozen=True)
class MonitorPolicy:
    """How to window, judge, and de-flap a journal's SLO evaluation."""

    slo: SLOSpec = SLOSpec()
    window_s: float = 5.0
    breach_after: int = 2
    recover_after: int = 2
    n_chips: int = 1
    warmup_windows: int = 1


def window_prediction(window: Mapping[str, Any],
                      n_chips: int = 1) -> dict:
    """Map one live window's aggregates onto the key names
    ``SLOSpec.evaluate`` checks — the adapter that lets the planner's
    spec language judge measured traffic.  Headroom/survival have no
    live measurement; a spec demanding them violates by absence
    (tune/slo: absence of evidence is not compliance)."""
    tok_s = window.get("tok_s")
    return {
        "tok_s_per_chip": (tok_s / max(1, n_chips)
                           if tok_s is not None else None),
        "p99_s": window.get("p99_s"),
        "ttft_p99_s": window.get("ttft_p99_s"),
        "itl_p99_s": window.get("itl_p99_s"),
    }


class SLOMonitor:
    """Hysteresis state machine over window verdicts.

    States: "ok" <-> "breach".  ``observe(window)`` returns the
    incident dict the window triggered (or None) and journals it as
    ``slo.breach`` / ``slo.recover``.
    """

    def __init__(self, policy: MonitorPolicy, journal=None):
        self.policy = policy
        self.journal = (journal if journal is not None
                        else journal_mod.get_default())
        self.state = "ok"
        self.incidents: list[dict] = []
        self.n_windows = 0
        self.n_violating = 0
        self.n_skipped_warmup = 0
        self._bad_streak = 0
        self._ok_streak = 0

    def observe(self, window: Mapping[str, Any]) -> dict | None:
        self.n_windows += 1
        if self.n_windows <= self.policy.warmup_windows:
            # compile-era windows: report, never judge (bench_serve
            # discards its warm phase for the same reason)
            self.n_skipped_warmup += 1
            return None
        ok, violations = self.policy.slo.evaluate(
            window_prediction(window, self.policy.n_chips))
        incident: dict | None = None
        if ok:
            self._ok_streak += 1
            self._bad_streak = 0
            if (self.state == "breach"
                    and self._ok_streak >= self.policy.recover_after):
                self.state = "ok"
                incident = {"kind": "recover",
                            "window_start_s": window.get("start_s"),
                            "window_end_s": window.get("end_s"),
                            "ok_windows": self._ok_streak}
        else:
            self.n_violating += 1
            self._bad_streak += 1
            self._ok_streak = 0
            if (self.state == "ok"
                    and self._bad_streak >= self.policy.breach_after):
                self.state = "breach"
                incident = {"kind": "breach",
                            "window_start_s": window.get("start_s"),
                            "window_end_s": window.get("end_s"),
                            "violating_windows": self._bad_streak,
                            "violations": violations}
        if incident is not None:
            self.incidents.append(incident)
            # literal branch (not "slo." + kind) so the journal lint
            # can resolve both kinds at this site statically
            self.journal.event(
                "slo.breach" if incident["kind"] == "breach"
                else "slo.recover",
                **{k: v for k, v in incident.items() if k != "kind"})
        return incident


def drift_check(measured_tok_s: float | None,
                extra: Mapping[str, Any], *,
                band: float = DRIFT_BAND,
                measured_occupancy: float | None = None,
                journal=None) -> dict:
    """Planner drift: measured live throughput vs the discrete-event
    replay's prediction for the recorded config (``extra`` is a
    SERVE_BENCH record's ``extra``).  Outside the band, a
    ``simulate.drift`` event is journaled — the signal a closed-loop
    autoscaler would treat as "my model of this fleet is stale"."""
    from ..tune.simulate import replay_bench_record

    sink = journal if journal is not None else journal_mod.get_default()
    sim = replay_bench_record(extra)
    predicted = sim.get("tokens_per_s")
    result: dict[str, Any] = {
        "predicted_tok_s": predicted,
        "measured_tok_s": measured_tok_s,
        "predicted_occupancy": sim.get("mean_occupancy"),
        "measured_occupancy": measured_occupancy,
        "predicted_ttft_p99_s": sim.get("ttft_p99_s"),
        "band": band,
        "ratio": None,
        "within_band": None,
    }
    if predicted and measured_tok_s:
        ratio = measured_tok_s / predicted
        result["ratio"] = ratio
        result["within_band"] = bool(1.0 / band <= ratio <= band)
        if not result["within_band"]:
            sink.event("simulate.drift", **{
                k: result[k] for k in
                ("predicted_tok_s", "measured_tok_s", "ratio", "band")})
    return result


def monitor_records(records: Iterable[dict],
                    policy: MonitorPolicy, *,
                    journal=None,
                    drift_extra: Mapping[str, Any] | None = None,
                    time_field: str = "t") -> dict:
    """Drive a monitor over a record stream and summarize.

    ``records`` may be a finished list (``Journal.read`` — the
    ``--replay`` path) or a live generator (``Journal.follow``); either
    way windows are keyed on event time, incidents fire as windows
    close, and the final partial window is flushed and judged."""
    agg = LiveAggregator(window_s=policy.window_s,
                         time_field=time_field, clock=None)
    mon = SLOMonitor(policy, journal=journal)
    for rec in records:
        for w in agg.add(rec):
            mon.observe(w)
    last = agg.flush()
    if last is not None:
        mon.observe(last)
    summary: dict[str, Any] = {
        "window_s": policy.window_s,
        "slo": {k: v for k, v in
                dataclasses.asdict(policy.slo).items()
                if v is not None},
        "n_windows": mon.n_windows,
        "n_evaluated": mon.n_windows - mon.n_skipped_warmup,
        "n_violating": mon.n_violating,
        "warmup_windows_skipped": mon.n_skipped_warmup,
        "state": mon.state,
        "breaches": sum(1 for i in mon.incidents
                        if i["kind"] == "breach"),
        "recoveries": sum(1 for i in mon.incidents
                          if i["kind"] == "recover"),
        "incidents": mon.incidents,
        "overall": agg.summary(),
        "windows": agg.windows,
    }
    if drift_extra is not None:
        summary["drift"] = drift_check(
            summary["overall"].get("tok_s"), drift_extra,
            journal=journal)
    return summary


def format_summary(summary: dict) -> str:
    """Human rendering of a monitor summary (the non-JSON CLI path)."""
    ov = summary.get("overall") or {}

    def ms(v):
        return f"{v * 1e3:.1f}ms" if v is not None else "n/a"

    lines = [
        f"monitor: {summary['n_windows']} window(s) x "
        f"{summary['window_s']:g}s, {ov.get('n_done', 0)} request(s), "
        f"state {summary['state'].upper()}",
        f"  ttft p50 {ms(ov.get('ttft_p50_s'))} "
        f"p99 {ms(ov.get('ttft_p99_s'))}   "
        f"itl p50 {ms(ov.get('itl_p50_s'))} "
        f"p99 {ms(ov.get('itl_p99_s'))}   "
        f"latency p99 {ms(ov.get('p99_s'))}",
    ]
    if ov.get("tok_s") is not None:
        lines.append(
            f"  throughput {ov['tok_s']:.1f} tok/s over "
            f"{ov.get('span_s', 0):g}s, "
            f"{ov.get('preemptions', 0)} preemption(s)")
    if summary.get("warmup_windows_skipped"):
        lines.append(
            f"  warmup: first {summary['warmup_windows_skipped']} "
            f"window(s) reported but not SLO-evaluated")
    for inc in summary.get("incidents", ()):
        if inc["kind"] == "breach":
            lines.append(
                f"  BREACH at window [{inc.get('window_start_s')}s, "
                f"{inc.get('window_end_s')}s): "
                + "; ".join(inc.get("violations", ())))
        else:
            lines.append(
                f"  recovered at window [{inc.get('window_start_s')}s, "
                f"{inc.get('window_end_s')}s) after "
                f"{inc.get('ok_windows')} clean window(s)")
    if not summary.get("incidents"):
        lines.append(
            f"  {summary.get('n_evaluated', 0)} evaluated window(s), "
            f"0 incident(s)")
    drift = summary.get("drift")
    if drift:
        if drift.get("within_band") is None:
            lines.append("  drift: not comparable (no throughput "
                         "measurement or prediction)")
        else:
            lines.append(
                f"  drift: measured {drift['measured_tok_s']:.1f} vs "
                f"predicted {drift['predicted_tok_s']:.1f} tok/s "
                f"(x{drift['ratio']:.2f}) — "
                + ("within" if drift["within_band"] else "OUTSIDE")
                + f" {drift['band']:g}x band")
    return "\n".join(lines)
