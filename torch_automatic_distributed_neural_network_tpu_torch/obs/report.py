"""`tadnn report`: join the event journal with MetricsLogger JSONL and
answer "where did the wall-clock go?" from artifacts the run produced.

The JAX package's ``obs/report.py``, copied (pure file parsing there
too): the same sections, messages and exit codes, so a journal either
package writes renders the same way.  It imports no ``torch``.

Inputs: a run directory (containing ``journal.jsonl`` and optionally
``metrics.jsonl``) or explicit file paths.  Output: one dict (``--json``)
or a human summary — throughput, MFU, compile/recompile accounting,
expected comm bytes vs. XLA bytes-accessed, goodput breakdown, and any
bench probe/tunnel incidents recorded in the journal.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any

from .journal import Journal
from .schema import names_for

# merged-first: a multihost run's aggregate view (obs/aggregate.py)
# carries host tags the per-host files lack
JOURNAL_NAMES = ("journal.merged.jsonl", "journal.jsonl", "events.jsonl")
METRICS_NAMES = ("metrics.jsonl",)


def _find(directory: str, names: tuple[str, ...], suffix: str) -> str | None:
    for n in names:
        p = os.path.join(directory, n)
        if os.path.isfile(p):
            return p
    hits = sorted(
        f for f in os.listdir(directory) if f.endswith(suffix)
    )
    return os.path.join(directory, hits[0]) if hits else None


def resolve_paths(target: str,
                  metrics: str | None = None) -> tuple[str, str | None]:
    """(journal_path, metrics_path) from a dir / journal file + override."""
    if os.path.isdir(target):
        jp = _find(target, JOURNAL_NAMES, ".journal.jsonl")
        if jp is None:
            raise FileNotFoundError(
                f"no journal (journal.jsonl / *.journal.jsonl) in {target}"
            )
        mp = metrics or _find(target, METRICS_NAMES, ".metrics.jsonl")
        return jp, mp
    return target, metrics


def _read_metrics(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out


def _finite(vals) -> list[float]:
    return [v for v in vals
            if isinstance(v, (int, float)) and math.isfinite(v)]


def _mean(vals) -> float | None:
    vals = _finite(vals)
    return sum(vals) / len(vals) if vals else None


def generate(target: str, metrics_path: str | None = None) -> dict:
    """Build the run-summary dict from on-disk artifacts."""
    journal_path, metrics_path = resolve_paths(target, metrics_path)
    events = Journal.read(journal_path)
    report: dict[str, Any] = {
        "journal": journal_path,
        "metrics": metrics_path,
        "n_journal_records": len(events),
    }
    if events:
        ts = _finite([e.get("t") for e in events])
        report["journal_wall_s"] = (max(ts) - min(ts)) if ts else 0.0

    def last(name):
        for e in reversed(events):
            if e.get("name") == name:
                return e
        return None

    plan = last("plan")
    if plan:
        report["plan"] = {k: plan.get(k)
                          for k in ("strategy", "mesh", "remat", "precision",
                                    "zero1")
                          if plan.get(k) is not None}
    decision = last("tune.decision")
    hit = last("tune.cache_hit")
    fallback = last("tune.fallback")
    chosen = decision or hit or fallback
    if chosen:
        tuning: dict[str, Any] = {
            "source": ("cache" if chosen is hit else
                       "fallback" if chosen is fallback else
                       chosen.get("source", "cost_model")),
            "strategy": chosen.get("strategy"),
            "mesh": chosen.get("degrees") or chosen.get("mesh"),
            "grad_accum": chosen.get("grad_accum"),
            "step_time_ms": chosen.get("step_time_ms"),
            "reason": chosen.get("reason"),
            "n_candidates": chosen.get("n_candidates"),
            "breakdown": chosen.get("breakdown"),
        }
        cands = [e for e in events if e.get("name") == "tune.candidate"]
        if cands:
            tuning["candidates"] = [
                {k: e.get(k) for k in
                 ("rank", "strategy", "mesh", "grad_accum",
                  "step_time_ms", "fits")}
                for e in cands
            ]
        trials = [e for e in events
                  if e.get("name") == "tune.trial.result"]
        if trials:
            tuning["trials"] = [
                {k: e.get(k) for k in
                 ("candidate", "step_time_ms", "error") if e.get(k)}
                for e in trials
            ]
        report["tuning"] = {k: v for k, v in tuning.items()
                            if v is not None}
    compiles = [e for e in events if e.get("name") == "compile"]
    recompiles = [e for e in events if e.get("name") == "recompile"]
    report["compile"] = {
        "count": len(compiles),
        "total_s": sum(_finite(e.get("dur_s") for e in compiles)),
        "recompile_count": len(recompiles),
        "recompile_total_s": sum(_finite(e.get("dur_s") for e in recompiles)),
        "recompile_reasons": [
            {k: e.get(k) for k in ("fn", "signature", "dur_s")}
            for e in recompiles
        ],
    }
    exports = [e for e in events
               if (e.get("name") or "").startswith("export.")]
    if exports:
        hits = [e for e in exports if e["name"] == "export.hit"]
        stores = [e for e in exports if e["name"] == "export.store"]
        stales = [e for e in exports if e["name"] == "export.stale"]
        deser = sum(_finite(e.get("deserialize_s") for e in hits))
        compw = sum(_finite(e.get("compile_s") for e in stores))
        exp: dict[str, Any] = {
            "hits": len(hits),
            "misses": len([e for e in exports
                           if e["name"] == "export.miss"]),
            "stores": len(stores),
            "stale": len(stales),
            "fallbacks": len([e for e in exports
                              if e["name"] == "export.fallback"]),
            "errors": len([e for e in exports
                           if e["name"] == "export.error"]),
            "prewarms": len([e for e in exports
                             if e["name"] == "export.prewarm"]),
            "gc_dropped": sum(
                int(e.get("dropped") or 0) for e in exports
                if e["name"] == "export.gc") or None,
            "gc_payload_bytes_freed": sum(
                int(e.get("payload_bytes_freed") or 0) for e in exports
                if e["name"] == "export.gc") or None,
            "deserialize_total_s": deser or None,
            "mean_deserialize_s": _mean(e.get("deserialize_s")
                                        for e in hits),
            "compile_total_s": compw or None,
            "mean_compile_s": _mean(e.get("compile_s") for e in stores),
            # the cold-start win this run actually realized: compile
            # wall of the entries it wrote vs deserialize wall of the
            # entries it read (same-config runs make this the speedup)
            "compile_over_deserialize": (
                round(compw / deser, 1) if compw and deser else None),
            "stale_reasons": [
                {k: e.get(k) for k in ("kind", "reason")}
                for e in stales
            ] or None,
        }
        report["export"] = {k: v for k, v in exp.items()
                            if v is not None}
    good = last("goodput")
    if good:
        report["goodput"] = {k: good.get(k)
                             for k in ("total_wall_s", "seconds",
                                       "fractions", "goodput")}
    comms = last("comms.estimate")
    if comms:
        report["comms"] = {k: comms.get(k)
                           for k in ("strategy", "total_wire_bytes",
                                     "per_device", "model_dependent")}
    cross = last("comms.crosscheck")
    if cross:
        report["comms_crosscheck"] = {
            k: cross.get(k)
            for k in ("expected_wire_bytes", "xla_bytes_accessed",
                      "comm_fraction_of_bytes_accessed", "consistent")}
    tsteps = [e for e in events if e.get("name") == "trace.step"]
    if tsteps:
        coll = sum(_finite(e.get("collective_s") for e in tsteps))
        exp = sum(_finite(e.get("exposed_collective_s") for e in tsteps))
        wall = sum(_finite(e.get("wall_s") for e in tsteps))
        trace: dict[str, Any] = {
            "n_steps": len(tsteps),
            "mean_wall_s": _mean(e.get("wall_s") for e in tsteps),
            "mean_compute_s": _mean(e.get("compute_s") for e in tsteps),
            "mean_collective_s": _mean(e.get("collective_s")
                                       for e in tsteps),
            "mean_exposed_s": _mean(e.get("exposed_collective_s")
                                    for e in tsteps),
            "collective_fraction": (coll / wall) if wall else None,
            # of the collective time, how much the schedule failed to
            # hide — the ROADMAP's overlap-push observable
            "exposed_fraction": (exp / coll) if coll else None,
            "mean_measured_mfu": _mean(e.get("measured_mfu")
                                       for e in tsteps
                                       if e.get("measured_mfu")
                                       is not None),
            "mfu_series": [
                {"step": e.get("step"), "mfu": e["measured_mfu"]}
                for e in tsteps if e.get("measured_mfu") is not None
            ][-24:],
        }
        report["trace"] = {k: v for k, v in trace.items()
                          if v not in (None, [])}
    tcoll = [e for e in events if e.get("name") == "trace.collective"]
    if tcoll:
        latest: dict[str, dict] = {}
        for e in tcoll:  # keep the newest record per category
            latest[e.get("category", "?")] = e
        report["trace_collectives"] = [
            {k: e.get(k) for k in
             ("category", "hlo_op", "count", "measured_bytes",
              "modeled_bytes", "ratio", "within_2x")}
            for e in latest.values()
        ]
    from .aggregate import host_skew

    skew = host_skew(events)
    if skew:
        report["hosts"] = skew
    probes = [e for e in events
              if str(e.get("name", "")).startswith("bench.")]
    if probes:
        report["bench_incidents"] = [
            {k: v for k, v in e.items() if k not in ("kind", "depth")}
            for e in probes
            if e.get("name") in ("bench.probe", "bench.stale",
                                 "bench.unmeasurable")
            and (e.get("probe_error") or e.get("stale")
                 or e.get("ok") is False)
        ]
    stalls = [e for e in events if e.get("name") == "watchdog.stall"]
    restarts = [e for e in events if e.get("name") == "elastic.restart"]
    corrupt = [e for e in events if e.get("name") == "ckpt.corrupt"]
    rollbacks = [e for e in events
                 if e.get("name") == "resilience.rollback"]
    chaos = [e for e in events if e.get("name") == "resilience.chaos"]
    escalations = [e for e in events
                   if e.get("name") == "resilience.stall_escalation"]
    exhausted = [e for e in events if e.get("name") == "data_exhausted"]
    if (stalls or restarts or corrupt or rollbacks or chaos
            or escalations or exhausted):
        report["incidents"] = {
            "watchdog_stalls": len(stalls),
            "elastic_restarts": len(restarts),
            "corrupt_checkpoints": len(corrupt),
            "anomaly_rollbacks": len(rollbacks),
            "chaos_faults": len(chaos),
            "stall_escalations": len(escalations),
            "data_exhausted": len(exhausted),
        }
        detail = []
        for e in corrupt:
            detail.append({"what": "ckpt.corrupt", "step": e.get("step"),
                           "reason": e.get("reason")})
        for e in rollbacks:
            detail.append({"what": "rollback", "reason": e.get("reason"),
                           "at_step": e.get("at_step"),
                           "to_step": e.get("to_step"),
                           "skipped_batches": e.get("skipped_batches")})
        if detail:
            report["incident_detail"] = detail
        gave_up = [e for e in restarts if e.get("gave_up")]
        if restarts:
            report["incidents"]["restarts_gave_up"] = len(gave_up)
    rounds = [e for e in events if e.get("name") == "launch.round"]
    lrestarts = [e for e in events if e.get("name") == "launch.restart"]
    lchaos = [e for e in events if e.get("name") == "launch.chaos"]
    replans = [e for e in events if e.get("name") == "launch.replan"]
    async_saves = [e for e in events if e.get("name") == "ckpt.async_save"]
    done = [e for e in events if e.get("name") == "launch.done"]
    if rounds or lrestarts or done:
        launch: dict = {
            "rounds": len(rounds),
            "restarts": len(lrestarts),
            "chaos_faults": [{"kind": e.get("kind"), "step": e.get("step"),
                              "host": e.get("host")} for e in lchaos],
            "replans": [{"from": e.get("world_from"),
                         "to": e.get("world_to")} for e in replans],
            "worlds": [e.get("world") for e in rounds],
            "completed": bool(done),
        }
        if lrestarts:
            launch["broken_by"] = [
                {"host": e.get("host"), "step": e.get("step"),
                 "reason": e.get("reason")} for e in lrestarts]
            launch["gave_up"] = any(e.get("gave_up") for e in lrestarts)
        if done:
            launch["final_step"] = done[-1].get("final_step")
            launch["final_loss"] = done[-1].get("final_loss")
        if async_saves:
            durs = _finite(e.get("off_thread_s") for e in async_saves)
            launch["async_saves"] = {
                "n": len(async_saves),
                "max_queue_depth": max((e.get("queue_depth") or 0)
                                       for e in async_saves),
                "mean_off_thread_s": (sum(durs) / len(durs)
                                      if durs else None),
            }
        report["launch"] = launch
    # the registry's deprecation table supplies every name this event
    # was ever emitted under (the r06 rename); older journals render
    sreqs = [e for e in events
             if e.get("name") in names_for("serve.request_done")]
    ssteps = [e for e in events if e.get("name") == "serve.step"]
    spreempt = [e for e in events if e.get("name") == "serve.preempt"]
    sengine = last("serve.engine")
    schunks = [e for e in events if e.get("name") == "serve.prefill_chunk"]
    if sreqs or ssteps:
        totals = sorted(_finite(e.get("total_s") for e in sreqs))

        def pct(vals, q):
            if not vals:
                return None
            return vals[min(len(vals) - 1,
                            max(0, math.ceil(q * len(vals)) - 1))]

        new_tokens = sum(_finite(e.get("n_new") for e in sreqs))
        ts = _finite([e.get("t") for e in sreqs + ssteps])
        wall = (max(ts) - min(ts)) if len(ts) > 1 else None
        serving: dict[str, Any] = {
            "n_requests": len(sreqs),
            "n_steps": len(ssteps),
            "p50_latency_s": pct(totals, 0.50),
            "p99_latency_s": pct(totals, 0.99),
            "mean_queue_s": _mean(e.get("queue_s") for e in sreqs),
            "mean_tokens_per_s": _mean(e.get("tokens_per_s")
                                       for e in sreqs),
            "total_new_tokens": new_tokens,
            # aggregate goodput: generated tokens over the serving
            # window — the number batching discipline moves
            "goodput_tokens_per_s": (new_tokens / wall
                                     if wall else None),
            "mean_occupancy": _mean(e.get("occupancy") for e in ssteps),
            "preemptions": (len(spreempt)
                            or sum(int(e.get("preempted") or 0)
                                   for e in sreqs)),
            # per-step phase breakdown (engines that journal the r02
            # fields; absent keys drop out below)
            "mean_decode_step_s": _mean(e.get("decode_s")
                                        for e in ssteps),
            "mean_prefill_step_s": _mean(e.get("prefill_s")
                                         for e in ssteps),
            "n_prefill_chunks": len(schunks) or None,
            "mean_prefill_chunk_s": _mean(e.get("seconds")
                                          for e in schunks),
            "attention_impl": (sengine or {}).get("attention_impl"),
            "prefill_chunk": (sengine or {}).get("prefill_chunk"),
            # disaggregated / sharded serving (r04 fields)
            "mode": (ssteps[-1].get("mode") if ssteps else None),
            "tp": (sengine or {}).get("tp"),
            "overlapped_wall_s": (sum(_finite(
                e.get("overlap_s") for e in ssteps)) or None),
        }
        # request span timelines (r06 serve.request_done fields): TTFT
        # and inter-token latency percentiles plus the mean phase mix —
        # where a request's wall time went, attributed per phase
        ttfts = sorted(_finite(e.get("ttft_s") for e in sreqs))
        itls = sorted(_finite(
            v for e in sreqs for v in (e.get("itl_s") or ())))
        if ttfts:
            serving["ttft_p50_s"] = pct(ttfts, 0.50)
            serving["ttft_p99_s"] = pct(ttfts, 0.99)
        if itls:
            serving["itl_p50_s"] = pct(itls, 0.50)
            serving["itl_p99_s"] = pct(itls, 0.99)
        phase_means = {
            label: _mean(e.get(key) for e in sreqs)
            for label, key in (("queue", "queue_s"),
                               ("prefill", "prefill_s"),
                               ("decode", "decode_s"),
                               ("lost", "lost_s"))}
        if any(v is not None for v in phase_means.values()):
            serving["phase_mean_s"] = {
                k: v for k, v in phase_means.items() if v is not None}
        ships = [e for e in events if e.get("name") == "serve.kv_ship"]
        if ships:
            serving["kv_ships"] = len(ships)
            serving["shipped_blocks"] = int(sum(
                _finite(e.get("n_blocks") for e in ships)))
            serving["shipped_bytes"] = int(sum(
                _finite(e.get("bytes") for e in ships)))
        spec = [e for e in events if e.get("name") == "serve.speculate"]
        if spec:
            drafted = sum(_finite(e.get("drafted") for e in spec))
            accepted = sum(_finite(e.get("accepted") for e in spec))
            serving["spec_rounds"] = len(spec)
            serving["spec_k"] = spec[-1].get("k")
            serving["spec_drafted"] = int(drafted)
            serving["spec_accepted"] = int(accepted)
            serving["spec_accept_rate"] = (accepted / drafted
                                           if drafted else None)
        sadapt = [e for e in events if e.get("name") == "serve.adapter"]
        occ_res = _mean(e.get("adapters_resident") for e in ssteps
                        if e.get("adapters_resident") is not None)
        if sadapt or occ_res is not None:
            hits = [e for e in sadapt if e.get("kind") == "hit"]
            faults = [e for e in sadapt if e.get("kind") == "fault"]
            serving["adapter_hits"] = len(hits)
            serving["adapter_faults"] = len(faults)
            serving["adapter_evictions"] = sum(
                1 for e in faults if e.get("evicted"))
            serving["adapter_stalls"] = sum(
                1 for e in sadapt if e.get("kind") == "stall")
            binds = len(hits) + len(faults)
            serving["adapter_hit_rate"] = (len(hits) / binds
                                           if binds else None)
            serving["mean_adapters_resident"] = occ_res
            serving["mean_adapters_pinned"] = _mean(
                e.get("adapters_pinned") for e in ssteps
                if e.get("adapters_pinned") is not None)
        sprefix = [e for e in events if e.get("name") == "serve.prefix"]
        if sprefix or any(e.get("prefix_blocks") is not None
                          for e in ssteps):
            matches = [e for e in sprefix if e.get("kind") == "match"]
            cached = int(sum(_finite(
                e.get("cached_tokens") for e in matches)))
            prompt_tokens = sum(_finite(
                e.get("n_prompt") for e in sreqs))
            serving["prefix_queries"] = len(matches)
            serving["prefix_hit_requests"] = sum(
                1 for e in matches if e.get("hit"))
            serving["prefix_cached_tokens"] = cached
            serving["prefix_hit_rate"] = (
                cached / prompt_tokens if prompt_tokens else None)
            chunk = serving.get("prefill_chunk")
            # per-request floor, matching the engine: a cached span
            # shorter than one chunk skips nothing
            serving["prefix_saved_chunks"] = (
                int(sum(int(t) // chunk for t in _finite(
                    e.get("cached_tokens") for e in matches)))
                if chunk else None)
            serving["prefix_published_blocks"] = int(sum(_finite(
                e.get("n_blocks") for e in sprefix
                if e.get("kind") == "publish")))
            serving["cow_forks"] = sum(
                1 for e in sprefix if e.get("kind") == "cow")
            resident = [e.get("prefix_blocks") for e in ssteps
                        if e.get("prefix_blocks") is not None]
            serving["prefix_blocks"] = (resident[-1] if resident
                                        else None)
        report["serving"] = {k: v for k, v in serving.items()
                             if v is not None}
    # SLO incidents (obs/slo_monitor): breach/recover transitions the
    # monitor journaled while watching (or replaying) this run
    breaches = [e for e in events if e.get("name") == "slo.breach"]
    recovers = [e for e in events if e.get("name") == "slo.recover"]
    if breaches or recovers:
        report["slo_incidents"] = {
            "breaches": len(breaches),
            "recoveries": len(recovers),
            "incidents": sorted(
                ([{"kind": "breach",
                   "window_start_s": e.get("window_start_s"),
                   "window_end_s": e.get("window_end_s"),
                   "violations": e.get("violations") or []}
                  for e in breaches]
                 + [{"kind": "recover",
                     "window_start_s": e.get("window_start_s"),
                     "window_end_s": e.get("window_end_s"),
                     "ok_windows": e.get("ok_windows")}
                    for e in recovers]),
                key=lambda i: (i.get("window_start_s") or 0.0)),
        }
    # gateway fleet events (inference/gateway): ingress admission,
    # replan decisions, and elastic resizes from the closed-loop
    # autoscaler
    greqs = [e for e in events if e.get("name") == "gateway.request"]
    grejects = [e for e in events if e.get("name") == "gateway.reject"]
    greplans = [e for e in events if e.get("name") == "gateway.replan"]
    gscales = [e for e in events if e.get("name") == "gateway.scale"]
    gfails = [e for e in events
              if e.get("name") == "gateway.failover"
              and e.get("kind") != "parked"]
    ghedges = [e for e in events if e.get("name") == "gateway.hedge"]
    gbreaker = [e for e in events if e.get("name") == "gateway.breaker"]
    gdegrade = [e for e in events
                if e.get("name") in ("gateway.degrade",
                                     "gateway.restore")]
    if (greqs or grejects or greplans or gscales or gfails
            or ghedges or gbreaker or gdegrade):
        gw: dict[str, Any] = {
            "requests": len(greqs),
            "rejected": len(grejects),
            "rejected_rate_limit": sum(
                1 for e in grejects if e.get("kind") == "rate_limit"),
            "rejected_backpressure": sum(
                1 for e in grejects if e.get("kind") == "backpressure"),
            "rejected_degraded": sum(
                1 for e in grejects if e.get("kind") == "degraded"),
            "failovers": [
                {"t": e.get("t"), "replica": e.get("replica"),
                 "reason": e.get("reason"),
                 "n_requeued": e.get("n_requeued")}
                for e in gfails],
            "hedges_dispatched": sum(
                1 for e in ghedges if e.get("kind") == "dispatch"),
            "hedges_won": sum(
                1 for e in ghedges if e.get("kind") == "win"
                and e.get("winner") == "hedge"),
            "breaker_opens": sum(
                1 for e in gbreaker if e.get("to") == "open"),
            "degrade_history": [
                {"t": e.get("t"),
                 "kind": e.get("name", ".").split(".", 1)[1],
                 "level": e.get("level"), "reason": e.get("reason")}
                for e in gdegrade],
            "replans": [
                {"t": e.get("t"), "reason": e.get("reason"),
                 "current": e.get("current"), "chosen": e.get("chosen"),
                 "rate_per_s": e.get("rate_per_s")}
                for e in greplans],
            "scales": [
                {"t": e.get("t"), "kind": e.get("kind"),
                 "replica": e.get("replica"),
                 "reason": e.get("reason"),
                 "n_replicas": e.get("n_replicas"),
                 "requeued": e.get("requeued")}
                for e in gscales],
        }
        if gscales:
            final = [e.get("n_replicas") for e in gscales
                     if e.get("n_replicas") is not None]
            gw["final_replicas"] = final[-1] if final else None
        report["gateway"] = gw
    # planner drift (obs/slo_monitor.drift_check): measured throughput
    # left the simulate prediction's 2x band
    drifts = [e for e in events if e.get("name") == "simulate.drift"]
    if drifts:
        report["drift"] = [
            {"predicted_tok_s": e.get("predicted_tok_s"),
             "measured_tok_s": e.get("measured_tok_s"),
             "ratio": e.get("ratio"), "band": e.get("band")}
            for e in drifts]
    lint_findings = [e for e in events if e.get("name") == "lint.finding"]
    lint_summary = last("lint.summary")
    lint_skipped = last("lint.skipped")
    if lint_findings or lint_summary or lint_skipped:
        lint: dict[str, Any] = {
            "errors": (lint_summary or {}).get("errors",
                                               len([f for f in lint_findings
                                                    if f.get("severity")
                                                    == "error"])),
            "warnings": (lint_summary or {}).get("warnings",
                                                 len([f for f in lint_findings
                                                      if f.get("severity")
                                                      == "warn"])),
            "by_code": (lint_summary or {}).get("by_code"),
            "phase": (lint_summary or lint_skipped or {}).get("phase"),
            "findings": [
                {k: e.get(k) for k in ("code", "severity", "where", "msg")}
                for e in lint_findings
            ],
        }
        if lint_skipped:
            lint["skipped"] = lint_skipped.get("error")
        report["lint"] = {k: v for k, v in lint.items() if v is not None}
    protocol = [e for e in events if e.get("name") == "lint.protocol"]
    if protocol:
        report["protocol"] = [
            {k: e.get(k) for k in ("model", "scope", "states",
                                   "transitions", "depth", "frontier_peak",
                                   "wall_s", "complete", "violations")}
            for e in protocol]
    mem_est = last("lint.mem_estimate")
    if mem_est:
        keys = ("params_bytes", "optimizer_bytes", "model_state_bytes",
                "batch_bytes", "activation_bytes", "peak_bytes",
                "budget_bytes", "strategy", "degrees", "grad_accum",
                "remat", "phase", "static_over_compiled")
        me = {k: mem_est.get(k) for k in keys if mem_est.get(k) is not None}
        compiled = mem_est.get("compiled") or {}
        if compiled.get("per_device_peak_bytes"):
            me["compiled_peak_bytes"] = compiled["per_device_peak_bytes"]
        report["memory_estimate"] = me
    sest = last("lint.serve_estimate")
    if sest:
        report["serve_estimate"] = {
            k: sest.get(k)
            for k in ("max_streams", "requested_streams", "num_blocks",
                      "blocks_per_stream", "block_size", "max_len",
                      "quant_kv", "budget_bytes",
                      "block_bytes_per_device", "attention_impl",
                      "decode_workspace_bytes", "adapter_pool_bytes",
                      "n_adapters", "adapter_rank", "quant_adapters",
                      "prefix_cache", "prefix_index_bytes",
                      "expected_hit_rate", "effective_max_streams")
            if sest.get(k) is not None}
    ssweep = last("simulate.sweep")
    scands = [e for e in events if e.get("name") == "simulate.candidate"]
    sdec = last("simulate.decision")
    scross = last("simulate.crosscheck")
    if ssweep or scands or sdec or scross:
        sim: dict[str, Any] = {}
        if ssweep:
            sim.update({k: ssweep.get(k)
                        for k in ("n_topologies", "n_candidates",
                                  "n_replays", "n_slo_ok")
                        if ssweep.get(k) is not None})
        if scands:
            sim["ranked"] = [
                {k: e.get(k) for k in
                 ("rank", "topology", "plan", "admission", "mfu",
                  "step_time_s", "hbm_headroom_frac", "tok_s_per_chip",
                  "p99_s", "survival", "slo_ok", "slo_violations")}
                for e in scands]
        if sdec:
            sim["decision"] = {
                k: sdec.get(k) for k in
                ("topology", "plan", "admission", "slo_ok",
                 "slo_violations", "mfu", "tok_s_per_chip", "p99_s",
                 "hbm_headroom_frac", "survival")}
        if scross:
            sim["crosscheck"] = {
                k: scross.get(k) for k in
                ("record", "predicted_tok_s", "measured_tok_s",
                 "tok_s_ratio", "predicted_occupancy",
                 "measured_occupancy", "occupancy_ratio",
                 "predicted_preemptions", "measured_preemptions",
                 "within_2x")}
        report["simulate"] = sim
    if metrics_path and os.path.isfile(metrics_path):
        recs = _read_metrics(metrics_path)
        steps = [r for r in recs if "step_time_s" in r]
        per_chip = [v for r in steps for k, v in r.items()
                    if k.endswith("_per_sec_per_chip") and v]
        report["training"] = {
            "n_step_records": len(steps),
            "last_step": max((r.get("step", 0) for r in steps), default=None),
            "mean_step_time_s": _mean(r.get("step_time_s") for r in steps),
            "items_per_sec_per_chip": _mean(per_chip),
            "mean_mfu": _mean(r.get("mfu") for r in steps
                              if "mfu" in r),
            "final_loss": next(
                (r["loss"] for r in reversed(steps) if "loss" in r), None),
        }
    return report


def _fmt_bytes(n) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def format_report(report: dict) -> str:
    """Human-readable rendering of :func:`generate`'s dict."""
    lines = [f"run journal: {report['journal']} "
             f"({report['n_journal_records']} records, "
             f"{report.get('journal_wall_s', 0.0):.1f}s span)"]
    plan = report.get("plan")
    if plan:
        strat = str(plan.get("strategy"))
        if plan.get("zero1"):
            strat += "+zero1"
        lines.append(f"plan: strategy={strat} "
                     f"mesh={plan.get('mesh')}")
    tun = report.get("tuning")
    if tun:
        head = (f"tuner: strategy={tun.get('strategy')} "
                f"mesh={tun.get('mesh')} ({tun.get('source')}")
        if tun.get("n_candidates"):
            head += f", {tun['n_candidates']} candidates"
        if tun.get("step_time_ms") is not None:
            head += f", modeled {tun['step_time_ms']:.3f}ms/step"
        lines.append(head + ")")
        if tun.get("reason"):
            lines.append(f"  {tun['reason']}")
        b = tun.get("breakdown")
        if b:
            lines.append(
                "  breakdown: " + "  ".join(
                    f"{k.removesuffix('_ms')} {b[k]:.3f}ms"
                    for k in ("compute_ms", "comm_ms", "hbm_ms",
                              "latency_ms") if b.get(k) is not None))
        trials = tun.get("trials")
        if trials:
            ok = [t for t in trials if t.get("step_time_ms") is not None]
            msg = f"  measured trials: {len(trials)}"
            if ok:
                best = min(ok, key=lambda t: t["step_time_ms"])
                msg += (f", best {best.get('candidate')} "
                        f"{best['step_time_ms']:.3f}ms")
            lines.append(msg)
    c = report["compile"]
    lines.append(
        f"compiles: {c['count']} ({c['total_s']:.2f}s)   "
        f"recompiles: {c['recompile_count']} "
        f"({c['recompile_total_s']:.2f}s)"
        + ("  <- shape churn, check input pipeline"
           if c["recompile_count"] else "")
    )
    ex = report.get("export")
    if ex:
        parts = [f"export cache: {ex.get('hits', 0)} hit(s)"]
        if ex.get("mean_deserialize_s") is not None:
            parts.append(
                f"deserialize {ex['mean_deserialize_s'] * 1e3:.1f}ms mean")
        if ex.get("stores"):
            parts.append(f"{ex['stores']} store(s)")
        if ex.get("mean_compile_s") is not None:
            parts.append(f"compile {ex['mean_compile_s']:.2f}s mean")
        if ex.get("compile_over_deserialize"):
            parts.append(
                f"{ex['compile_over_deserialize']}x compile/deserialize")
        if ex.get("prewarms"):
            parts.append(f"{ex['prewarms']} prewarm(s)")
        if ex.get("gc_dropped"):
            parts.append(
                f"gc dropped {ex['gc_dropped']} "
                f"({_fmt_bytes(ex.get('gc_payload_bytes_freed') or 0)} "
                f"freed)")
        lines.append("  ".join(parts))
        if ex.get("stale"):
            reasons = ex.get("stale_reasons") or []
            first = reasons[0].get("reason") if reasons else None
            lines.append(
                f"  STALE entries skipped: {ex['stale']} (recompiled)"
                + (f" — {first}" if first else ""))
        if ex.get("fallbacks"):
            lines.append(
                f"  !! {ex['fallbacks']} exported executable(s) "
                f"rejected runtime args — fell back to jit")
        if ex.get("errors"):
            lines.append(f"  !! {ex['errors']} export error(s) "
                         f"(see export.error events)")
    tr = report.get("training")
    if tr:
        parts = [f"steps logged: {tr['n_step_records']}"]
        if tr.get("mean_step_time_s") is not None:
            parts.append(f"mean step {tr['mean_step_time_s'] * 1e3:.1f}ms")
        if tr.get("items_per_sec_per_chip"):
            parts.append(f"{tr['items_per_sec_per_chip']:,.0f} items/s/chip")
        if tr.get("mean_mfu") is not None:
            parts.append(f"MFU {tr['mean_mfu']:.1%}")
        if tr.get("final_loss") is not None:
            parts.append(f"final loss {tr['final_loss']:.4f}")
        lines.append("training: " + "  ".join(parts))
    good = report.get("goodput")
    if good and good.get("fractions"):
        fr = good["fractions"]
        lines.append(
            "goodput: {:.1%} of {:.1f}s wall".format(
                good.get("goodput", 0.0), good.get("total_wall_s", 0.0))
        )
        lines.append("  " + "  ".join(
            f"{b} {fr[b]:.1%}" for b in
            ("compile", "step", "checkpoint", "eval", "trace",
             "input_stall", "idle")
            if b in fr))
    comms = report.get("comms")
    if comms:
        per = comms.get("per_device") or {}
        lines.append(
            f"comms (per device/step, {comms.get('strategy')}): "
            f"wire { _fmt_bytes(comms.get('total_wire_bytes')) }   "
            + "  ".join(f"{k} {_fmt_bytes(v)}" for k, v in per.items() if v)
        )
        md = comms.get("model_dependent")
        if md:
            lines.append(f"  model-dependent (unquantified): {', '.join(md)}")
    cross = report.get("comms_crosscheck")
    if cross and cross.get("xla_bytes_accessed"):
        lines.append(
            f"  XLA bytes-accessed {_fmt_bytes(cross['xla_bytes_accessed'])}"
            f" -> comm fraction "
            f"{cross.get('comm_fraction_of_bytes_accessed') or 0:.1%}"
            + ("" if cross.get("consistent") else
               "  !! estimate exceeds measurement")
        )
    trc = report.get("trace")
    if trc:
        head = f"trace: {trc['n_steps']} instrumented step(s)"
        if trc.get("mean_wall_s") is not None:
            head += f", mean wall {trc['mean_wall_s'] * 1e3:.1f}ms"
        if trc.get("mean_measured_mfu") is not None:
            head += f", measured MFU {trc['mean_measured_mfu']:.1%}"
        lines.append(head)
        if trc.get("collective_fraction") is not None:
            exp = trc.get("exposed_fraction")
            lines.append(
                f"  collective {trc['collective_fraction']:.1%} of step "
                f"wall"
                + (f", exposed {exp:.1%} of collective time"
                   if exp is not None else "")
            )
        series = trc.get("mfu_series")
        if series and len(series) > 1:
            lines.append("  mfu over time: " + "  ".join(
                f"s{p['step']} {p['mfu']:.1%}" for p in series[-8:]))
    tc = report.get("trace_collectives")
    if tc:
        lines.append("exposed-comm crosscheck (measured HLO vs modeled "
                     "planner bytes, per device/step):")
        for e in tc:
            lines.append(
                f"  {e.get('category'):<20} x{e.get('count', 0)}  "
                f"measured {_fmt_bytes(e.get('measured_bytes'))}  "
                f"modeled {_fmt_bytes(e.get('modeled_bytes'))}  "
                f"ratio {e.get('ratio')}"
                + ("" if e.get("within_2x") else "  !! outside 2x band")
            )
    hosts = report.get("hosts")
    if hosts:
        sf = hosts.get("skew_fraction")
        lines.append(
            f"hosts: {hosts['n_hosts']}  {hosts.get('event')} "
            f"{hosts.get('field')} "
            f"{hosts['fastest'] * 1e3:.1f}..{hosts['slowest'] * 1e3:.1f}ms"
            + (f"  skew {sf:.1%}" if sf is not None else "")
            + ("  <- straggler gates every collective"
               if sf is not None and sf > 0.1 else "")
        )
    inc = report.get("incidents")
    if inc:
        parts = [f"{inc['watchdog_stalls']} watchdog stalls",
                 f"{inc['elastic_restarts']} elastic restarts"]
        for key, label in (("corrupt_checkpoints", "corrupt checkpoints"),
                           ("anomaly_rollbacks", "anomaly rollbacks"),
                           ("chaos_faults", "chaos faults"),
                           ("stall_escalations", "stall escalations"),
                           ("data_exhausted", "data exhaustions")):
            if inc.get(key):
                parts.append(f"{inc[key]} {label}")
        if inc.get("restarts_gave_up"):
            parts.append(f"{inc['restarts_gave_up']} gave up (budget)")
        lines.append("incidents: " + ", ".join(parts))
        for d in report.get("incident_detail", [])[-4:]:
            if d["what"] == "ckpt.corrupt":
                lines.append(f"  ckpt.corrupt step {d.get('step')}: "
                             f"{d.get('reason')}")
            else:
                lines.append(
                    f"  rollback ({d.get('reason')}): step "
                    f"{d.get('at_step')} -> {d.get('to_step')}, skipped "
                    f"{d.get('skipped_batches')} batch(es)")
    la = report.get("launch")
    if la:
        worlds = la.get("worlds") or []
        head = (f"launch: {la.get('rounds', 0)} round(s), "
                f"{la.get('restarts', 0)} cohort restart(s), worlds "
                + (" -> ".join(str(w) for w in worlds) if worlds else "?"))
        if la.get("completed"):
            head += (f"; completed at step {la.get('final_step')}"
                     + (f" loss {la['final_loss']:.6g}"
                        if la.get("final_loss") is not None else ""))
        elif la.get("gave_up"):
            head += "; GAVE UP (restart budget)"
        lines.append(head)
        for f in la.get("chaos_faults", [])[-4:]:
            lines.append(f"  chaos {f.get('kind')} -> host "
                         f"{f.get('host')} at step {f.get('step')}")
        for b in la.get("broken_by", [])[-3:]:
            lines.append(f"  cohort broken by host {b.get('host')} at "
                         f"step {b.get('step')}: {b.get('reason')}")
        for r in la.get("replans", []):
            lines.append(f"  replanned world {r.get('from')} -> "
                         f"{r.get('to')} (choose_strategy at new size)")
        asv = la.get("async_saves")
        if asv:
            mean = asv.get("mean_off_thread_s")
            lines.append(
                f"  async saves: {asv['n']}, max queue depth "
                f"{asv['max_queue_depth']}"
                + (f", mean off-thread {mean * 1e3:.1f}ms"
                   if mean is not None else ""))
    sv = report.get("serving")
    if sv:
        head = f"serving: {sv.get('n_requests', 0)} request(s)"
        if sv.get("p50_latency_s") is not None:
            head += (f", latency p50 {sv['p50_latency_s'] * 1e3:.0f}ms"
                     f" p99 {sv.get('p99_latency_s', 0) * 1e3:.0f}ms")
        if sv.get("goodput_tokens_per_s") is not None:
            head += f", goodput {sv['goodput_tokens_per_s']:.1f} tok/s"
        lines.append(head)
        parts = []
        if sv.get("ttft_p50_s") is not None:
            tl = (f"  timeline: ttft p50 {sv['ttft_p50_s'] * 1e3:.1f}ms"
                  f" p99 {sv.get('ttft_p99_s', 0) * 1e3:.1f}ms")
            if sv.get("itl_p50_s") is not None:
                tl += (f"  itl p50 {sv['itl_p50_s'] * 1e3:.2f}ms"
                       f" p99 {sv.get('itl_p99_s', 0) * 1e3:.2f}ms")
            pm = sv.get("phase_mean_s") or {}
            if pm:
                tl += ("  phase mix " + " ".join(
                    f"{k} {v * 1e3:.0f}ms" for k, v in pm.items()))
            lines.append(tl)
        if sv.get("mean_occupancy") is not None:
            parts.append(f"slot occupancy {sv['mean_occupancy']:.1%} "
                         f"over {sv.get('n_steps', 0)} step(s)")
        if sv.get("mean_queue_s") is not None:
            parts.append(f"mean queue {sv['mean_queue_s'] * 1e3:.0f}ms")
        if sv.get("mean_tokens_per_s") is not None:
            parts.append(
                f"per-request {sv['mean_tokens_per_s']:.1f} tok/s")
        parts.append(f"{sv.get('preemptions', 0)} preemption(s)")
        lines.append("  " + "  ".join(parts))
        bparts = []
        if sv.get("attention_impl"):
            bparts.append(f"decode impl {sv['attention_impl']}")
        if sv.get("mean_decode_step_s") is not None:
            bparts.append(
                f"decode step {sv['mean_decode_step_s'] * 1e3:.1f}ms")
        if sv.get("mean_prefill_chunk_s") is not None:
            bparts.append(
                f"prefill chunk {sv['mean_prefill_chunk_s'] * 1e3:.1f}ms"
                f" x{sv.get('n_prefill_chunks', 0)}"
                + (f" (C={sv['prefill_chunk']})"
                   if sv.get("prefill_chunk") else ""))
        if bparts:
            lines.append("  " + "  ".join(bparts))
        if sv.get("mode") == "disaggregated" or (sv.get("tp") or 1) > 1:
            dparts = [f"mode {sv.get('mode') or 'colocated'}"]
            if (sv.get("tp") or 1) > 1:
                dparts.append(f"tp {sv['tp']}")
            if sv.get("overlapped_wall_s") is not None:
                dparts.append(
                    f"overlapped wall {sv['overlapped_wall_s']:.2f}s")
            if sv.get("kv_ships"):
                dparts.append(
                    f"kv ships {sv['kv_ships']} "
                    f"({sv.get('shipped_blocks', 0)} block(s), "
                    f"{sv.get('shipped_bytes', 0) / 1024:.0f} KiB)")
            lines.append("  " + "  ".join(dparts))
        if sv.get("spec_rounds"):
            rate = sv.get("spec_accept_rate")
            lines.append(
                f"  speculative: k={sv.get('spec_k')}, "
                f"{sv.get('spec_accepted', 0)}/{sv.get('spec_drafted', 0)} "
                "drafts accepted"
                + (f" ({rate:.1%})" if rate is not None else "")
                + f" over {sv['spec_rounds']} round(s)")
        if ("adapter_hits" in sv or "adapter_faults" in sv
                or sv.get("mean_adapters_resident") is not None):
            aparts = [
                f"{sv.get('adapter_hits', 0)} hit(s) / "
                f"{sv.get('adapter_faults', 0)} fault(s)"]
            if sv.get("adapter_hit_rate") is not None:
                aparts.append(f"hit rate {sv['adapter_hit_rate']:.1%}")
            if sv.get("adapter_evictions"):
                aparts.append(f"{sv['adapter_evictions']} eviction(s)")
            if sv.get("adapter_stalls"):
                aparts.append(f"{sv['adapter_stalls']} pool stall(s)")
            if sv.get("mean_adapters_resident") is not None:
                aparts.append(
                    f"mean resident {sv['mean_adapters_resident']:.1f}"
                    + (f" (pinned {sv['mean_adapters_pinned']:.1f})"
                       if sv.get("mean_adapters_pinned") is not None
                       else ""))
            lines.append("  adapters: " + "  ".join(aparts))
        if "prefix_queries" in sv or sv.get("prefix_blocks") is not None:
            pparts = [
                f"{sv.get('prefix_hit_requests', 0)}/"
                f"{sv.get('prefix_queries', 0)} request(s) hit"]
            if sv.get("prefix_hit_rate") is not None:
                pparts.append(
                    f"hit rate {sv['prefix_hit_rate']:.1%} "
                    f"({sv.get('prefix_cached_tokens', 0)} cached "
                    f"token(s))")
            if sv.get("prefix_saved_chunks") is not None:
                pparts.append(
                    f"{sv['prefix_saved_chunks']} prefill chunk(s) "
                    f"saved")
            if sv.get("cow_forks"):
                pparts.append(f"{sv['cow_forks']} CoW fork(s)")
            if sv.get("prefix_blocks") is not None:
                pparts.append(f"{sv['prefix_blocks']} block(s) indexed")
            lines.append("  prefix cache: " + "  ".join(pparts))
    slo = report.get("slo_incidents")
    if slo:
        lines.append(f"slo incidents: {slo.get('breaches', 0)} "
                     f"breach(es), {slo.get('recoveries', 0)} "
                     f"recovery(ies)")
        for inc in slo.get("incidents", ()):
            where = (f"window [{inc.get('window_start_s')}s, "
                     f"{inc.get('window_end_s')}s)")
            if inc.get("kind") == "breach":
                lines.append("  BREACH " + where + ": "
                             + "; ".join(inc.get("violations") or ()))
            else:
                lines.append(
                    "  recovered " + where
                    + (f" after {inc['ok_windows']} clean window(s)"
                       if inc.get("ok_windows") is not None else ""))
    gw = report.get("gateway")
    if gw:
        rej = gw.get("rejected", 0)
        lines.append(
            f"gateway: {gw.get('requests', 0)} request(s) accepted, "
            f"{rej} rejected"
            + (f" ({gw.get('rejected_rate_limit', 0)} rate-limit, "
               f"{gw.get('rejected_backpressure', 0)} backpressure)"
               if rej else ""))
        for rp in gw.get("replans", ()):
            lines.append(
                f"  replan t={(rp.get('t') or 0.0):7.2f}s "
                f"[{rp.get('reason')}]: {rp.get('current')} -> "
                f"{rp.get('chosen')} replica(s) at "
                f"{(rp.get('rate_per_s') or 0):.0f} req/s")
        for sc in gw.get("scales", ()):
            what = (f"scale-{sc.get('kind')}" if sc.get("kind")
                    else "scale")
            extra = (f", {sc['requeued']} request(s) requeued"
                     if sc.get("requeued") is not None else "")
            lines.append(
                f"  {what} t={(sc.get('t') or 0.0):7.2f}s: "
                f"{sc.get('replica')} -> fleet of "
                f"{sc.get('n_replicas')}{extra}")
        for fo in gw.get("failovers", ()):
            lines.append(
                f"  failover t={(fo.get('t') or 0.0):7.2f}s: "
                f"{fo.get('replica')} ({fo.get('reason')}), "
                f"{fo.get('n_requeued')} request(s) salvaged")
        if gw.get("hedges_dispatched"):
            lines.append(
                f"  hedges: {gw['hedges_dispatched']} dispatched, "
                f"{gw.get('hedges_won', 0)} won")
        if gw.get("breaker_opens"):
            lines.append(
                f"  circuit breaker: opened "
                f"{gw['breaker_opens']} time(s)")
        for dg in gw.get("degrade_history", ()):
            lines.append(
                f"  {dg.get('kind')} t={(dg.get('t') or 0.0):7.2f}s: "
                f"level {dg.get('level')} ({dg.get('reason') or '?'})")
        if gw.get("final_replicas") is not None:
            lines.append(
                f"  final fleet: {gw['final_replicas']} replica(s)")
    drift = report.get("drift")
    if drift:
        for d in drift:
            lines.append(
                f"planner drift: measured "
                f"{(d.get('measured_tok_s') or 0):.1f} tok/s vs "
                f"predicted {(d.get('predicted_tok_s') or 0):.1f} "
                f"(x{(d.get('ratio') or 0):.2f}, outside "
                f"{(d.get('band') or 0):g}x band)")
    sest = report.get("serve_estimate")
    if sest:
        head = (f"serve estimate: {sest.get('max_streams')} stream(s) "
                f"of {sest.get('max_len')} tokens "
                f"({sest.get('num_blocks')} blocks x "
                f"bs {sest.get('block_size')}"
                f"{', int8 KV' if sest.get('quant_kv') else ''})")
        if sest.get("requested_streams") is not None:
            head += f", requested {sest['requested_streams']}"
        if sest.get("attention_impl"):
            head += f", {sest['attention_impl']} decode"
        if sest.get("decode_workspace_bytes"):
            head += (f" (+{sest['decode_workspace_bytes'] // 1024} KiB "
                     f"gather workspace)")
        if sest.get("n_adapters"):
            head += (f", adapter pool {sest['n_adapters']}x "
                     f"r{sest.get('adapter_rank')} "
                     f"{'int8' if sest.get('quant_adapters') else 'f32'} "
                     f"({_fmt_bytes(sest.get('adapter_pool_bytes'))})")
        if sest.get("prefix_cache"):
            head += (f", prefix index "
                     f"{_fmt_bytes(sest.get('prefix_index_bytes'))}")
            if sest.get("effective_max_streams") is not None:
                head += (f" (~{sest['effective_max_streams']} effective "
                         f"stream(s) at "
                         f"{sest.get('expected_hit_rate') or 0:.0%} hit "
                         f"rate)")
        lines.append(head)
    sim = report.get("simulate")
    if sim:
        head = "simulate:"
        if sim.get("n_candidates") is not None:
            head += (f" {sim['n_candidates']} candidate(s) over "
                     f"{sim.get('n_topologies', '?')} topology(ies)")
            if sim.get("n_replays") is not None:
                head += f", {sim['n_replays']} serve replay(s)"
            if sim.get("n_slo_ok") is not None:
                head += f", {sim['n_slo_ok']} meet the SLO"
        lines.append(head)
        for e in (sim.get("ranked") or [])[:8]:
            mfu = (f"mfu {e['mfu']:.1%}"
                   if e.get("mfu") is not None else "mfu -")
            step = (f"step {e['step_time_s'] * 1e3:.1f}ms"
                    if e.get("step_time_s") is not None else "step -")
            hd = (f"headroom {e['hbm_headroom_frac']:.0%}"
                  if e.get("hbm_headroom_frac") is not None
                  else "headroom -")
            tok = (f"{e['tok_s_per_chip']:.1f} tok/s/chip"
                   if e.get("tok_s_per_chip") is not None else "- tok/s")
            p99 = (f"p99 {e['p99_s'] * 1e3:.0f}ms"
                   if e.get("p99_s") is not None else "p99 -")
            surv = (f"surv {e['survival']:.3f}"
                    if e.get("survival") is not None else "surv -")
            tail = (" ok" if e.get("slo_ok")
                    else "  !! " + "; ".join(e.get("slo_violations")
                                             or ("no SLO result",)))
            lines.append(
                f"  #{e.get('rank')} {e.get('topology')} "
                f"{e.get('plan')} [{e.get('admission')}]  "
                f"{mfu}  {step}  {hd}  {tok}  {p99}  {surv} " + tail)
        cc = sim.get("crosscheck")
        if cc:
            lines.append(
                f"  crosscheck vs {cc.get('record')}: "
                f"tok/s {cc.get('predicted_tok_s')} predicted / "
                f"{cc.get('measured_tok_s')} measured "
                f"(ratio {cc.get('tok_s_ratio')}), "
                f"occupancy ratio {cc.get('occupancy_ratio')}"
                + ("" if cc.get("within_2x")
                   else "  !! outside 2x band"))
    lint = report.get("lint")
    if lint:
        head = (f"lint ({lint.get('phase', 'check')}): "
                f"{lint.get('errors', 0)} error(s), "
                f"{lint.get('warnings', 0)} warning(s)")
        by_code = lint.get("by_code")
        if by_code:
            head += "  [" + "  ".join(
                f"{c}×{n}" for c, n in sorted(by_code.items())) + "]"
        lines.append(head)
        for f in lint.get("findings", [])[-6:]:
            lines.append(f"  {f.get('code')} {f.get('severity')} "
                         f"{f.get('where')}: {f.get('msg')}")
        if lint.get("skipped"):
            lines.append(f"  preflight skipped: {lint['skipped']}")
    protocol = report.get("protocol")
    if protocol:
        lines.append("protocol model check:")
        for p in protocol:
            status = ("ok" if p.get("complete") and not p.get("violations")
                      else "TRUNCATED" if not p.get("complete")
                      else "VIOLATED")
            lines.append(
                f"  {p.get('model')}: {p.get('states')} states / "
                f"{p.get('transitions')} transitions, depth "
                f"{p.get('depth')}, frontier peak "
                f"{p.get('frontier_peak')}, {p.get('wall_s')}s — "
                f"{status}"
                + (f" ({p.get('violations')} counterexample(s))"
                   if p.get("violations") else ""))
    me = report.get("memory_estimate")
    if me:
        mesh = "x".join(f"{a}{n}" for a, n in
                        sorted((me.get("degrees") or {}).items()))
        head = (f"memory estimate (static, per device): peak "
                f"{_fmt_bytes(me.get('peak_bytes'))}")
        if me.get("budget_bytes"):
            head += f" / budget {_fmt_bytes(me['budget_bytes'])}"
        head += (f"  [{me.get('strategy')} mesh {mesh or '1'}"
                 f"{', remat' if me.get('remat') else ''}]")
        lines.append(head)
        lines.append(
            f"  params {_fmt_bytes(me.get('params_bytes'))}"
            f"  optimizer {_fmt_bytes(me.get('optimizer_bytes'))}"
            f"  activations {_fmt_bytes(me.get('activation_bytes'))}"
            f"  batch {_fmt_bytes(me.get('batch_bytes'))}")
        if me.get("compiled_peak_bytes"):
            lines.append(
                f"  xla compiled peak "
                f"{_fmt_bytes(me['compiled_peak_bytes'])} "
                f"(static/compiled {me.get('static_over_compiled')}x)")
    bi = report.get("bench_incidents")
    if bi:
        lines.append(f"bench incidents: {len(bi)}")
        for e in bi[-3:]:
            lines.append(f"  {e.get('name')}: mode={e.get('mode')} "
                         f"error={e.get('probe_error')} "
                         f"stale={e.get('stale')}")
    return "\n".join(lines)


# -- bench freshness guard (`tadnn report --check`) -------------------------

# how much a headline value may drop vs BENCH_LAST_GOOD before the
# check fails (the >10% regression gate)
REGRESSION_TOLERANCE = 0.10


def _load_bench_record(path: str) -> dict | None:
    """One bench record from either bench.py stdout JSON or a bench
    round artifact (which wraps it under ``parsed``)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        data = data["parsed"]
    return data if isinstance(data, dict) else None


def check_bench(target: str, *, bench_path: str | None = None,
                last_good_path: str | None = None) -> tuple[int, list[str]]:
    """The freshness guard behind ``tadnn report --check``.

    Exit-nonzero conditions (each with a message):

    - no bench record found (missing trajectory = the r03-r05 dark run);
    - the latest record is stale-marked (``status:
      "backend_unreachable"``, ``stale: true``, or an ``unmeasurable``
      metric) — the round measured nothing;
    - the headline value regressed more than
    ``REGRESSION_TOLERANCE`` vs the committed BENCH_LAST_GOOD entry
      for the same metric.

    ``target`` is a directory holding ``BENCH_r*.json`` +
    ``BENCH_LAST_GOOD.json`` (the repo root in CI); explicit paths
    override discovery.  Returns ``(exit_code, messages)``.

    The serving trajectory (``SERVE_BENCH_r*.json`` +
    ``SERVE_LAST_GOOD.json`` from bench_serve.py) is checked under the
    SAME rules whenever either artifact exists in ``target`` — once a
    serving round has been committed it can never silently go stale —
    and skipped entirely before that (a training-only checkout is not
    failed for a trajectory it never started).  Explicit ``bench_path``
    / ``last_good_path`` bypass the serve check (single-family mode).
    """
    import glob as _glob

    d = target if os.path.isdir(target) else os.path.dirname(
        os.path.abspath(target)) or "."
    if bench_path is None and last_good_path is None:
        code, msgs = _check_bench_family(
            d, "BENCH", bench_path=None, last_good_path=None)
        armed = (_glob.glob(os.path.join(d, "SERVE_BENCH_r*.json"))
                 or os.path.isfile(
                     os.path.join(d, "SERVE_LAST_GOOD.json")))
        if armed:
            scode, smsgs = _check_bench_family(
                d, "SERVE_BENCH", bench_path=None, last_good_path=None)
            code = max(code, scode)
            msgs = msgs + smsgs
        return code, msgs
    return _check_bench_family(d, "BENCH", bench_path=bench_path,
                               last_good_path=last_good_path)


def _check_bench_family(d: str, prefix: str, *,
                        bench_path: str | None,
                        last_good_path: str | None
                        ) -> tuple[int, list[str]]:
    """One trajectory's freshness check (``{prefix}_r*.json`` vs the
    family's LAST_GOOD)."""
    import glob as _glob

    lg_name = ("BENCH_LAST_GOOD.json" if prefix == "BENCH"
               else prefix.replace("_BENCH", "") + "_LAST_GOOD.json")
    msgs: list[str] = []
    if bench_path is None:
        rounds = sorted(_glob.glob(os.path.join(d, f"{prefix}_r*.json")))
        bench_path = rounds[-1] if rounds else None
    if bench_path is None or not os.path.isfile(bench_path):
        return 1, [f"no bench record ({prefix}_r*.json) found — the "
                   + ("serving" if prefix != "BENCH" else "bench")
                   + " trajectory is dark"]
    rec = _load_bench_record(bench_path)
    if rec is None:
        return 1, [f"{bench_path}: unreadable bench record"]
    name = os.path.basename(bench_path)
    metric = str(rec.get("metric", ""))
    if rec.get("status") == "backend_unreachable" or rec.get("stale"):
        msgs.append(
            f"{name}: stale ({rec.get('status') or 'stale-marked'}"
            + (f", stale_of {rec['stale_of']}" if rec.get("stale_of")
               else "")
            + ") — this round measured nothing")
    elif "unmeasurable" in metric:
        msgs.append(f"{name}: unmeasurable ({metric})")
    else:
        lg_path = last_good_path or os.path.join(d, lg_name)
        try:
            with open(lg_path) as f:
                last_good = json.load(f)
        except (OSError, ValueError):
            last_good = {}
        for mode, entry in last_good.items():
            res = (entry or {}).get("result") or {}
            if res.get("metric") != metric or not res.get("value"):
                continue
            value = rec.get("value") or 0.0
            floor = (1.0 - REGRESSION_TOLERANCE) * res["value"]
            if value < floor:
                msgs.append(
                    f"{name}: {metric} = {value:g} regressed "
                    f"{1.0 - value / res['value']:.1%} vs last good "
                    f"{res['value']:g} ({mode}, "
                    f"{entry.get('measured_utc', '?')})")
            break
    if not msgs:
        msgs.append(f"{name}: fresh ({metric or 'no metric'}, "
                    f"value {rec.get('value')})")
        return 0, msgs
    return 1, msgs


# -- simulator crosscheck (`tadnn report --check-simulate`) ------------------

# predicted/measured ratio band the replay must land in.  2x is loose on
# purpose: the replay models scheduling exactly but step timings only to
# a roofline, so it catches "the simulator lives in fantasy land", not
# single-digit-percent drift (that is the --check regression gate's job).
CROSSCHECK_BAND = 2.0


def check_simulate(target: str) -> tuple[int, list[str]]:
    """Falsify the what-if serve model against the newest real record.

    Behind ``tadnn report --check-simulate``: finds the latest
    ``SERVE_BENCH_r*.json`` in ``target``, replays its exact recorded
    config (streams / slots / block size / chunking / measured per-step
    timings) through the discrete-event scheduler replay, and compares
    predicted vs measured throughput and occupancy.  Journals the
    ratios as a ``simulate.crosscheck`` event (within-2x band, same
    style as ``trace.collective``).  Exit nonzero when no record exists
    (nothing to falsify against) or a ratio leaves the band — either
    way the simulator's predictions should not be trusted unaudited.
    """
    import glob as _glob

    d = target if os.path.isdir(target) else os.path.dirname(
        os.path.abspath(target)) or "."
    rounds = sorted(_glob.glob(os.path.join(d, "SERVE_BENCH_r*.json")))
    if not rounds:
        return 1, ["no serve bench record (SERVE_BENCH_r*.json) found — "
                   "nothing to crosscheck the simulator against"]
    path = rounds[-1]
    rec = _load_bench_record(path)
    if rec is None or not isinstance(rec.get("extra"), dict):
        return 1, [f"{os.path.basename(path)}: unreadable serve bench "
                   "record (no extra config to replay)"]
    name = os.path.basename(path)
    extra = rec["extra"]
    # lazy: the replay pulls in the tune package (and with it torch);
    # everything else in this module stays importable without it.
    from ..tune.simulate import replay_bench_record

    from . import journal

    try:
        sim = replay_bench_record(extra)
    except (KeyError, TypeError, ValueError) as e:
        return 1, [f"{name}: replay failed on recorded config: {e}"]
    msgs: list[str] = []
    within = True
    measured_tok = rec.get("value") or 0.0
    measured_occ = extra.get("mean_occupancy")
    ratios: dict[str, float | None] = {"tok/s": None, "occupancy": None}
    for label, predicted, measured in (
            ("tok/s", sim.get("tokens_per_s"), measured_tok),
            ("occupancy", sim.get("mean_occupancy"), measured_occ)):
        if not measured or predicted is None:
            msgs.append(f"{name}: {label} not comparable "
                        f"(measured {measured!r})")
            continue
        ratio = predicted / measured
        ratios[label] = round(ratio, 4)
        ok = (1.0 / CROSSCHECK_BAND) <= ratio <= CROSSCHECK_BAND
        within = within and ok
        msgs.append(
            f"{name}: {label} predicted {predicted:g} vs measured "
            f"{measured:g}, ratio {ratio:.2f} "
            + ("within 2x" if ok else "OUTSIDE 2x BAND"))
    pred_pre = sim.get("preemptions", 0)
    meas_pre = extra.get("preemptions")
    if meas_pre is not None:
        # count, not a rate: "within 2x" here means the replay predicts
        # the same preemption regime (quiet pool vs thrashing pool).
        ok = pred_pre <= 2 * max(meas_pre, 1) and \
            meas_pre <= 2 * max(pred_pre, 1)
        within = within and ok
        msgs.append(
            f"{name}: preemptions predicted {pred_pre} vs measured "
            f"{meas_pre} " + ("within 2x" if ok else "OUTSIDE 2x BAND"))
    journal.event(
        "simulate.crosscheck",
        record=name,
        predicted_tok_s=sim.get("tokens_per_s"),
        measured_tok_s=measured_tok or None,
        tok_s_ratio=ratios["tok/s"],
        predicted_occupancy=sim.get("mean_occupancy"),
        measured_occupancy=measured_occ,
        occupancy_ratio=ratios["occupancy"],
        predicted_preemptions=pred_pre,
        measured_preemptions=meas_pre,
        within_2x=within,
    )
    return (0 if within else 1), msgs
