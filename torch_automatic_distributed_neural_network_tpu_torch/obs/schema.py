"""Journal event schema registry: the telemetry contract.

The PyTorch package's own copy of the JAX package's ``obs/schema.py``
(pure stdlib there too; the port imports nothing of that package), with
the registry unchanged, so a journal either package writes validates
against the same table and ``tadnn report`` reads both.

Every JSONL journal event the package emits is declared here: its
required and optional payload fields with types, its version, and any
deprecated aliases it was ever emitted under.  Consumers:

- **runtime enforcement**: ``Journal(validate=True)`` (or
  ``TADNN_JOURNAL_VALIDATE=1``) checks each record at emit time and
  raises :class:`JournalContractError` on violation, at the site that
  emitted the drifting record;
- **journal audit**: :func:`validate_record` over a written journal,
  record by record, with the same rules.

Type specs are compact strings: ``str int float bool number list
dict any``, with a ``?`` suffix for nullable (``float?`` accepts a
float, an int, or None).  ``float`` always accepts ints (JSON does not
preserve the distinction); ``number`` is the explicit union.

Schemas are *closed* by default: a field not declared here is a
contract violation at the site that emits it (JL004).  A handful of
kinds whose payload is inherently dynamic (tuner candidate breakdowns,
trace attributions, memory-estimate reports) are declared ``open`` —
required fields are still enforced, extras tolerated.

Deprecation: renames keep the old name in :data:`ALIASES` (old →
canonical).  Consumers resolve acceptance through :func:`names_for`
instead of hardcoding both spellings; producers emitting under an alias
get JL007.

Pure stdlib.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

__all__ = [
    "ALIASES",
    "BASE_FIELDS",
    "EventSchema",
    "JournalContractError",
    "REGISTRY",
    "canonical",
    "get",
    "names_for",
    "registry_markdown",
    "validate_record",
]


class JournalContractError(ValueError):
    """A record violated its event schema under runtime validation."""


@dataclasses.dataclass(frozen=True)
class EventSchema:
    """The declared contract for one journal event kind.

    ``kind`` is the record kind the journal stamps: ``"event"``,
    ``"span"``, or ``"both"`` for names emitted either way.  ``open``
    kinds tolerate undeclared extra fields (dynamic payloads); closed
    kinds treat them as contract violations.
    """

    name: str
    desc: str
    required: Mapping[str, str] = dataclasses.field(default_factory=dict)
    optional: Mapping[str, str] = dataclasses.field(default_factory=dict)
    kind: str = "event"  # 'event' | 'span' | 'both'
    version: int = 1
    open: bool = False

    def fields(self) -> dict[str, str]:
        return {**self.required, **self.optional}


# Fields the Journal itself stamps on every record — never declared
# per-event, always legal.  ``host`` is the tag obs/aggregate.py adds
# when merging per-host journals; ``dur_s``/``error`` are the span
# machinery's completion fields.
BASE_FIELDS: dict[str, str] = {
    "kind": "str",
    "name": "str",
    "t": "float",
    "wall": "float",
    "depth": "int",
    "dur_s": "float",
    "error": "any",
    "host": "any",
}

# Deprecated name -> canonical name.  An emission under the old name is
# JL007; consumers accept both via names_for() so committed journals
# from before the rename still render.
ALIASES: dict[str, str] = {
    # the per-request completion event grew the full span timeline and
    # was renamed to say so
    "serve.request": "serve.request_done",
}


def _s(name: str, desc: str, req: dict | None = None,
       opt: dict | None = None, **kw: Any) -> EventSchema:
    return EventSchema(name=name, desc=desc, required=req or {},
                       optional=opt or {}, **kw)


REGISTRY: dict[str, EventSchema] = {s.name: s for s in (
    # -- journal internals --------------------------------------------------
    _s("journal.start", "first record of every journal; carries the "
       "creator's meta tags",
       opt={"tool": "str", "role": "str", "host": "any", "world": "int",
            "pid": "int", "source": "str"}, open=True),
    _s("journal.rotated", "size-capped rotation shed records to <path>.1",
       req={"rotations": "int", "max_bytes": "int"}),

    # -- planner / training core --------------------------------------------
    _s("plan", "sharding plan chosen for a run",
       req={"strategy": "str", "mesh": "any", "remat": "any",
            "precision": "any", "grad_accum": "int", "zero1": "bool"}),
    _s("plan.zero1", "ZeRO-1 optimizer-state sharding comm profile",
       req={"data_degree": "int", "predicted_allgather_bytes": "number",
            "predicted_reduce_scatter_bytes": "number",
            "compiled_bytes": "number?"}),
    _s("compile", "first XLA compile of a jitted fn (event from the "
       "jit cache; span from AOT paths)",
       req={"fn": "str"},
       opt={"dur_s": "float", "signature": "str"}, kind="both"),
    _s("recompile", "signature change re-traced an already-compiled fn",
       req={"fn": "str"}, opt={"dur_s": "float", "signature": "str"}),
    _s("run_start", "Trainer.run began",
       req={"steps": "int?", "start_step": "int", "resumed": "bool",
            "strategy": "any", "mesh": "any"}),
    _s("run_end", "Trainer.run finished",
       req={"stop_step": "int?", "n_compiles": "int",
            "recompiles": "int", "export": "any"}),
    _s("goodput", "wall-clock breakdown by bucket at run end",
       req={"total_wall_s": "float", "seconds": "dict",
            "fractions": "dict", "goodput": "float"}),
    _s("data_exhausted", "loader ran dry mid-run; state saved and run "
       "returned cleanly",
       req={"step": "int", "saved": "bool"}),

    # -- checkpoint / resilience / elastic ----------------------------------
    _s("ckpt.save", "checkpoint save dispatch",
       req={"step": "int"},
       opt={"saved": "any", "sharded": "bool", "queued": "bool",
            "manifest_queued": "bool", "n_shards": "int"}, kind="span"),
    _s("ckpt.restore", "checkpoint restore attempt",
       opt={"step": "any", "sharded": "bool", "verified": "any"},
       kind="span"),
    _s("ckpt.wait", "barrier for in-flight async saves",
       opt={"sharded": "bool"}, kind="span"),
    _s("ckpt.async_save", "async sharded-save completion metrics",
       opt={"step": "int", "bytes": "int", "off_thread_s": "float",
            "dispatch_to_durable_s": "float", "queue_depth": "int",
            "host": "any"}),
    _s("ckpt.corrupt", "integrity-manifest mismatch quarantined a step",
       req={"step": "any", "reason": "str"},
       opt={"quarantined": "str?"}),
    _s("ckpt.restore_config_failed", "config snapshot unreadable during "
       "restore-chain walk",
       req={"error": "str"}, opt={"step": "any"}),
    _s("elastic.restart", "run_with_recovery restart attempt",
       req={"attempt": "int", "delay_s": "float", "error": "str",
            "gave_up": "bool", "max_restarts": "int",
            "window_failures": "int"}),
    _s("preempt.signal", "preemption signal received",
       req={"signum": "int"}),
    _s("preempt.drain", "preemption drain: final save before exit",
       req={"step": "int", "saved": "any"}),
    _s("watchdog.stall", "no step progress past the watchdog timeout",
       req={"age_s": "float", "timeout_s": "float"}),
    _s("resilience.stall_escalation", "watchdog escalation raised "
       "StallError into the training thread",
       req={"age_s": "float", "timeout_s": "float"}),
    _s("resilience.rollback", "loss anomaly rolled state back to the "
       "last verified checkpoint",
       req={"reason": "str", "rollback": "bool", "to_step": "int",
            "batch_offset": "int", "skipped_batches": "int"},
       opt={"at_step": "int?", "loss": "float?"}),
    _s("resilience.chaos", "seeded chaos fault injected",
       req={"kind": "str", "step": "int"}),

    # -- elastic multihost orchestrator -------------------------------------
    _s("launch.round", "orchestrator spawned a worker cohort",
       req={"round": "int", "world": "int", "logical": "bool",
            "pids": "list"}, opt={"coordinator": "any"}),
    _s("launch.step", "per-host step heartbeat from a worker",
       req={"host": "int", "step": "int", "loss": "float"}),
    _s("launch.chaos", "orchestrator-injected fault",
       req={"kind": "str"},
       opt={"host": "int", "step": "int", "self_inflicted": "bool",
            "torn_step": "any"}),
    _s("launch.restart", "cohort broke; restart decision",
       req={"reason": "str", "restarts": "int", "max_restarts": "int",
            "round": "int", "world": "int", "gave_up": "bool"},
       opt={"host": "any", "step": "any"}),
    _s("launch.replan", "elastic world shrink re-plan",
       req={"world_from": "int", "world_to": "int", "reason": "str"},
       opt={"strategy": "any"}),
    _s("launch.done", "orchestrated run completed",
       req={"rounds": "int", "restarts": "int", "world": "int"},
       opt={"final_step": "any", "final_loss": "any"}),

    # -- observability / trace / comms --------------------------------------
    _s("trace.step", "per-step profiler attribution (dynamic payload)",
       req={"trace": "str"}, open=True),
    _s("trace.error", "profiler capture failed; step ran untraced",
       req={"error": "str", "step": "int"}),
    _s("trace.collective", "measured-vs-modeled collective bytes "
       "crosscheck (dynamic payload)", open=True),
    _s("comms.estimate", "analytic per-step collective-bytes model",
       req={"strategy": "str", "mesh": "any", "total_wire_bytes": "number",
            "per_device": "any", "model_dependent": "any"}),
    _s("comms.crosscheck", "modeled vs XLA bytes-accessed (dynamic "
       "payload)", open=True),

    # -- export / AOT cache --------------------------------------------------
    _s("export.miss", "executable cache lookup missed",
       req={"kind": "str", "key": "str"}),
    _s("export.hit", "executable deserialized from the cache",
       req={"kind": "str", "key": "str", "deserialize_s": "float",
            "payload_bytes": "int"}),
    _s("export.stale", "cached executable rejected by env fingerprint",
       req={"kind": "str", "key": "str", "reason": "str"}),
    _s("export.store", "freshly-compiled executable serialized",
       req={"kind": "str", "key": "str", "compile_s": "float",
            "payload_bytes": "int", "file": "str"}),
    _s("export.error", "cache path failed; fell back to plain compile",
       req={"kind": "str", "key": "str?", "error": "str"}),
    _s("export.fallback", "AOT executable rejected its args at run "
       "time; re-jitted loudly",
       req={"fn": "str", "error": "str"}),
    _s("export.prewarm", "background prewarm subprocess spawned",
       req={"world": "int", "pid": "int"}),
    _s("export.prewarm_done", "prewarm subprocess finished a trace",
       req={"world": "int", "key": "str", "source": "str"}),
    _s("export.compact", "index compaction / orphan payload sweep",
       req={"path": "str"}, open=True),
    _s("export.gc", "last-hit-age garbage collection",
       req={"path": "str", "scanned": "int", "dropped": "int",
            "kept": "int", "payload_bytes_freed": "int",
            "max_age_s": "float"}),
    _s("cost_analysis.cached", "compiled-cost memo hit",
       req={"key": "str", "tier": "str"}),
    _s("cost_analysis.error", "compiled-cost analysis failed (never "
       "cached)", req={"error": "str"}),

    # -- autotuner ----------------------------------------------------------
    _s("tune.cache_hit", "tuner decision served from the cache",
       req={"key": "str"},
       opt={"strategy": "str", "mesh": "any", "grad_accum": "int",
            "step_time_ms": "float?", "zero1": "bool"}),
    _s("tune.cache_miss", "no cached tuner decision for this key",
       req={"key": "str"}),
    _s("tune.candidate", "one ranked candidate (dynamic breakdown)",
       req={"rank": "int"}, open=True),
    _s("tune.decision", "tuner chose a strategy (dynamic breakdown)",
       req={"key": "str", "source": "str"}, open=True),
    _s("tune.fallback", "tuner fell back to the heuristic chooser",
       req={"key": "str?", "reason": "str"},
       opt={"strategy": "str", "mesh": "any"}),
    _s("tune.profile_skipped", "activation liveness profile failed; "
       "heuristic pruning used",
       req={"error": "str"}),
    _s("tune.trial", "compile-and-time measurement of one candidate "
       "(dynamic payload)", kind="span", open=True),
    _s("tune.trial.result", "measured step time for one candidate "
       "(dynamic payload)", open=True),

    # -- capacity planner ---------------------------------------------------
    _s("simulate.cache_hit", "memoized sweep served from the tune cache",
       req={"key": "str", "n_candidates": "int"}),
    _s("simulate.cache_miss", "sweep not in the tune cache",
       req={"key": "str"}),
    _s("simulate.candidate", "one ranked fleet candidate (dynamic "
       "payload)", req={"rank": "int"}, open=True),
    _s("simulate.decision", "SLO-first ranked winner (dynamic payload)",
       req={"key": "str"}, open=True),
    _s("simulate.sweep", "sweep summary",
       req={"key": "str", "n_candidates": "int", "n_replays": "int",
            "n_slo_ok": "int", "n_topologies": "int"}),
    _s("simulate.replay", "discrete-event serve replay result (dynamic "
       "payload)", req={"source": "str"}, open=True),
    _s("simulate.crosscheck", "newest committed serve bench replayed; "
       "prediction vs measurement",
       req={"record": "str", "predicted_tok_s": "float?",
            "measured_tok_s": "float?", "tok_s_ratio": "float?",
            "within_2x": "bool?"},
       opt={"predicted_occupancy": "float?",
            "measured_occupancy": "float?", "occupancy_ratio": "float?",
            "predicted_preemptions": "int?",
            "measured_preemptions": "int?"}),
    _s("simulate.drift", "live throughput outside the replay's band",
       req={"predicted_tok_s": "float?", "measured_tok_s": "float?",
            "ratio": "float", "band": "float"}),

    # -- static analysis ----------------------------------------------------
    _s("lint.finding", "one analyzer diagnosis",
       req={"phase": "str", "code": "str", "severity": "str",
            "layer": "str", "where": "str", "msg": "str"}),
    _s("lint.summary", "findings rollup for one check/preflight pass",
       req={"phase": "str", "errors": "int", "warnings": "int",
            "by_code": "dict"}),
    _s("lint.skipped", "an analyzer crashed; its layer was skipped",
       req={"phase": "str", "layer": "str", "error": "str"}),
    _s("lint.mem_estimate", "static peak-HBM breakdown (dynamic "
       "payload)", req={"phase": "str"}, open=True),
    _s("lint.serve_estimate", "static serving capacity estimate "
       "(dynamic payload)", open=True),
    _s("lint.protocol", "model-checker exploration stats for one model",
       req={"model": "str", "scope": "int", "states": "int",
            "transitions": "int", "depth": "int", "frontier_peak": "int",
            "wall_s": "float", "complete": "bool", "violations": "int"}),
    _s("lint.journal", "journal-contract lint coverage summary",
       req={"kinds_emitted": "int", "kinds_known": "int", "sites": "int",
            "dynamic_sites": "int", "coverage": "float",
            "findings": "int"}),

    # -- serving engine -----------------------------------------------------
    _s("serve.engine", "engine construction: the serving configuration",
       req={"n_slots": "int", "max_len": "int", "block_size": "int",
            "quant_kv": "bool", "attention_impl": "str",
            "prefill_chunk": "int?", "speculative": "int",
            "disaggregate": "bool", "tp": "int", "prefix_cache": "bool",
            "n_adapters": "int", "adapter_rank": "int?",
            "quant_adapters": "bool"}),
    _s("serve.step", "one serving iteration (engine or gateway "
       "SimReplica)",
       req={"n_active": "int", "n_queued": "int", "new_tokens": "int",
            "occupancy": "float", "free_blocks": "int"},
       opt={"step": "int", "n_prefilling": "int", "prefill_s": "float",
            "decode_s": "float", "mode": "str", "overlap_s": "float",
            "adapters_resident": "int", "adapters_pinned": "int",
            "prefix_blocks": "int", "prefix_hit_tokens": "int",
            "replica": "str", "prefill_chunks": "int"}),
    _s("serve.request_done", "per-request completion span with the "
       "full phase-attributed timeline", version=2,
       req={"rid": "int", "n_prompt": "int", "n_new": "int",
            "queue_s": "float?", "total_s": "float?",
            "tokens_per_s": "float?", "preempted": "int",
            "ttft_s": "float?", "itl_s": "list"},
       opt={"prefill_s": "float?", "decode_s": "float?",
            "itl_mean_s": "float?", "kv_ship_s": "float?",
            "cached_tokens": "int?", "prefill_chunks": "int?",
            "prefill_compute_s": "float?", "lost_s": "float?",
            "replica": "str"}),
    _s("serve.preempt", "optimistic-growth preemption recycled a slot",
       req={"rid": "int", "n_regenerate": "int"}),
    _s("serve.prefill_chunk", "one chunked-prefill advance",
       req={"rid": "int", "slot": "int", "pos": "int", "n_tokens": "int",
            "seconds": "float", "done": "bool"}),
    _s("serve.kv_ship", "disaggregated prefill shipped KV blocks into "
       "a decode slot",
       req={"rid": "int", "slot": "int", "n_blocks": "int",
            "bytes": "int"}),
    _s("serve.speculate", "speculative draft-and-verify round",
       req={"step": "int", "k": "int", "n_active": "int",
            "drafted": "int", "accepted": "int",
            "accept_rate": "float?"}),
    _s("serve.adapter", "adapter pool bind outcome (hit/fault/stall)",
       req={"kind": "str", "rid": "int", "adapter": "str?"},
       opt={"idx": "int", "evicted": "any"}),
    _s("serve.prefix", "prefix-cache lifecycle (match/publish/cow/"
       "expire)",
       req={"kind": "str"},
       opt={"rid": "int", "hit": "bool", "cached_tokens": "int",
            "cached_blocks": "int", "n_blocks": "int", "block": "int",
            "fork": "int", "index_blocks": "int", "replica": "str"}),

    # -- gateway / fleet ----------------------------------------------------
    _s("gateway.request", "ingress accepted and routed a request",
       req={"rid": "int", "tenant": "str", "priority": "int",
            "replica": "str", "n_prompt": "int"}),
    _s("gateway.reject", "ingress rejected (rate limit / backpressure "
       "/ shed)",
       req={"kind": "str"},
       opt={"tenant": "str", "priority": "int", "pending": "int",
            "retry_after": "float?", "level": "int"}),
    _s("gateway.failover", "dead-replica in-flight failover "
       "(redispatch or parked)",
       req={"kind": "str"},
       opt={"rid": "int", "rids": "list", "replica": "str",
            "reason": "str", "n_requeued": "int"}),
    _s("gateway.hedge", "tail hedge dispatched / resolved",
       req={"kind": "str", "rid": "int"},
       opt={"primary": "str", "replica": "str", "winner": "str"}),
    _s("gateway.breaker", "circuit breaker state transition",
       req={"replica": "str", "from": "str", "to": "str"}),
    _s("gateway.degrade", "degraded-mode ladder stepped up",
       req={"level": "int", "prev": "int", "reason": "str",
            "speculation": "bool", "admission_factor": "float",
            "shed_threshold": "int?", "shed_classes": "list"}),
    _s("gateway.restore", "degraded-mode ladder stepped down",
       req={"level": "int", "prev": "int", "reason": "str",
            "speculation": "bool", "admission_factor": "float",
            "shed_threshold": "int?", "shed_classes": "list"}),
    _s("gateway.scale", "autoscaler resized the fleet",
       req={"kind": "str", "reason": "str"},
       opt={"n_replicas": "int", "replica": "str", "prewarmed": "bool",
            "requeued": "int"}),
    _s("gateway.replan", "SLO breach triggered a capacity replan",
       req={"reason": "str", "source": "str", "current": "int",
            "chosen": "int", "rate_per_s": "number",
            "prompt_mean": "number", "decode_mean": "number",
            "candidates": "list"},
       opt={"window": "any"}),
    _s("chaos.fault", "fleet chaos harness injected a fault",
       req={"kind": "str", "replica": "str", "t_fault": "float"},
       opt={"factor": "float?"}),

    # -- SLO monitor --------------------------------------------------------
    _s("slo.breach", "windowed SLO breach opened (hysteresis passed)",
       req={"window_start_s": "float?", "window_end_s": "float?",
            "violating_windows": "int", "violations": "list"}),
    _s("slo.recover", "windowed SLO breach closed",
       req={"window_start_s": "float?", "window_end_s": "float?",
            "ok_windows": "int"}),

    # -- bench probes -------------------------------------------------------
    _s("bench.probe", "bench backend probe result",
       req={"mode": "str", "ok": "bool", "probe_error": "str?"},
       opt={"argv": "list"}),
    _s("bench.stale", "backend unreachable; last committed result is "
       "stale, NOT re-emitted",
       req={"mode": "str", "stale": "bool", "probe_error": "str?"},
       opt={"measured_utc": "str", "stale_of": "any", "metric": "str?"}),
    _s("bench.unmeasurable", "backend unreachable and no committed "
       "result exists",
       req={"mode": "str", "ok": "bool", "probe_error": "str?"}),
)}


# -- lookups ----------------------------------------------------------------

def canonical(name: str) -> str:
    """Resolve a (possibly deprecated) event name to its canonical one."""
    return ALIASES.get(name, name)


def get(name: str) -> EventSchema | None:
    """Schema for ``name``, resolving deprecation aliases; None when
    the kind is unknown to the registry."""
    return REGISTRY.get(canonical(name))


def names_for(name: str) -> tuple[str, ...]:
    """Every name this event was ever emitted under: the canonical name
    first, then its deprecated aliases — the consumer-side acceptance
    set (``e.get("name") in names_for("serve.request_done")``)."""
    name = canonical(name)
    olds = tuple(sorted(old for old, new in ALIASES.items()
                        if new == name))
    return (name, *olds)


# -- type checking ----------------------------------------------------------

def check_value(value: Any, spec: str) -> bool:
    """Does ``value`` satisfy the compact type spec?"""
    if spec.endswith("?"):
        if value is None:
            return True
        spec = spec[:-1]
    if spec == "any":
        return True
    if value is None:
        return False
    if spec == "str":
        return isinstance(value, str)
    if spec == "bool":
        return isinstance(value, bool)
    if spec == "int":
        return isinstance(value, int) and not isinstance(value, bool)
    if spec in ("float", "number"):
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    if spec == "list":
        return isinstance(value, (list, tuple))
    if spec == "dict":
        return isinstance(value, dict)
    raise ValueError(f"unknown type spec {spec!r}")


def validate_record(rec: Mapping[str, Any]) -> list[tuple[str, str]]:
    """Check one journal record against the registry.

    Returns ``(rule_code, message)`` problems — empty when the record
    honors its contract.  Rule codes mirror the static lint: JL001
    unknown kind, JL002 missing required field, JL003 type mismatch,
    JL004 undeclared field, JL007 deprecated alias.
    """
    problems: list[tuple[str, str]] = []
    name = rec.get("name")
    if not isinstance(name, str):
        return [("JL001", f"record has no event name: {dict(rec)!r}")]
    if name in ALIASES:
        problems.append(
            ("JL007", f"emitted under deprecated alias {name!r} "
             f"(canonical: {ALIASES[name]!r})"))
    schema = get(name)
    if schema is None:
        return problems + [
            ("JL001", f"unknown event kind {name!r} (not in the "
             "schema registry; see `tadnn check --journal --rules`)")]
    # Declared fields are authoritative over base-field stripping: a
    # payload field named ``kind`` (serve.prefix, gateway.reject,
    # export.*) lands last in the record dict and overwrites the
    # journal's own event/span discriminator — that collision is the
    # established journal format, so the schema checks it as payload.
    declared = schema.fields()
    payload = {k: v for k, v in rec.items()
               if k in declared or k not in BASE_FIELDS}
    for field, spec in schema.required.items():
        if field not in payload:
            problems.append(
                ("JL002", f"{name}: required field {field!r} missing"))
        elif not check_value(payload[field], spec):
            problems.append(
                ("JL003", f"{name}: field {field!r} = "
                 f"{payload[field]!r} does not satisfy type {spec!r}"))
    for field, value in payload.items():
        if field in schema.required:
            continue
        spec = schema.optional.get(field)
        if spec is None:
            if not schema.open:
                problems.append(
                    ("JL004", f"{name}: field {field!r} is not declared "
                     "in the schema (undeclared payload drift)"))
        elif not check_value(value, spec):
            problems.append(
                ("JL003", f"{name}: field {field!r} = {value!r} does "
                 f"not satisfy type {spec!r}"))
    return problems


# -- docs -------------------------------------------------------------------

def registry_markdown(kinds: Iterable[str] | None = None) -> str:
    """The registry as a markdown table — `tadnn check --journal
    --rules` prints this; the README's generated event reference."""
    rows = ["| event | v | required | optional | notes |",
            "|---|---|---|---|---|"]

    def fmt(fields: Mapping[str, str]) -> str:
        return ", ".join(f"`{f}:{t}`" for f, t in fields.items()) or "—"

    names = sorted(kinds) if kinds is not None else sorted(REGISTRY)
    for name in names:
        s = REGISTRY[name]
        notes = []
        if s.open:
            notes.append("open payload")
        if s.kind != "event":
            notes.append(s.kind)
        olds = [old for old, new in ALIASES.items() if new == name]
        if olds:
            notes.append("alias: " + ", ".join(f"`{o}`" for o in olds))
        rows.append(
            f"| `{name}` | {s.version} | {fmt(s.required)} "
            f"| {fmt(s.optional)} | {'; '.join(notes) or '—'} |")
    return "\n".join(rows)
