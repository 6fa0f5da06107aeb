"""Static analysis — the JAX package's ``analysis/`` (``tadnn check`` and
the Trainer's preflight), with the same rule table and :class:`Finding`
vocabulary:

- **source lint** (:mod:`.source_lint`): a rule-based AST engine over
  Python source — duplicate top-level defs, traced-value branching in
  jitted helpers, host clock/RNG in jitted step functions, bare
  excepts, mutable defaults (by default over this package);
- **async lint** (:mod:`.async_lint`): AST rules over the asyncio
  gateway layer — blocking calls in async defs, dropped coroutines,
  wall-clock reads in clock-injected classes (by default over this
  package's ``inference/gateway/``);
- **model check** (:mod:`.model_check`): bounded explicit-state BFS
  over event interleavings of real serving state machines, with
  minimized replayable counterexamples; the protocol models over this
  package's allocator, scheduler, prefix cache and gateway
  (:mod:`.protocol`, rules PC001–PC007, ``tadnn check --protocol``);
- **journal lint** (:mod:`.journal_lint`): every journal emission and
  consumption site resolved statically and checked both ways against
  the :mod:`..obs.schema` event registry, plus a record-level auditor
  for written journals.

- **plan lint** (:mod:`.plan_lint`): pure checks on a ``ShardPlan`` ×
  mesh degrees — axis divisibility, duplicate/unknown axes, dead mesh
  axes, large replicated leaves;
- **graph lint** (:mod:`.graph_lint`): trace the train step on fake
  tensors to an fx graph (``make_fx``; nothing runs, nothing is
  allocated, the hand-written kernels are one ``tadnn`` node each) and
  walk it — inventory its collectives, cross-check them against the
  analytic comms model (``planner.expected_collective_bytes``), flag
  host syncs and captured scalars;
- **memory lint** (:mod:`.mem_lint`): liveness intervals over the same
  trace → a per-device peak prediction under the plan's sharding,
  checked against a ``ChipSpec`` budget (predicted OOM = error); the
  same walk at global shapes feeds the tuner's memory pruning;
- **dtype lint** (:mod:`.dtype_lint`): dtype propagation over the same
  trace — loss-path downcasts, f16 overflow-prone sums, Python scalars
  at collectives, mixed-dtype param trees;
- **serving trace** (:mod:`.serve_trace`): graph and dtype lint over the
  serving engine's traced decode and prefill steps.

Findings are typed (``error``/``warn``), journaled as ``lint.*``
events, runnable via ``tadnn check`` and automatically as a Trainer
preflight (``TrainerConfig.preflight=True``) before step 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

from ..obs import journal as obs_journal

ERROR = "error"
WARN = "warn"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer diagnosis.

    ``where`` is a param path (plan lint), an equation context (graph
    lint) or ``file:line`` (source lint); ``code`` indexes :data:`RULES`.
    """

    code: str
    severity: str  # ERROR | WARN
    layer: str  # 'plan' | 'graph' | 'source'
    where: str
    msg: str

    def format(self) -> str:
        return f"{self.code} {self.severity:<5} {self.where}: {self.msg}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    code: str
    layer: str
    severity: str
    title: str
    # Byte threshold for size-gated rules (PL005) — the table is the one
    # tunable default; CLI/API overrides shadow it per call.
    threshold: int | None = None


# The rule table rendered by ``tadnn check --rules`` and the README.
RULES: dict[str, RuleInfo] = {
    r.code: r
    for r in (
        RuleInfo("PL001", "plan", ERROR,
                 "param axis not divisible by its mesh-axis degrees"),
        RuleInfo("PL002", "plan", ERROR,
                 "same mesh axis used twice in one PartitionSpec"),
        RuleInfo("PL003", "plan", ERROR,
                 "PartitionSpec names a mesh axis the mesh does not have"),
        RuleInfo("PL004", "plan", WARN,
                 "dead mesh axis: degree > 1 but no spec ever uses it"),
        RuleInfo("PL005", "plan", WARN,
                 "large param leaf fully replicated under a sharding "
                 "strategy", threshold=64 * 2**20),
        RuleInfo("GL001", "graph", WARN,
                 "host side-effect (debug print / callback) inside the "
                 "jitted step"),
        RuleInfo("GL002", "graph", WARN,
                 "explicit collective over a mesh axis the plan's "
                 "analytic comms model did not predict"),
        RuleInfo("GL003", "graph", WARN,
                 "weak-typed Python scalar captured as a traced constant "
                 "(baked at trace time; recompile/staleness hazard)"),
        RuleInfo("GL004", "graph", ERROR,
                 "unhashable static argument (jit would reject the call)"),
        RuleInfo("SL001", "source", ERROR,
                 "duplicate top-level def/class (last-def-wins shadowing)"),
        RuleInfo("SL002", "source", ERROR,
                 "bare except: swallows KeyboardInterrupt/SystemExit"),
        RuleInfo("SL003", "source", ERROR,
                 "mutable default argument (shared across calls)"),
        RuleInfo("SL004", "source", ERROR,
                 "Python truthiness branch on a traced value in a jitted "
                 "helper"),
        RuleInfo("SL005", "source", ERROR,
                 "host clock / numpy RNG call inside a jitted step "
                 "function (baked at trace time)"),
        RuleInfo("SL006", "source", WARN,
                 "function call in a default argument (evaluated once at "
                 "def time)"),
        RuleInfo("ML001", "mem", ERROR,
                 "predicted per-device peak HBM exceeds the chip budget "
                 "(would OOM)"),
        RuleInfo("ML002", "mem", WARN,
                 "predicted peak within the headroom margin of the HBM "
                 "budget"),
        RuleInfo("ML003", "mem", WARN,
                 "activation-dominated peak with remat off (checkpointing "
                 "would cut it)"),
        RuleInfo("ML004", "mem", ERROR,
                 "serving KV pool cannot fit a single concurrent stream "
                 "under the HBM budget"),
        RuleInfo("ML005", "mem", WARN,
                 "serving KV pool fits fewer concurrent streams than "
                 "requested"),
        RuleInfo("ML006", "mem", ERROR,
                 "serving LoRA adapter pool leaves no HBM for a single "
                 "KV stream (capacity without it would fit >= 1)"),
        RuleInfo("DT001", "dtype", WARN,
                 "unintended f32→bf16/f16 downcast on the loss/optimizer "
                 "path"),
        RuleInfo("DT002", "dtype", WARN,
                 "f16 overflow-prone accumulation (sums saturate at "
                 "65504)"),
        RuleInfo("DT003", "dtype", WARN,
                 "weak-typed operand entering a collective (promotion "
                 "surprise)"),
        RuleInfo("DT004", "dtype", WARN,
                 "param tree mixes float dtypes across leaves"),
        RuleInfo("PC001", "protocol", ERROR,
                 "block allocator safety violated under some event "
                 "interleaving (leak / double-free / refcount-holder "
                 "mismatch)"),
        RuleInfo("PC002", "protocol", ERROR,
                 "scheduler protocol violated (pin multiset != running "
                 "slots, queue order, block conservation, over-"
                 "generation)"),
        RuleInfo("PC003", "protocol", ERROR,
                 "prefix-cache lease protocol violated (expired-lease "
                 "match, index/refcount divergence, leak on drop)"),
        RuleInfo("PC004", "protocol", ERROR,
                 "token ledger violated exactly-once (rewrote history, "
                 "duplicated or skipped a token)"),
        RuleInfo("PC005", "protocol", ERROR,
                 "circuit breaker took an illegal state transition"),
        RuleInfo("PC006", "protocol", ERROR,
                 "liveness violated: quiescent state with unresolved "
                 "rids / unfreed blocks, or a deadlocked interleaving"),
        RuleInfo("PC007", "protocol", WARN,
                 "model checker hit its state/depth cap before "
                 "exhausting the scope (result is a partial proof)"),
        RuleInfo("AS001", "async", ERROR,
                 "blocking call inside an async def (stalls the event "
                 "loop)"),
        RuleInfo("AS002", "async", ERROR,
                 "locally-defined coroutine called without await "
                 "(created and dropped)"),
        RuleInfo("AS003", "async", ERROR,
                 "wall-clock / asyncio.sleep inside a clock-injected "
                 "class (breaks virtual-time replay)"),
        RuleInfo("AS004", "async", WARN,
                 "attribute-mutating callable handed to a thread/"
                 "executor (event loop loses ownership)"),
        RuleInfo("JL001", "journal", ERROR,
                 "unknown journal event kind (emitted or consumed, not "
                 "in the obs/schema.py registry)"),
        RuleInfo("JL002", "journal", ERROR,
                 "required payload field missing at a journal emission "
                 "site"),
        RuleInfo("JL003", "journal", ERROR,
                 "literal payload value type-incompatible with the "
                 "event schema"),
        RuleInfo("JL004", "journal", ERROR,
                 "payload field emitted but never declared (closed-"
                 "schema drift)"),
        RuleInfo("JL005", "journal", WARN,
                 "declared optional field never emitted by any producer "
                 "(dead schema)"),
        RuleInfo("JL006", "journal", ERROR,
                 "consumer reads a payload field no producer declares"),
        RuleInfo("JL007", "journal", WARN,
                 "emission or hardcoded consumer acceptance under a "
                 "deprecated event-name alias"),
    )
}


class PreflightError(RuntimeError):
    """Raised by the Trainer preflight (``preflight_action='raise'``)
    when the analyzers report error-severity findings."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        errs = [f for f in self.findings if f.severity == ERROR]
        super().__init__(
            f"preflight found {len(errs)} error(s):\n"
            + "\n".join("  " + f.format() for f in errs)
        )


def summarize(findings: Iterable[Finding]) -> dict:
    """Counts by severity and code — the ``lint.summary`` payload."""
    findings = list(findings)
    by_code: dict[str, int] = {}
    for f in findings:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    return {
        "errors": sum(1 for f in findings if f.severity == ERROR),
        "warnings": sum(1 for f in findings if f.severity == WARN),
        "by_code": by_code,
    }


def journal_findings(findings: Sequence[Finding], *,
                     phase: str = "check") -> None:
    """Emit ``lint.finding`` events (one per finding) + ``lint.summary``
    on the process-default journal — `tadnn report` renders them."""
    for f in findings:
        obs_journal.event("lint.finding", phase=phase, **f.to_json())
    obs_journal.event("lint.summary", phase=phase, **summarize(findings))


def filter_ignored(findings: Iterable[Finding],
                   ignore: Iterable[str] = ()) -> list[Finding]:
    """Drop findings whose code is in ``ignore`` — the plan/graph/mem/
    dtype analog of source lint's ``# tadnn: lint-ok(CODE)`` comment
    (those layers have no source line to hang a comment on).  Unknown
    codes raise: a typo'd suppression that silently suppresses nothing
    is worse than an error."""
    codes = {str(c).strip().upper() for c in (ignore or ())
             if str(c).strip()}
    if not codes:
        return list(findings)
    unknown = sorted(codes - set(RULES))
    if unknown:
        raise ValueError(
            f"unknown lint code(s) in ignore: {', '.join(unknown)} "
            "(see `tadnn check --rules`)")
    return [f for f in findings if f.code not in codes]


def exit_code(findings: Sequence[Finding], *, strict: bool = False) -> int:
    """``tadnn check`` exit status: 1 on any error, with ``--strict``
    also on any warning."""
    if any(f.severity == ERROR for f in findings):
        return 1
    if strict and findings:
        return 1
    return 0


def _generator() -> "torch.Generator":
    import torch

    return torch.Generator().manual_seed(0)


def _compute_dtype(ad: Any):
    """The configured compute dtype: the precision's, or, where that is
    fp32, the model's activation dtype (``cfg.dtype``: the port's
    attention computes its products in fp32 and casts them to it)."""
    import torch

    prec = getattr(ad, "precision", None)
    dtype = getattr(prec, "compute_dtype", None)
    if dtype in (None, torch.float32):
        cfg = getattr(ad.model, "cfg", None)
        dtype = getattr(getattr(cfg, "core", cfg), "dtype", dtype)
    return dtype


def traced_step(ad: Any, sample_batch: Any):
    """``(gm, state)``: the plan's traced step (``graph_lint.trace_step``
    of ``AutoDistribute.traceable_step``) and its fake ``(params,
    opt_state, model_state, batch)`` at this rank's shapes.  Kept on
    ``ad`` for its plan and the batch's shapes and dtypes, so that
    ``preflight``, ``memory_check`` and a caller reading the graph share
    one trace."""
    import numpy as np

    from . import graph_lint

    key = (id(ad.plan), tuple(
        (k, tuple(np.shape(v)), str(getattr(v, "dtype", None)
                                    or np.asarray(v).dtype))
        for k, v in sorted(sample_batch.items())))
    cached = getattr(ad, "_step_trace", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    state = ad.abstract_state(sample_batch)
    closed = graph_lint.trace_step(ad.traceable_step(), *state, _generator())
    ad._step_trace = (key, (closed, state))
    return closed, state


def _estimate(ad: Any, closed: Any, sample_batch: Any):
    """The memory estimate of a traced step: persistent terms from the
    global abstract state under the plan's specs, the transient walk of
    the local trace."""
    from . import mem_lint

    params, opt_state, model_state, batch = ad.abstract_state(
        sample_batch, meshless=True)
    return mem_lint.estimate_step_memory(
        closed, ad.plan, params, opt_state=opt_state,
        model_state=model_state, batch=batch,
        grad_accum=getattr(ad, "_grad_accum", 1), local=True)


def preflight(ad: Any, sample_batch: Any, *, rng: Any = None,
              big_leaf_bytes: int | None = None,
              budget: int | str | None = None,
              headroom: float | None = None,
              ignore: Iterable[str] = ()) -> list[Finding]:
    """Plan + graph + memory + dtype lint for a built AutoDistribute —
    the Trainer's before-step-0 hook.

    Trace-only and off the hot path: the graph/mem/dtype layers trace
    the step (``AutoDistribute.traceable_step``) on fake tensors with
    ``make_fx``; nothing is allocated or executed.  ``budget`` (bytes,
    or '16GiB') defaults to the detected chip's memory — the memory
    layer errors (ML001) when the predicted peak exceeds it, which under
    ``preflight_action='raise'`` aborts before step 0 instead of OOMing
    at it.  ``ignore`` suppresses known-benign codes
    (:func:`filter_ignored`).  Findings are journaled as ``lint.*``
    events with ``phase='preflight'``, the breakdown as
    ``lint.mem_estimate``.  A plan the traced step does not model (a
    tensor, expert, pipe or seq axis) gets the plan lint alone and a
    ``lint.skipped`` for the traced layers.
    """
    from . import dtype_lint, graph_lint, mem_lint, plan_lint
    from .. import planner

    if ad.plan is None:
        raise ValueError("preflight needs a built plan — call "
                         "build_plan()/init() first")
    prec = getattr(ad, "precision", None)
    abstract = planner.abstract_params(ad.model, prec.param_dtype)
    kwargs = {}
    if big_leaf_bytes is not None:
        kwargs["big_leaf_bytes"] = big_leaf_bytes
    findings = plan_lint.lint_plan(ad.plan, abstract, **kwargs)
    try:
        closed, state = traced_step(ad, sample_batch)
    except ValueError as e:  # a layout the traced step does not model
        obs_journal.event("lint.skipped", phase="preflight", layer="graph",
                          error=f"{type(e).__name__}: {e}")
        closed = None
    if closed is not None:
        grad_accum = getattr(ad, "_grad_accum", 1)
        findings += graph_lint.lint_graph(
            closed, plan=ad.plan, abstract_params=abstract,
            grad_accum=grad_accum)
        findings += dtype_lint.lint_dtypes(
            closed, abstract_params=state[0],
            compute_dtype=_compute_dtype(ad))
        try:
            est = _estimate(ad, closed, sample_batch)
            budget_b = mem_lint.resolve_budget(budget)
            hr = (mem_lint.DEFAULT_HEADROOM if headroom is None
                  else float(headroom))
            findings += mem_lint.lint_memory(
                est, budget_bytes=budget_b, headroom=hr)
            obs_journal.event(
                "lint.mem_estimate", phase="preflight",
                budget_bytes=budget_b, **est.to_json())
        except Exception as e:  # the estimator must never block training
            obs_journal.event(
                "lint.skipped", phase="preflight", layer="mem",
                error=f"{type(e).__name__}: {e}")
    findings = filter_ignored(findings, ignore)
    journal_findings(findings, phase="preflight")
    return findings


def check_spec(spec: Mapping[str, Any]) -> list[Finding]:
    """Lint a user-supplied spec (the ``tadnn check --preflight FILE``
    contract: the file's ``tadnn_check()`` returns this dict).

    Recognized keys — all optional, any combination:

    - ``plan`` (:class:`planner.ShardPlan`) or the loose triple
      ``param_specs`` / ``batch_spec`` / ``degrees`` (+ ``strategy``)
      → plan lint;
    - ``abstract_params`` (mapping of shape/dtype leaves: meta or fake
      tensors) enables the shape-dependent plan rules and the graph
      cross-check;
    - ``fn`` + ``args`` (callable and its example arguments) → traced on
      fake tensors with ``make_fx``, graph- and dtype-linted;
    - ``static_args`` (name → value mapping) → hashability check;
    - ``budget`` (bytes or '16GiB'; needs ``plan`` + ``fn`` +
      ``abstract_params``) → liveness memory lint against that memory
      budget, with optional ``opt_state`` / ``batch`` abstract trees
      and ``headroom`` (``fn`` at global shapes, as the JAX package
      traces it);
    - ``big_leaf_bytes`` / ``grad_accum`` / ``compute_dtype`` tune the
      thresholds.
    """
    from . import dtype_lint, graph_lint, mem_lint, plan_lint

    findings: list[Finding] = []
    kwargs = {}
    if spec.get("big_leaf_bytes") is not None:
        kwargs["big_leaf_bytes"] = int(spec["big_leaf_bytes"])
    plan = spec.get("plan")
    if plan is not None:
        findings += plan_lint.lint_plan(
            plan, spec.get("abstract_params"), **kwargs)
    elif spec.get("param_specs") is not None:
        findings += plan_lint.lint_specs(
            spec["param_specs"],
            spec.get("batch_spec"),
            spec.get("degrees") or {},
            spec.get("strategy", "custom"),
            spec.get("abstract_params"),
            **kwargs,
        )
    fn = spec.get("fn")
    if fn is not None:
        closed = graph_lint.trace_step(fn, *spec.get("args", ()))
        findings += graph_lint.lint_graph(
            closed,
            plan=plan,
            abstract_params=spec.get("abstract_params"),
            grad_accum=int(spec.get("grad_accum", 1)),
            static_args=spec.get("static_args"),
        )
        findings += dtype_lint.lint_dtypes(
            closed,
            abstract_params=spec.get("abstract_params"),
            compute_dtype=spec.get("compute_dtype"),
        )
        if (spec.get("budget") is not None and plan is not None
                and spec.get("abstract_params") is not None):
            est = mem_lint.estimate_step_memory(
                closed, plan, spec["abstract_params"],
                opt_state=spec.get("opt_state"),
                batch=spec.get("batch"),
                grad_accum=int(spec.get("grad_accum", 1)),
            )
            findings += mem_lint.lint_memory(
                est,
                budget_bytes=mem_lint.resolve_budget(spec["budget"]),
                headroom=float(
                    spec.get("headroom", mem_lint.DEFAULT_HEADROOM)),
            )
    elif spec.get("static_args"):
        findings += graph_lint.lint_static_args(spec["static_args"])
    return findings


def analyze(spec: Mapping[str, Any], *,
            ignore: Iterable[str] = ()) -> list[Finding]:
    """:func:`check_spec` with suppression — the canonical programmatic
    entry: ``analysis.analyze(spec, ignore=('PL005',))``."""
    return filter_ignored(check_spec(spec), ignore)


def memory_check(ad: Any, sample_batch: Any, *, rng: Any = None,
                 budget: int | str | None = None,
                 headroom: float | None = None,
                 big_leaf_bytes: int | None = None,
                 compiled: bool = True,
                 ignore: Iterable[str] = ()) -> tuple[list[Finding], dict]:
    """The ``tadnn check --memory`` entry point: build the plan, trace the
    step, run plan + memory + dtype lint, and return ``(findings,
    report)`` where ``report`` is the breakdown ``tadnn report``
    renders.

    With ``compiled`` (default), the static estimate is cross-checked
    against ``AutoDistribute.compile_report``'s measured peak (the step
    run once on fake tensors under a live-storage tracker — an
    independent measurement of the same step; ``compiled=False`` skips
    it).  The report is journaled as a ``lint.mem_estimate`` event;
    findings are NOT journaled here (the caller aggregates layers
    first).
    """
    from . import dtype_lint, mem_lint, plan_lint
    from .. import planner

    if ad.plan is None:
        ad.build_plan(rng, sample_batch)
    prec = getattr(ad, "precision", None)
    abstract = planner.abstract_params(ad.model, prec.param_dtype)
    closed, state = traced_step(ad, sample_batch)
    kwargs = {}
    if big_leaf_bytes is not None:
        kwargs["big_leaf_bytes"] = big_leaf_bytes
    findings = plan_lint.lint_plan(ad.plan, abstract, **kwargs)
    findings += dtype_lint.lint_dtypes(
        closed, abstract_params=state[0],
        compute_dtype=_compute_dtype(ad))
    est = _estimate(ad, closed, sample_batch)
    budget_b = mem_lint.resolve_budget(budget)
    hr = mem_lint.DEFAULT_HEADROOM if headroom is None else float(headroom)
    findings += mem_lint.lint_memory(est, budget_bytes=budget_b,
                                     headroom=hr)
    report = {**est.to_json(), "budget_bytes": int(budget_b),
              "headroom": hr,
              "zero1": bool(getattr(ad.plan, "zero1", False))}
    if compiled:
        comp = ad.compile_report(rng, sample_batch) or {}
        peak_c = comp.get("per_device_peak_bytes")
        report["compiled"] = {
            "per_device_peak_bytes": peak_c,
            "bytes_accessed": comp.get("bytes_accessed"),
            "error": comp.get("error") or getattr(
                ad, "last_compile_error", None),
        }
        if peak_c:
            report["static_over_compiled"] = round(
                est.peak_bytes / peak_c, 3)
    findings = filter_ignored(findings, ignore)
    obs_journal.event("lint.mem_estimate", phase="check", **report)
    return findings, report


