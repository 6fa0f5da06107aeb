"""Static analysis — the jax-free part of the JAX package's
``analysis/`` (``tadnn check``), with the same rule table and
:class:`Finding` vocabulary:

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

Findings are typed (``error``/``warn``) and journaled as ``lint.*``
events.  The layers that trace a step (plan, graph, memory and dtype
lint: :func:`preflight`, :func:`check_spec` / :func:`analyze`,
:func:`memory_check`) wait for ROADMAP Queue 1 item 7.
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"analysis.{what} (the plan, graph, memory and dtype lint over a "
        f"traced step) is not ported to the PyTorch package yet (ROADMAP "
        f"Queue 1 item 7)")


def preflight(ad: Any, sample_batch: Any, **kwargs) -> list[Finding]:
    """Plan + graph + memory + dtype lint for a built AutoDistribute:
    not ported yet."""
    raise _not_ported("preflight")


def check_spec(spec: Mapping[str, Any]) -> list[Finding]:
    """Lint a user-supplied spec: not ported yet."""
    raise _not_ported("check_spec")


def analyze(spec: Mapping[str, Any], *,
            ignore: Iterable[str] = ()) -> list[Finding]:
    """:func:`check_spec` with suppression: not ported yet."""
    raise _not_ported("analyze")


def memory_check(ad: Any, sample_batch: Any, **kwargs):
    """The ``tadnn check --memory`` entry point: not ported yet."""
    raise _not_ported("memory_check")
