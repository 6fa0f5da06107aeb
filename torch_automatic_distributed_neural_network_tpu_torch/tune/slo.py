"""Operator SLO specs for the what-if planner (``tadnn simulate``).

The PyTorch package's copy of the JAX package's ``tune/slo.py`` (pure
stdlib there too).  ``tune/simulate`` ranks its predictions against it,
and ``obs/slo_monitor`` judges live serving windows with it;
:func:`rank` works on any list of prediction dicts.

An :class:`SLOSpec` is the contract a candidate fleet plan must meet:
minimum serving throughput per chip, maximum p99 latency, minimum
per-device HBM headroom, minimum probability of surviving the mission
without exhausting the restart budget.  Candidates are ranked SLO-first
— every plan that meets the spec beats every plan that misses it, and
among the misses fewer violations rank higher — so the top of the
report is always the cheapest plan that actually keeps the promise,
not the fastest plan that quietly blows the latency budget.

Specs are spelled compactly on the command line::

    tadnn simulate --slo "tok_s_chip>=40,p99_ms<=2500,headroom>=0.1,survival>=0.9"
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

# CLI field -> (attr, comparator, value transform).  Latencies are
# spelled in ms on the command line (operators think in ms) but stored
# in seconds like every other latency in the codebase.
_FIELDS = {
    "tok_s_chip": ("min_tok_s_per_chip", ">=", 1.0),
    "p99_ms": ("max_p99_s", "<=", 1e-3),
    "headroom": ("min_hbm_headroom_frac", ">=", 1.0),
    "survival": ("min_survival", ">=", 1.0),
    # p99 time-to-first-token / inter-token latency: predicted by the
    # serve replay and measured live per window (obs/live)
    "ttft_ms": ("max_ttft_p99_s", "<=", 1e-3),
    "itl_ms": ("max_itl_p99_s", "<=", 1e-3),
}


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Thresholds a candidate plan must meet; None means "don't care"."""

    min_tok_s_per_chip: float | None = None
    max_p99_s: float | None = None
    min_hbm_headroom_frac: float | None = None
    min_survival: float | None = None
    max_ttft_p99_s: float | None = None
    max_itl_p99_s: float | None = None

    @classmethod
    def parse(cls, text: str | None) -> "SLOSpec":
        """Parse ``"tok_s_chip>=40,p99_ms<=2500,headroom>=0.1"``.

        Unknown fields or comparators raise ValueError loudly — a typo
        in an SLO must never silently relax the contract.
        """
        if not text or not text.strip():
            return cls()
        kwargs: dict[str, float] = {}
        for clause in text.split(","):
            clause = clause.strip()
            if not clause:
                continue
            for op in (">=", "<="):
                if op in clause:
                    name, _, raw = clause.partition(op)
                    break
            else:
                raise ValueError(
                    f"SLO clause {clause!r} has no >= or <= comparator")
            name = name.strip()
            if name not in _FIELDS:
                raise ValueError(
                    f"unknown SLO field {name!r}; known: "
                    f"{', '.join(sorted(_FIELDS))}")
            attr, want_op, scale = _FIELDS[name]
            if op != want_op:
                raise ValueError(
                    f"SLO field {name!r} takes {want_op}, not {op}")
            kwargs[attr] = float(raw) * scale
        return cls(**kwargs)

    def evaluate(self, pred: Mapping[str, Any]
                 ) -> tuple[bool, list[str]]:
        """Check a candidate prediction; returns (ok, violations).

        A threshold whose metric is missing from the prediction counts
        as a violation (e.g. an SLO demanding serving throughput from a
        model family the serve estimator cannot size) — absence of
        evidence is not compliance.
        """
        violations: list[str] = []

        def check(value, bound, greater: bool, label: str) -> None:
            if bound is None:
                return
            if value is None:
                violations.append(f"{label}: no prediction")
            elif (value < bound) if greater else (value > bound):
                violations.append(
                    f"{label}: {value:.4g} vs required "
                    f"{'>=' if greater else '<='} {bound:.4g}")

        check(pred.get("tok_s_per_chip"), self.min_tok_s_per_chip,
              True, "tok_s_chip")
        check(pred.get("p99_s"), self.max_p99_s, False, "p99_s")
        check(pred.get("hbm_headroom_frac"), self.min_hbm_headroom_frac,
              True, "headroom")
        check(pred.get("survival"), self.min_survival, True, "survival")
        check(pred.get("ttft_p99_s"), self.max_ttft_p99_s,
              False, "ttft_p99_s")
        check(pred.get("itl_p99_s"), self.max_itl_p99_s,
              False, "itl_p99_s")
        if not pred.get("fits", True):
            violations.append("memory: plan does not fit in HBM")
        return (not violations, violations)


def rank_key(pred: Mapping[str, Any]) -> tuple:
    """Sort key over evaluated predictions: SLO-passing plans first,
    then fewest violations, then highest serving throughput per chip,
    then fastest training step."""
    return (
        not pred.get("slo_ok", False),
        len(pred.get("slo_violations", ())),
        -(pred.get("tok_s_per_chip") or 0.0),
        pred.get("step_time_s", float("inf")),
    )


def rank(preds: list[dict], spec: SLOSpec) -> list[dict]:
    """Evaluate ``spec`` over each prediction (annotating ``slo_ok`` /
    ``slo_violations`` in place) and return them ranked best-first."""
    for p in preds:
        ok, violations = spec.evaluate(p)
        p["slo_ok"] = ok
        p["slo_violations"] = violations
    return sorted(preds, key=rank_key)
