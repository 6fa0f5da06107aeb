"""Collective/comms accounting: expected bytes from the plan, measured
bytes from the run — and the delta between them.

The analytic side lives in ``planner.expected_collective_bytes`` (pure
function of plan + abstract shapes, unit-testable without devices); this
module journals it and joins it with a measured byte count, so a run can
report "the plan implies X bytes of collectives per step; the step moved
Y bytes".  The JAX package's ``obs/comms.py`` with the abstract
parameters on the meta device where it traces ``jax.eval_shape``; the
bytes a profiled step's collectives carried are ``obs.trace``'s
:func:`~.trace.measured_collective_bytes`.
"""

from __future__ import annotations

from typing import Any

from ..planner import expected_collective_bytes  # re-export  # noqa: F401
from . import journal as _journal


def emit_estimate(plan: Any, abstract_params: Any, *,
                  grad_dtype: Any = None, grad_accum: int = 1) -> dict:
    """Compute the planner estimate and journal it as ``comms.estimate``."""
    import numpy as np

    est = expected_collective_bytes(
        plan, abstract_params,
        grad_dtype=grad_dtype if grad_dtype is not None else np.float32,
        grad_accum=grad_accum,
    )
    _journal.event(
        "comms.estimate",
        strategy=est["strategy"], mesh=est["mesh"],
        total_wire_bytes=est["total_wire_bytes"],
        per_device={k: v["payload_bytes"]
                    for k, v in est["per_device"].items()},
        model_dependent=sorted(est["model_dependent"]),
    )
    return est


def comm_profile(ad: Any, rng: Any = None, sample_batch: Any = None, *,
                 grad_accum: int | None = None) -> dict:
    """Expected per-step collective bytes for an AutoDistribute's plan.

    Builds the plan if needed.  The parameters' shapes are taken on the
    meta device (``planner.abstract_params``: no memory, global shapes
    under FSDP2 and TP too).  Returns the planner estimate; also emits a
    ``comms.estimate`` journal event on the default sink.
    """
    from ..planner import abstract_params

    if ad.plan is None:
        ad.build_plan(rng, sample_batch)
    abstract = abstract_params(ad.model, ad.precision.param_dtype)
    return emit_estimate(
        ad.plan, abstract,
        grad_dtype=ad.precision.compute_dtype,
        grad_accum=grad_accum if grad_accum is not None else ad._grad_accum,
    )


def crosscheck(estimate: dict, cost: dict | None) -> dict:
    """Join the analytic estimate with a measured bytes-accessed count.

    ``cost`` is a ``utils.profiling.compiled_cost`` record.  A
    ``bytes_accessed`` count covers every memory touch (params,
    activations, collectives), so it upper-bounds the comm estimate; a
    comm estimate EXCEEDING it flags a broken plan model.  The port's
    ``compiled_cost`` measures no bytes accessed (PyTorch has no
    compiled program to analyse), so ``comm_fraction_of_bytes_accessed``
    and ``consistent`` are None unless the caller supplies the number.
    """
    measured = None
    if cost and not cost.get("error"):
        measured = cost.get("bytes_accessed")
    out = {
        "expected_wire_bytes": estimate["total_wire_bytes"],
        "xla_bytes_accessed": measured,
        "comm_fraction_of_bytes_accessed": (
            estimate["total_wire_bytes"] / measured
            if measured else None
        ),
        "consistent": (
            None if not measured
            else estimate["total_wire_bytes"] <= measured
        ),
    }
    _journal.event("comms.crosscheck", **out)
    return out
