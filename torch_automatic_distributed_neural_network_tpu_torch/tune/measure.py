"""Measured calibration: build and time the top-k tuner candidates.

The analytic model ranks cheaply; this module answers "but is it
actually faster?" by running a short real microbenchmark of the actual
train step per candidate — init, warmup (the kernels' first launch),
then a few timed steps.  Works on the CPU (the plain PyTorch versions)
exactly as on the card.

Every trial is journaled as an obs span (``tune.trial``) with the
measured milliseconds, so ``tadnn report`` can show the trials next to
the analytic decision.

The PyTorch package's port of the JAX package's ``tune/measure.py``:
``time_step`` fences with ``torch.cuda.synchronize`` on the state's
device (nothing to fence on the CPU), and the candidates' weights come
from one seed (an int, or a ``torch.Generator``'s initial seed), drawn
anew on each candidate's device.  A trial's ``compiled_flops`` come
from ``AutoDistribute.compile_report`` (the step's FLOPs counted on fake
tensors: the port compiles no step whose cost it could ask for).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch

from ..obs import journal as obs_journal
from .space import Candidate


def _fence(state) -> None:
    """Wait for the device work queued on the state's parameters."""
    devices = {p.device for p in state.params.values()
               if isinstance(p, torch.Tensor) and p.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def time_step(ad, state, batch, *, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-clock seconds of ``ad.step`` after warmup."""
    for _ in range(max(1, warmup)):
        state, _ = ad.step(state, batch)
    _fence(state)
    times = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        state, _ = ad.step(state, batch)
        _fence(state)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _seed_of(rng: torch.Generator | int) -> int:
    return int(rng.initial_seed()) if isinstance(rng, torch.Generator) \
        else int(rng)


def measure_candidates(
    candidates: Sequence[Candidate],
    make_ad: Callable[[Candidate], Any],
    rng: torch.Generator | int,
    sample_batch: Any,
    *,
    warmup: int = 1,
    iters: int = 3,
) -> list[dict]:
    """Run the microbenchmark for each candidate.

    ``make_ad(candidate)`` must return a fresh ``AutoDistribute``
    configured for that candidate (strategy + mesh from its degrees +
    its grad_accum).  Each candidate draws its weights from ``rng``'s
    seed on its own device.  A candidate that fails to build or runs
    out of memory is reported with its error instead of aborting the
    sweep — the analytic ranking already called it plausible;
    measurement is where reality gets a veto.
    """
    seed = _seed_of(rng)
    results: list[dict] = []
    for cand in candidates:
        fields = {
            "candidate": cand.label(),
            "strategy": cand.strategy,
            "mesh": cand.degrees_dict,
            "grad_accum": cand.grad_accum,
        }
        with obs_journal.span("tune.trial", **fields):
            entry = dict(fields)
            try:
                ad = make_ad(cand)
                gen = torch.Generator(device=ad.device).manual_seed(seed)
                state = ad.init(gen, sample_batch)
                step_s = time_step(
                    ad, state, sample_batch, warmup=warmup, iters=iters
                )
                entry["step_time_s"] = step_s
                entry["step_time_ms"] = round(step_s * 1e3, 3)
                flops = _compiled_flops(ad, state, sample_batch)
                if flops is not None:
                    entry["compiled_flops"] = flops
            except Exception as e:  # noqa: BLE001 — a veto, not a crash
                entry["error"] = f"{type(e).__name__}: {e}"
            obs_journal.event("tune.trial.result", **entry)
            results.append(entry)
    return results


def _compiled_flops(ad, state, batch) -> float | None:
    """FLOPs of the step from ``AutoDistribute.compile_report`` (the step
    run once on fake tensors under ``FlopCounterMode``'s formulas; K1-K3
    by their registered ones) — None when the report has none, as the
    JAX package answers when its backend gives no cost analysis."""
    try:
        report = ad.compile_report(None, batch)
    except Exception:  # noqa: BLE001 — a cost, never a veto
        return None
    return (report or {}).get("flops")
