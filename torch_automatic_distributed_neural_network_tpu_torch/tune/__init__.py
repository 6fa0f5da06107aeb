"""Cost-model-driven parallelism autotuner.

Turns plan selection from a single hand-written heuristic
(``planner.choose_strategy``) into enumerate -> score -> (optionally)
measure -> cache:

- :mod:`.space` — candidate mesh factorizations x strategy x tensor
  degree x grad-accum, pruned by a per-device memory-fit estimate
- :mod:`.cost` — analytic roofline step-time model (FLOPs, the
  planner's collective-bytes estimate over the per-link NVLink and
  network numbers, HBM pressure)
- :mod:`.measure` — optional build-and-time of the top-k candidates
  (the real train step; on the CPU too)
- :mod:`.cache` — persistent JSONL decisions under ``~/.cache/tadnn/``
  (``TADNN_TUNE_CACHE`` overrides)

Use it implicitly with ``AutoDistribute(..., strategy='tuned')`` /
``make_plan(strategy='tuned')``, or explicitly via :func:`tune` and the
``tadnn tune`` CLI.  Decisions, cost breakdowns, and measured trials
are journaled (``tune.*`` events) so ``tadnn report`` shows why a plan
was chosen.

The fleet-scale what-if layer composes these with the serving and
resilience models:

- :mod:`.simulate` — sweep hypothetical topologies x plans, predict
  MFU / HBM headroom / serving tok/s + p99 (discrete-event replay of
  the real scheduler) / restart survival (``tadnn simulate``)
- :mod:`.slo` — operator SLO specs the sweep ranks against

The PyTorch package's port of the JAX package's ``tune/``.
"""

from . import cache, cost, measure, simulate, slo, space
from .cost import CostEstimate, rank, score
from .simulate import SimulatePolicy, TrafficMix, replay_serve
from .slo import SLOSpec
from .space import Candidate, enumerate_candidates, estimate_batch_items
from .tuner import TunePolicy, TuneResult, tune

__all__ = [
    "Candidate",
    "CostEstimate",
    "SLOSpec",
    "SimulatePolicy",
    "TrafficMix",
    "TunePolicy",
    "TuneResult",
    "cache",
    "cost",
    "enumerate_candidates",
    "estimate_batch_items",
    "measure",
    "rank",
    "replay_serve",
    "score",
    "simulate",
    "slo",
    "space",
    "tune",
]
