"""Plan tuning.  Ported so far: the operator SLO specs
(:mod:`.slo`); the cost model, the search, the cache and the what-if
simulator wait for ROADMAP Queue 1 item 7."""

from . import slo
from .slo import SLOSpec, rank, rank_key

__all__ = ["SLOSpec", "rank", "rank_key", "slo"]
