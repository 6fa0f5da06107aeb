"""The serving gateway: routing over replicas, and fleet fault tolerance.

The PyTorch package's port of the JAX package's ``inference/gateway/``,
so far its parts that need nothing unported:

- :mod:`.router` — :class:`Router` places requests on the replica
  already owning the deepest cached prefix (by the radix index's
  chained block hashes), falling back to least-loaded, over
  :class:`EngineReplica` (a real ``ServeEngine``) or
  :class:`SimReplica` (its virtual-time twin);
- :mod:`.fault` — per-replica circuit breakers (a ``Router`` gate),
  tail hedging and the degrade ladder's policies;
- :mod:`.doctor` — the fleet post-mortem of a gateway journal
  (``tadnn doctor --gateway-dir``).

The ingress (``Gateway``, ``HttpIngress``, admission and SSE), the
autoscaling ``FleetController`` and the ``chaos`` scenarios wait for
ROADMAP Queue 1 item 7c: they sit on ``tune/simulate``, which is not
ported yet.
"""

from .doctor import format_gateway_doctor, gateway_doctor
from .fault import (
    BreakerPolicy,
    CircuitBreaker,
    HedgePolicy,
    degrade_effects,
    shed_threshold,
)
from .router import EngineReplica, NoHealthyReplica, Router, SimReplica

__all__ = [
    "BreakerPolicy",
    "CircuitBreaker",
    "EngineReplica",
    "HedgePolicy",
    "NoHealthyReplica",
    "Router",
    "SimReplica",
    "degrade_effects",
    "format_gateway_doctor",
    "gateway_doctor",
    "shed_threshold",
]
