"""Online serving gateway: ingress, routing, and closed-loop autoscale.

Three layers over the continuous-batching serve engine:

- :mod:`.ingress` — :class:`Gateway` (admission: token-bucket rate
  limits, bounded per-tenant queues, priority classes) plus
  :class:`HttpIngress`, a stdlib-asyncio HTTP server streaming tokens
  over SSE;
- :mod:`.router` — :class:`Router` places requests on the replica
  already owning the deepest cached prefix (by the radix index's
  chained block hashes), falling back to least-loaded, over
  :class:`EngineReplica` (a real ``ServeEngine``, its decode attention
  on the paged-attention kernel) or :class:`SimReplica` (its
  virtual-time twin);
- :mod:`.controller` — :class:`FleetController` watches live SLO
  windows and resizes the fleet through the planner's serving replay.

:mod:`.fault` adds the fleet fault-tolerance layer — per-replica
circuit breakers, tail hedging, and the degrade ladder — which the
gateway wires to heartbeat-expiry failover and an exactly-once
per-request token ledger; :mod:`.doctor` is the fleet post-mortem of a
gateway journal (``tadnn doctor --gateway-dir``).

:mod:`.chaos` scripts the whole loop on a virtual clock (traffic flip
→ breach → replan → recover, plus seeded replica kill/stall/slow) as
byte-replayable scenarios — ``tadnn gateway --smoke`` and ``tadnn
gateway --chaos``.

The PyTorch package's port of the JAX package's ``inference/gateway/``.
"""

from .chaos import chaos_smoke, fleet_chaos, run_scenario
from .controller import AutoscalePolicy, FleetController
from .doctor import format_gateway_doctor, gateway_doctor
from .fault import (
    BreakerPolicy,
    CircuitBreaker,
    HedgePolicy,
    degrade_effects,
    shed_threshold,
)
from .ingress import (
    Gateway,
    GatewayError,
    HttpIngress,
    RateLimited,
    Saturated,
    TokenBucket,
    serve_forever,
    sse_generate,
)
from .router import EngineReplica, NoHealthyReplica, Router, SimReplica

__all__ = [
    "AutoscalePolicy",
    "BreakerPolicy",
    "CircuitBreaker",
    "EngineReplica",
    "FleetController",
    "Gateway",
    "GatewayError",
    "HedgePolicy",
    "HttpIngress",
    "NoHealthyReplica",
    "RateLimited",
    "Router",
    "Saturated",
    "SimReplica",
    "TokenBucket",
    "chaos_smoke",
    "degrade_effects",
    "fleet_chaos",
    "format_gateway_doctor",
    "gateway_doctor",
    "run_scenario",
    "serve_forever",
    "sse_generate",
    "shed_threshold",
]
