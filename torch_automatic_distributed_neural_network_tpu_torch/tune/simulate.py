"""Fleet-scale what-if planner: joint train × serve × survive predictions
for hypothetical GPU fleets, without touching a card.

``tadnn simulate`` sweeps topologies (``topology.parse_topology``
spellings, ``h100-8`` or ``h100-8x4``, optionally expanded over host
counts) crossed with every
plan the tuner would enumerate (``tune/space.py``) and, per candidate,
joins four independently-shipped models into one prediction:

- **training**: roofline MFU / step time from ``tune/cost.py`` (with
  any measured overlap correction), per-device HBM headroom from the
  same sharding-aware memory math the tuner prunes with;
- **serving**: KV-pool capacity from ``analysis.serve_lint`` and
  throughput / p99 / occupancy / preemptions from a discrete-event
  replay of the REAL ``scheduler.py`` — the replay drives an actual
  :class:`Scheduler` on virtual time, mirroring ``ServeEngine.step``'s
  phase order exactly, so the predicted admission behavior is the
  shipped policy, not a model of it;
- **survival**: probability the fleet's preemption rate exhausts the
  ``RestartPolicy`` rolling-window restart budget over the mission
  (``training.resilience.survival_probability``).

Candidates are ranked by an operator SLO (``tune/slo.py``), sweeps are
cached through ``tune/cache.py``, and everything journals ``simulate.*``
events for ``tadnn report``.  Every future real bench record becomes a
falsification test of these predictions (``report --check-simulate``).

The PyTorch package's copy of the JAX package's ``tune/simulate.py``, on
the port's ``BlockAllocator``, ``PrefixCache`` and ``Scheduler``.  A
"slice" of the JAX package is a host here: its NVLink domain
(``topology.parse_topology``), joined to the others by InfiniBand.
:func:`expand_topologies` keeps the JAX package's algebra, so an
un-sliced ``h100-16`` at slicing 1 is one 16-card NVLink domain, which
an 8-card HGX host is not; the sweep does not refuse it.  The attention
projections split their heads in the training charge
(``space.charge_view``) by ``model_cfg``'s head counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np

from .. import planner
from .. import topology as topo_mod
from ..inference.serve.kv_pool import BlockAllocator, blocks_for_tokens
from ..inference.serve.prefix_cache import PrefixCache
from ..inference.serve.scheduler import Request, Scheduler
from ..obs import journal as obs_journal
from . import cache as cache_mod
from . import cost as cost_mod
from . import space as space_mod
from .slo import SLOSpec, rank as slo_rank

# Matmul efficiency assumed by the analytic serving-time model — same
# knob the training roofline uses.
_EFFICIENCY = cost_mod._EFFICIENCY


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """Parameterized serving traffic for the discrete-event replay.

    ``rate_per_s`` draws seeded exponential inter-arrivals; prompt and
    decode lengths are drawn uniformly within ``±jitter`` of their
    means (``jitter=0`` makes the mix fully deterministic, which the
    analytic tests rely on).  ``decode_mean`` is the EXPECTED tokens
    before EOS — the replay emits EOS there, so ``max_new`` is the
    budget, not the typical length, exactly like production traffic.

    ``shared_prefix`` models prefix-heavy production traffic: every
    request's prompt opens with that many IDENTICAL tokens (a system
    prompt / few-shot preamble), the rest unique per request.  With
    ``replay_serve(prefix_cache=True)`` the replay's radix index then
    prices the redundant-prefill savings; with the cache off the knob
    changes nothing (content never affects timing there).
    """

    rate_per_s: float = 16.0
    n_requests: int = 64
    prompt_mean: int = 128
    max_new: int = 128
    decode_mean: int | None = None
    jitter: float = 0.5
    seed: int = 0
    shared_prefix: int = 0

    @classmethod
    def parse(cls, text: str | None) -> "TrafficMix":
        """Parse ``"rate=16,n=64,prompt=128,max_new=128,decode=96"``."""
        if not text or not text.strip():
            return cls()
        alias = {"rate": "rate_per_s", "n": "n_requests",
                 "prompt": "prompt_mean", "decode": "decode_mean",
                 "shared": "shared_prefix"}
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for clause in text.split(","):
            clause = clause.strip()
            if not clause:
                continue
            name, sep, raw = clause.partition("=")
            if not sep:
                raise ValueError(
                    f"traffic clause {clause!r} is not name=value")
            name = alias.get(name.strip(), name.strip())
            if name not in fields:
                raise ValueError(
                    f"unknown traffic field {name!r}; known: "
                    f"{', '.join(sorted(set(fields) | set(alias)))}")
            val = float(raw)
            kwargs[name] = (val if name in ("rate_per_s", "jitter")
                            else int(val))
        return cls(**kwargs)

    def sample(self, *, max_len: int
               ) -> list[tuple[float, int, int, int]]:
        """Seeded request list: ``(arrival_s, n_prompt, max_new,
        n_decode)`` tuples, clamped to the engine's ``max_len``."""
        rng = np.random.RandomState(self.seed)
        t = 0.0
        out: list[tuple[float, int, int, int]] = []
        decode_mean = self.decode_mean or self.max_new

        def draw(mean: int) -> int:
            if self.jitter <= 0:
                return max(1, int(mean))
            lo = max(1, int(mean * (1.0 - self.jitter)))
            hi = max(lo, int(mean * (1.0 + self.jitter)))
            return int(rng.randint(lo, hi + 1))

        for _ in range(max(1, self.n_requests)):
            if self.rate_per_s > 0:
                t += float(rng.exponential(1.0 / self.rate_per_s))
            n_prompt = min(draw(self.prompt_mean), max(1, max_len - 1))
            max_new = min(int(self.max_new), max_len - n_prompt)
            max_new = max(1, max_new)
            n_decode = max(1, min(draw(decode_mean), max_new))
            out.append((t, n_prompt, max_new, n_decode))
        return out


def replay_serve(
    requests: Sequence[tuple[float, int, int, int]],
    *,
    n_slots: int = 8,
    block_size: int = 16,
    max_len: int = 256,
    num_blocks: int | None = None,
    admission: str = "reserve",
    prefill_chunk: int | None = 32,
    prefill_chunks_per_step: int = 1,
    spec_lookahead: int = 0,
    decode_step_s: float = 1e-3,
    prefill_chunk_s: float = 1e-3,
    disaggregate: bool = False,
    kv_ship_s: float = 0.0,
    dcn_step_s: float = 0.0,
    prefix_cache: bool = False,
    shared_prefix: int = 0,
    max_steps: int = 200_000,
) -> dict:
    """Discrete-event replay of the serving scheduler on virtual time.

    Drives a REAL :class:`Scheduler` + :class:`BlockAllocator` (the
    clock injected, nothing else changed) through the exact phase order
    of ``ServeEngine.step``: evict finished → admit/start-prefill →
    advance one chunk per planned slot → grow/preempt (optimistic) →
    decode every running slot → occupancy accrual.  Token *values* are
    emulated (EOS exactly at each request's ``n_decode``); token
    *timing* comes from the supplied per-step costs, so the output is
    the policy's admission/preemption/occupancy behavior priced in
    seconds.

    ``disaggregate`` mirrors the engine's split-slice mode: every
    prefilling slot advances each step (no chunks-per-step cap), each
    finished prefill pays ``kv_ship_s`` to hand its KV blocks to the
    decode slice (``Scheduler.record_ship`` accounting, same counters
    the live engine accrues), and a step's wall time is
    ``max(prefill_side, decode_side)`` — the slices run concurrently —
    instead of their sum.  ``dcn_step_s`` prices per-decode-step
    cross-slice collectives (a tp group spanning slices); it is added
    on the decode side in both modes.

    ``prefix_cache`` drives a REAL :class:`PrefixCache` (the engine's
    radix index, same eviction and admission interplay): prompts are
    synthesized as ``shared_prefix`` identical tokens plus a unique
    per-request suffix, each finished prefill publishes its full
    prompt blocks, and a later request's matched prefix skips those
    chunks — so the replay PRICES the hit rate instead of assuming one.
    """
    if prefix_cache and not prefill_chunk:
        raise ValueError(
            "prefix_cache=True requires chunked prefill (the replay "
            "mirrors the engine's contract)")
    clock = [0.0]
    if num_blocks is None:
        num_blocks = n_slots * blocks_for_tokens(max_len, block_size) + 1
    alloc = BlockAllocator(num_blocks)
    pc = (PrefixCache(block_size=block_size, allocator=alloc,
                      clock=lambda: clock[0])
          if prefix_cache else None)
    sched = Scheduler(
        n_slots=n_slots, allocator=alloc, block_size=block_size,
        admission=admission, spec_lookahead=spec_lookahead,
        prefix_cache=pc, clock=lambda: clock[0])
    chunk = (math.gcd(min(int(prefill_chunk), max_len), max_len)
             if prefill_chunk else None)

    pending = sorted(requests)  # by arrival
    n_decode_of: dict[int, int] = {}
    prefill_pos: dict[int, int] = {}
    done: list[Request] = []
    next_arrival = 0

    def emit(req: Request) -> None:
        # EOS (0) exactly at the request's true decode length, 1 else —
        # finished() then trips on the same (max_new | eos) rule the
        # engine uses
        eos_at = n_decode_of[req.rid]
        req.out_tokens.append(0 if req.n_generated + 1 >= eos_at else 1)
        # virtual-time token stamp: consecutive diffs are the replay's
        # predicted inter-token latencies, same field the engine fills
        req.token_walls.append(clock[0])

    steps = 0
    occ_sum = 0.0
    prefill_busy = 0.0
    decode_busy = 0.0
    while steps < max_steps:
        # arrivals due by now join the queue (bench-style all-up-front
        # submission is just every arrival at t=0)
        while (next_arrival < len(pending)
               and pending[next_arrival][0] <= clock[0] + 1e-12):
            arr, n_prompt, max_new, n_dec = pending[next_arrival]
            # shared-prefix content: the radix index matches on token
            # ids, so the shared head must be identical and the tail
            # unique per request (cache off: content is timing-inert)
            n_shared = max(0, min(int(shared_prefix), int(n_prompt) - 1))
            prompt = ([1] * n_shared
                      + [2 + next_arrival] * (int(n_prompt) - n_shared))
            req = Request(prompt=prompt,
                          max_new_tokens=int(max_new), eos_id=0)
            req.t_submit = float(arr)
            n_decode_of[req.rid] = int(n_dec)
            sched.submit(req)
            next_arrival += 1
        if next_arrival >= len(pending) and sched.idle():
            break

        # -- one ServeEngine.step(), phase for phase ---------------------
        progressed = False
        for s in range(n_slots):
            req = sched.slots[s]
            if (req is not None and req.state == "running"
                    and req.finished()):
                done.append(sched.evict(s))
                progressed = True
        step_pf_s = 0.0
        step_dec_s = 0.0

        def ship(slot: int, req: Request) -> float:
            # disaggregated: finished prefill pays the block handoff
            # into the decode slice (engine: pool.ship_prefill)
            if not disaggregate:
                return 0.0
            sched.record_ship(
                slot, blocks_for_tokens(req.n_prompt, block_size))
            return kv_ship_s

        for slot, req in sched.admit():
            progressed = True
            if chunk is None:
                step_pf_s += prefill_chunk_s  # one full prompt forward
                step_pf_s += ship(slot, req)
                emit(req)  # single-shot prefill: first token now
                req.t_first_token = clock[0]
                if req.finished():
                    done.append(sched.evict(slot))
            else:
                req.state = "prefilling"
                # a prefix-cache hit starts the cursor after the
                # matched blocks — the skipped chunks are the savings
                prefill_pos[req.rid] = req.cached_tokens
        budget = None if disaggregate else prefill_chunks_per_step
        for slot, req in sched.prefill_plan(budget):
            pos = prefill_pos[req.rid]
            pos += min(chunk, req.n_prompt - pos)
            prefill_pos[req.rid] = pos
            step_pf_s += prefill_chunk_s
            progressed = True
            if pos >= req.n_prompt:
                del prefill_pos[req.rid]
                step_pf_s += ship(slot, req)
                if pc is not None:
                    # publish full prompt blocks (engine: at commit /
                    # KV-ship time)
                    n_pub = req.n_prompt // block_size
                    pc.insert(req.prompt[:n_pub * block_size],
                              req.blocks[:n_pub])
                emit(req)
                req.t_first_token = clock[0]
                req.state = "running"
                if req.finished():
                    done.append(sched.evict(slot))
        for victim in sched.grow_for_step():
            prefill_pos.pop(victim.rid, None)
            progressed = True
        if sched.n_decoding:
            for req in sched.slots:
                if req is not None and req.state == "running":
                    emit(req)
            step_dec_s += decode_step_s + dcn_step_s
            progressed = True
        steps += 1
        occ_sum += sched.n_active / n_slots
        prefill_busy += step_pf_s
        decode_busy += step_dec_s
        # one chip serializes the phases; distinct slices overlap them
        step_s = (max(step_pf_s, step_dec_s) if disaggregate
                  else step_pf_s + step_dec_s)
        clock[0] += step_s

        if not progressed:
            if next_arrival < len(pending):
                # queue drained before the next arrival: jump to it
                clock[0] = max(clock[0], pending[next_arrival][0])
            else:
                break  # wedged (pool too small to ever admit) — report

    totals = [r.t_done - r.t_submit for r in done if r.t_done is not None]
    waits = [r.t_admit - r.t_submit for r in done if r.t_admit is not None]
    ttfts = [r.t_first_token - r.t_submit for r in done
             if r.t_first_token is not None]
    itls = [b - a for r in done
            for a, b in zip(r.token_walls, r.token_walls[1:])]
    new_tokens = sum(r.n_generated for r in done)
    wall = clock[0]
    return {
        "steps": steps,
        "n_requests": len(requests),
        "n_finished": len(done),
        "stalled": len(done) < len(requests),
        "new_tokens": int(new_tokens),
        "wall_s": wall,
        "tokens_per_s": (new_tokens / wall) if wall > 0 else 0.0,
        "mean_occupancy": (occ_sum / steps) if steps else 0.0,
        "preemptions": int(sched.n_preemptions),
        "disaggregate": bool(disaggregate),
        "prefill_busy_s": prefill_busy,
        "decode_busy_s": decode_busy,
        "kv_ships": int(sched.n_kv_ships),
        "shipped_blocks": int(sched.shipped_blocks),
        "p50_s": float(np.percentile(totals, 50)) if totals else None,
        "p99_s": float(np.percentile(totals, 99)) if totals else None,
        "p99_admission_wait_s": (float(np.percentile(waits, 99))
                                 if waits else None),
        "ttft_p50_s": float(np.percentile(ttfts, 50)) if ttfts else None,
        "ttft_p99_s": float(np.percentile(ttfts, 99)) if ttfts else None,
        "itl_p50_s": float(np.percentile(itls, 50)) if itls else None,
        "itl_p99_s": float(np.percentile(itls, 99)) if itls else None,
        "prefix_cache": bool(prefix_cache),
        **({"prefix_queries": pc.queries,
            "prefix_hit_requests": pc.hit_requests,
            "prefix_hit_tokens": pc.hit_tokens,
            "prefix_hit_rate": (
                pc.hit_tokens
                / max(1, sum(int(r[1]) for r in requests))),
            "prefix_evicted_blocks": pc.evicted_blocks}
           if pc is not None else {}),
    }


def replay_bench_record(extra: Mapping[str, Any]) -> dict:
    """Replay a recorded SERVE_BENCH config against the current
    scheduler policy — the ``--check-simulate`` falsification path.

    Per-request decode lengths are not recorded, only the total; the
    replay spreads ``new_tokens`` evenly across the streams (the
    max-occupancy reading of the total — measured occupancy with
    staggered EOS lengths sits a little below it).  Step costs come
    from the record's measured breakdown.
    """
    streams = int(extra["streams"])
    total_new = int(extra.get("new_tokens") or
                    streams * int(extra["max_new"]))
    base, rem = divmod(total_new, streams)
    lens = [base + (1 if i < rem else 0) for i in range(streams)]
    prompt = int(extra["prompt_len"])
    max_new = int(extra["max_new"])
    bd = extra.get("breakdown") or {}
    requests = [(0.0, prompt, max_new, max(1, lens[i]))
                for i in range(streams)]
    result = replay_serve(
        requests,
        n_slots=int(extra["slots"]),
        block_size=int(extra["block_size"]),
        # max_len joined the recorded extra after r03; 64 is the bench
        # default it ran with
        max_len=int(extra.get("max_len") or 64),
        admission=str(extra.get("admission") or "reserve"),
        prefill_chunk=extra.get("prefill_chunk"),
        spec_lookahead=int(extra.get("speculative") or 0),
        decode_step_s=float(bd.get("decode_step_ms") or 1.0) * 1e-3,
        prefill_chunk_s=float(bd.get("prefill_chunk_ms") or 1.0) * 1e-3,
        # r04+ records carry the engine mode; the in-process bench ships
        # blocks at HBM speed, so no extra kv_ship_s term here
        disaggregate=bool(extra.get("disaggregate")),
        # r05+ records carry the prefix-cache mix; the replay reprices
        # the recorded hit rate instead of trusting it
        prefix_cache=bool(extra.get("prefix_cache")),
        shared_prefix=int(extra.get("shared_prefix") or 0),
    )
    obs_journal.event("simulate.replay", source="bench_record", **{
        k: result[k] for k in ("steps", "new_tokens", "tokens_per_s",
                               "mean_occupancy", "preemptions")})
    return result


@dataclasses.dataclass(frozen=True)
class SimulatePolicy:
    """Knobs of the what-if sweep; hashed into the cache key (plain
    JSON-able values only), so any change re-simulates instead of
    replaying a stale report."""

    # training search space (tune/space.py)
    grad_accums: tuple[int, ...] = (1, 2, 4, 8)
    max_tensor: int = 8
    state_factor: float = 4.0
    batch_items: int | None = None
    safety: float = space_mod.MEMORY_SAFETY
    zero1: bool = True
    # measured comm/compute overlap (0..1) correcting the training
    # roofline — from `tadnn trace` via cost.overlap_from_trace, wired
    # through `tadnn simulate --trace-journal` / --measured-overlap
    measured_overlap: float | None = None
    # topology expansion: an un-sliced spec ("h100-16") is swept over
    # these host counts (kept where they divide the card count)
    slicings: tuple[int, ...] = (1, 2, 4, 8, 16)
    # serving deployment shape (engine defaults)
    admissions: tuple[str, ...] = ("reserve", "optimistic")
    slots: int = 8
    block_size: int = 16
    max_len: int = 256
    prefill_chunk: int | None = 32
    spec_lookahead: int = 0
    # disaggregated prefill/decode serving replicas (engine
    # --disaggregate): prefill on its own host, KV blocks shipped over
    # the network on multi-host fleets, step wall = max(prefill, decode)
    disaggregate: bool = False
    quant_kv: bool = False
    # cross-request prefix caching (engine --prefix-cache): the replay
    # drives the real radix index over TrafficMix.shared_prefix traffic
    prefix_cache: bool = False
    adapters: int = 0
    adapter_rank: int = 8
    # measured per-step costs override the analytic serving-time model
    decode_step_ms: float | None = None
    prefill_chunk_ms: float | None = None
    # restart-budget survival (training.resilience.RestartPolicy math);
    # the preemption rate is PER HOST per hour — big fleets fail more
    preemption_rate_per_h: float = 0.0
    mission_hours: float = 24.0
    max_restarts: int = 2
    restart_window_s: float = 3600.0
    top_k: int = 10
    use_cache: bool = True


def expand_topologies(
    specs: Sequence[str], slicings: Sequence[int]
) -> list[tuple[str, topo_mod.Topology]]:
    """Parse sweep targets; a spec without an explicit ``xN`` slicing
    fans out over every host count in ``slicings`` that divides its
    card count (slicing changes which collectives ride the network
    between hosts, so it is a real degree of freedom, not a spelling
    detail)."""
    out: list[tuple[str, topo_mod.Topology]] = []
    for spec in specs:
        if "x" in spec.partition("-")[2]:
            out.append((spec, topo_mod.parse_topology(spec)))
            continue
        base = topo_mod.parse_topology(spec)
        n = base.num_devices
        for s in sorted(set(int(s) for s in slicings)):
            if s < 1 or n % s:
                continue
            label = spec if s == 1 else f"{base.device_kind}-{n // s}x{s}"
            out.append((label, topo_mod.parse_topology(label)))
    return out


def _serving_times(chip: topo_mod.ChipSpec, *, params_bytes: int,
                   kv_bytes_per_step: float, prefill_flops_chunk: float,
                   tensor: int) -> tuple[float, float]:
    """Analytic (decode_step_s, prefill_chunk_s) for one tp-group
    serving replica: decode is HBM-bound (weights + KV read per step),
    prefill is the max of its FLOPs and the same weight read."""
    read = params_bytes / max(1, tensor) + kv_bytes_per_step
    decode = read / (chip.hbm_bytes_per_s * _EFFICIENCY)
    pf_compute = prefill_flops_chunk / max(1, tensor) / (
        chip.flops_per_s * _EFFICIENCY)
    pf_mem = (params_bytes / max(1, tensor)
              / (chip.hbm_bytes_per_s * _EFFICIENCY))
    return decode, max(pf_compute, pf_mem)


def _params_bytes(abstract_params: Mapping[str, Any]) -> int:
    return int(sum(
        math.prod(planner._shape(leaf) or (1,))
        * planner._itemsize(getattr(leaf, "dtype", np.float32))
        for leaf in abstract_params.values()))


def simulate(
    abstract_params: Mapping[str, Any],
    topo_specs: Sequence[str],
    *,
    model_cfg: Any = None,
    rules: Sequence[planner.Rule] = planner.TRANSFORMER_RULES,
    policy: SimulatePolicy | None = None,
    traffic: TrafficMix | None = None,
    slo: SLOSpec | None = None,
    cache_path: str | None = None,
) -> dict:
    """Run the full what-if sweep; returns the ranked report dict.

    ``model_cfg`` (a transformer config with n_layers/kv_heads/head_dim,
    e.g. ``model.cfg``) sizes the serving KV pool; without one the
    serving terms are None and serving SLO clauses read as violations.
    Pure shape math + virtual-time replay — device-free by construction.
    """
    # imported here: training.resilience pulls in torch's distributed
    # checkpointing, which importing the package should not pay for
    from ..training.resilience import survival_probability

    policy = policy or SimulatePolicy()
    traffic = traffic or TrafficMix()
    slo = slo or SLOSpec()
    key = cache_mod.cache_key(
        cache_mod.params_signature(abstract_params),
        {"specs": sorted(topo_specs)},
        {"sim": dataclasses.asdict(policy),
         "traffic": dataclasses.asdict(traffic),
         "slo": dataclasses.asdict(slo)},
    )
    if policy.use_cache:
        rec = cache_mod.lookup(key, path=cache_path)
        if rec and rec.get("predictions"):
            obs_journal.event("simulate.cache_hit", key=key,
                              n_candidates=len(rec["predictions"]))
            return {**rec, "cache": "hit", "key": key}
        obs_journal.event("simulate.cache_miss", key=key)

    params_bytes = _params_bytes(abstract_params)
    heads = ((int(model_cfg.n_heads), int(model_cfg.kv_heads))
             if hasattr(model_cfg, "n_heads")
             and hasattr(model_cfg, "kv_heads") else None)
    requests = traffic.sample(max_len=policy.max_len)
    replay_memo: dict[tuple, dict] = {}
    serve_memo: dict[tuple, dict | None] = {}
    predictions: list[dict] = []

    topos = expand_topologies(topo_specs, policy.slicings)
    # enumeration depends only on device count + chip kind, not slicing
    # — reuse kept plans across the slice variants of one fleet size
    plans_memo: dict[tuple, list] = {}
    for label, topo in topos:
        pk = (topo.num_devices, topo.device_kind)
        if pk not in plans_memo:
            kept, _pruned = space_mod.enumerate_candidates(
                abstract_params, topo, rules=rules,
                grad_accums=policy.grad_accums,
                max_tensor=policy.max_tensor,
                state_factor=policy.state_factor,
                batch_items=policy.batch_items, safety=policy.safety,
                zero1=policy.zero1, heads=heads)
            plans_memo[pk] = kept
        chip = topo.chip
        survival = survival_probability(
            rate_per_hour=policy.preemption_rate_per_h * topo.num_hosts,
            mission_hours=policy.mission_hours,
            max_restarts=policy.max_restarts,
            window_s=policy.restart_window_s)
        for cand in plans_memo[pk]:
            est = cost_mod.score(
                abstract_params, topo, cand, rules=rules,
                state_factor=policy.state_factor,
                batch_items=policy.batch_items, safety=policy.safety,
                measured_overlap=policy.measured_overlap, heads=heads)
            mem = est.breakdown["memory"]
            headroom = chip.hbm_bytes - mem["total_bytes"]
            mfu = (est.breakdown["flops_per_device"] / est.step_time_s
                   / chip.flops_per_s) if est.step_time_s > 0 else 0.0
            tensor = cand.full_degrees().get("tensor", 1)

            serve_est = None
            if model_cfg is not None:
                from ..analysis.serve_lint import serve_estimate

                sk = (chip, tensor)  # pool capacity is per chip kind
                if sk not in serve_memo:
                    _f, serve_memo[sk] = serve_estimate(
                        model_cfg, budget=chip.hbm_bytes,
                        block_size=policy.block_size,
                        max_len=policy.max_len, streams=policy.slots,
                        quant_kv=policy.quant_kv,
                        params_bytes=params_bytes // max(1, tensor),
                        adapters=policy.adapters or None,
                        adapter_rank=policy.adapter_rank,
                        prefix_cache=policy.prefix_cache,
                        expected_hit_rate=(
                            min(0.95, traffic.shared_prefix
                                / max(1, traffic.prompt_mean))
                            if policy.prefix_cache else 0.0),
                        degrees={"tensor": tensor})
                serve_est = serve_memo[sk]

            for adm in policy.admissions:
                pred: dict[str, Any] = {
                    "topology": label,
                    "num_devices": topo.num_devices,
                    "num_slices": topo.num_slices,
                    "num_hosts": topo.num_hosts,
                    "plan": cand.label(),
                    "strategy": cand.strategy,
                    "mesh": cand.degrees_dict,
                    "grad_accum": cand.grad_accum,
                    "zero1": bool(cand.zero1),
                    "admission": adm,
                    "step_time_s": est.step_time_s,
                    "mfu": round(mfu, 4),
                    "fits": est.fits,
                    "hbm_headroom_bytes": int(headroom),
                    "hbm_headroom_frac": round(
                        headroom / chip.hbm_bytes, 4),
                    "survival": round(survival, 4),
                    "tok_s_per_chip": None,
                    "p99_s": None,
                    "p99_admission_wait_s": None,
                    "mean_occupancy": None,
                    "preemptions": None,
                    "serve": serve_est,
                }
                if serve_est is not None and serve_est["max_streams"] > 0:
                    slots = min(policy.slots, serve_est["max_streams"])
                    kv_tok = (2 * model_cfg.n_layers
                              * model_cfg.kv_heads
                              * model_cfg.head_dim
                              * (1 if policy.quant_kv else 2))
                    if policy.decode_step_ms is not None:
                        dec_s = policy.decode_step_ms * 1e-3
                        pf_s = (policy.prefill_chunk_ms
                                or policy.decode_step_ms) * 1e-3
                    else:
                        dec_s, pf_s = _serving_times(
                            chip, params_bytes=params_bytes,
                            kv_bytes_per_step=(kv_tok * slots
                                               * policy.max_len / 2
                                               / max(1, tensor)),
                            prefill_flops_chunk=(
                                2.0 * (params_bytes / 2)
                                * (policy.prefill_chunk or
                                   traffic.prompt_mean)),
                            tensor=tensor)
                    # multi-host serving tax (measured step costs came
                    # from single-host runs, so these apply either way):
                    # a tp group wider than one host pays two network
                    # all-reduces of the [slots, d_model] activations
                    # per layer per decode step
                    dcn_s = 0.0
                    ship_s = 0.0
                    if topo.is_multislice:
                        d = getattr(model_cfg, "d_model",
                                    model_cfg.kv_heads
                                    * model_cfg.head_dim)
                        if tensor > topo.devices_per_slice:
                            step_bytes = (2 * model_cfg.n_layers
                                          * slots * d * 2)
                            dcn_s = (step_bytes / chip.dcn_bytes_per_s
                                     + 2 * model_cfg.n_layers
                                     * chip.dcn_latency_s)
                        if policy.disaggregate:
                            # a finished prompt's KV crosses hosts
                            ship_s = (kv_tok * traffic.prompt_mean
                                      / max(1, tensor)
                                      / chip.dcn_bytes_per_s
                                      + chip.dcn_latency_s)
                    rk = (adm, slots, serve_est["num_blocks"],
                          round(dec_s, 9), round(pf_s, 9),
                          policy.disaggregate, policy.prefix_cache,
                          round(ship_s, 9), round(dcn_s, 9))
                    if rk not in replay_memo:
                        replay_memo[rk] = replay_serve(
                            requests, n_slots=slots,
                            block_size=policy.block_size,
                            max_len=policy.max_len,
                            num_blocks=serve_est["num_blocks"],
                            admission=adm,
                            prefill_chunk=policy.prefill_chunk,
                            spec_lookahead=policy.spec_lookahead,
                            decode_step_s=dec_s, prefill_chunk_s=pf_s,
                            disaggregate=policy.disaggregate,
                            kv_ship_s=ship_s, dcn_step_s=dcn_s,
                            prefix_cache=policy.prefix_cache,
                            shared_prefix=traffic.shared_prefix)
                        # ``source`` is the record's one required field
                        # (obs/schema.py); the JAX package's sweep omits it
                        obs_journal.event(
                            "simulate.replay", source="sweep", admission=adm,
                            slots=slots, decode_step_ms=dec_s * 1e3,
                            disaggregate=policy.disaggregate,
                            dcn_step_ms=dcn_s * 1e3,
                            kv_ship_ms=ship_s * 1e3,
                            **{k: replay_memo[rk][k] for k in
                               ("steps", "tokens_per_s",
                                "mean_occupancy", "preemptions",
                                "stalled", "kv_ships")})
                    rep = replay_memo[rk]
                    pred.update(
                        tok_s_per_chip=round(
                            rep["tokens_per_s"] / max(1, tensor), 3),
                        fleet_tok_s=round(
                            rep["tokens_per_s"] / max(1, tensor)
                            * topo.num_devices, 1),
                        p99_s=rep["p99_s"],
                        p99_admission_wait_s=rep["p99_admission_wait_s"],
                        mean_occupancy=round(rep["mean_occupancy"], 4),
                        preemptions=rep["preemptions"],
                        replay_stalled=rep["stalled"])
                predictions.append(pred)

    ranked = slo_rank(predictions, slo)
    obs_journal.event(
        "simulate.sweep", key=key, n_topologies=len(topos),
        n_candidates=len(ranked), n_replays=len(replay_memo),
        n_slo_ok=sum(1 for p in ranked if p["slo_ok"]))
    for i, p in enumerate(ranked[:8]):
        obs_journal.event("simulate.candidate", rank=i, **{
            k: p[k] for k in (
                "topology", "plan", "admission", "mfu", "step_time_s",
                "hbm_headroom_frac", "tok_s_per_chip", "p99_s",
                "survival", "slo_ok", "slo_violations")})
    report = {
        "predictions": ranked[:policy.top_k] if policy.top_k else ranked,
        "n_candidates": len(ranked),
        "n_slo_ok": sum(1 for p in ranked if p["slo_ok"]),
        "topologies": [label for label, _ in topos],
        "traffic": dataclasses.asdict(traffic),
        "slo": dataclasses.asdict(slo),
    }
    if ranked:
        win = ranked[0]
        obs_journal.event("simulate.decision", key=key, **{
            k: win[k] for k in (
                "topology", "plan", "admission", "slo_ok",
                "slo_violations", "mfu", "tok_s_per_chip", "p99_s",
                "hbm_headroom_frac", "survival")})
    if policy.use_cache:
        try:
            cache_mod.store(key, report, path=cache_path)
        except OSError:
            pass  # read-only HOME etc. — the sweep still worked
    return {**report, "cache": "miss" if policy.use_cache else "off",
            "key": key}
