"""The serving gateway's ported layers (``inference/gateway/{router,
fault,doctor}.py``) against the JAX package's, on the same inputs.

- ``SimReplica`` + ``Router``: a seeded trace of 64 requests (eight
  tenants' shared 16-token preambles and unique tails, 2-6 new tokens)
  over three replicas on an injected clock, under both policies and
  with a heartbeat check; replica 1 is killed after request 24, drained
  after request 40 (its requests resubmitted on the others, keeping
  their identity) and forgotten.  Every placement, ``Router.stats()``,
  every finished request's rid, tokens and timestamps and the journal's
  records (less the journal's own clock stamps) equal JAX's exactly.
- ``CircuitBreaker``: a seeded ok/fail script with ticks on an injected
  clock: the state after every call, the transitions and the journaled
  records equal JAX's; ``shed_threshold`` / ``degrade_effects`` equal
  JAX's at every level for several class tables.
- ``EngineReplica`` over the port's CPU ``ServeEngine`` (GPT-2 ``test``,
  2 layers, fp32, prefix cache on) behind a ``Router(policy=
  "affinity")`` gated by a breaker per replica: the later requests of a
  prefix group land on the replica that prefilled it and hit its cache,
  replica B's breaker opened by ``observe(False)`` keeps new requests
  off it, B is drained and its requests finish on A; every request
  finishes once with all its tokens, and those that never moved equal a
  single engine's tokens exactly.
- ``gateway_doctor`` on a hand-written journal (and its rotated
  generation) holding every event it reads returns JAX's dict, and
  ``format_gateway_doctor`` JAX's text; ``tadnn doctor --gateway-dir``
  prints it as JSON with JAX's exit codes.
"""

import json
import types

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference.gateway import (
    doctor as jdoctor,
)
from torch_automatic_distributed_neural_network_tpu.inference.gateway import (
    fault as jfault,
)
from torch_automatic_distributed_neural_network_tpu.inference.gateway import (
    router as jrouter,
)
from torch_automatic_distributed_neural_network_tpu.obs.journal import (
    Journal as JJournal,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.inference.gateway import (
    BreakerPolicy,
    CircuitBreaker,
    EngineReplica,
    NoHealthyReplica,
    Router,
    degrade_effects,
    doctor,
    fault,
    router,
    shed_threshold,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    ServeEngine,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
)

JAX = types.SimpleNamespace(router=jrouter, fault=jfault, Journal=JJournal)
PORT = types.SimpleNamespace(router=router, fault=fault, Journal=Journal)


def _trace(seed=5, n=64):
    rs = np.random.RandomState(seed)
    preambles = [list(rs.randint(1, 100, size=16)) for _ in range(8)]
    out = []
    for i in range(n):
        g = rs.randint(8)
        tail = list(rs.randint(100, 200, size=rs.randint(2, 12)))
        out.append(([int(t) for t in preambles[g] + tail],
                    int(rs.randint(2, 7))))
    return out


def _fleet_run(ns, policy):
    """The trace through ``ns``'s router over three SimReplicas: what was
    placed where, the stats, the finished requests and the journal."""
    clock = [0.0]
    jnl = ns.Journal(None, host0_only=False)
    reps = [ns.router.SimReplica(f"replica{i}", n_slots=3, block_size=8,
                                 max_len=64, prefill_chunk=8,
                                 clock=lambda: clock[0], journal=jnl)
            for i in range(3)]
    rt = ns.router.Router(reps, block_size=8, policy=policy,
                          heartbeat_s=0.05, clock=lambda: clock[0],
                          journal=jnl)
    placed, finished = [], []

    def tick():
        for r in reps:
            r.step()
            finished.extend(r.take_finished())
        clock[0] += 0.004

    for i, (prompt, new) in enumerate(_trace()):
        if i == 24:
            reps[1].kill()
        if i == 40:
            for req in reps[1].drain():
                target = rt.route(req.prompt)
                target.resubmit(req)
                placed.append(("resubmit", req.rid, target.name))
            rt.forget("replica1")
        rep = rt.route(prompt)
        rep.submit(prompt, new, eos_id=0, n_decode=new - 1, rid=1000 + i)
        placed.append((i, rep.name))
        tick()
    while any(not r.idle() for r in reps if r.alive):
        tick()
    done = [(r.rid, list(r.out_tokens), r.t_submit, r.t_done)
            for r in finished]
    # the journal's own stamps read the process clock; every field the
    # replicas fill reads the injected one
    records = [{k: v for k, v in r.items() if k not in ("t", "wall")}
               for r in jnl.records]
    return placed, rt.stats(), sorted(done), records, reps


@pytest.mark.parametrize("policy", ["affinity", "least_loaded"])
def test_router_places_the_trace_as_jax(policy):
    want = _fleet_run(JAX, policy)
    got = _fleet_run(PORT, policy)
    assert got[0] == want[0]  # every placement, resubmissions included
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(got[3]) == len(want[3]) and got[3] == want[3]
    reps = got[4]
    # the killed replica's requests never finished; everyone else's did
    # once, and after the drain nothing landed on it again
    stranded = {r.rid for r in reps[1].scheduler.queue}
    assert not stranded
    rids = [d[0] for d in got[2]]
    assert len(rids) == len(set(rids))
    drained = next(i for i, p in enumerate(got[0]) if p[0] == "resubmit")
    assert not any(p[-1] == "replica1" for p in got[0][drained:])
    if policy == "affinity":
        assert got[1]["n_affinity"] > 0 and got[1]["n_decayed"] > 0
    for ns in (PORT, JAX):
        reps = [ns.router.SimReplica("r0", clock=lambda: 0.0)]
        reps[0].retired = True
        with pytest.raises(ns.router.NoHealthyReplica):
            ns.router.Router(reps, block_size=8).route([1] * 8)
    with pytest.raises(ValueError):
        Router([], block_size=8, policy="round_robin")
    assert NoHealthyReplica is router.NoHealthyReplica


def _breaker_run(ns, seed=3):
    clock = [0.0]
    jnl = ns.Journal(None, host0_only=False)
    br = ns.fault.CircuitBreaker(
        "r0", ns.fault.BreakerPolicy(window_s=0.2, min_observations=4,
                                     failure_rate=0.5, open_s=0.3,
                                     clean_s=0.1),
        clock=lambda: clock[0], journal=jnl)
    rs = np.random.RandomState(seed)
    states = []
    for _ in range(400):
        clock[0] += float(rs.exponential(0.02))
        if rs.rand() < 0.3:
            br.tick()
        else:
            br.observe(bool(rs.rand() < 0.55))
        states.append((br.state, br.allow()))
    records = [{k: v for k, v in r.items() if k not in ("t", "wall")}
               for r in jnl.records]
    return states, br.transitions, br.n_opens, records


def test_circuit_breaker_and_ladder_match_jax():
    want, got = _breaker_run(JAX), _breaker_run(PORT)
    assert got == want
    assert {s for s, _ in got[0]} == {"closed", "open", "half_open"}
    assert got[2] >= 2
    for classes in ([0, 1], [0], [0, 1, 2, 3], [3, 1, 1, 0], []):
        for level in range(-1, 6):
            assert shed_threshold(level, classes) == jfault.shed_threshold(
                level, classes)
            assert degrade_effects(level, classes) == jfault.degrade_effects(
                level, classes)
    assert fault.HedgePolicy() == fault.HedgePolicy(
        **vars(jfault.HedgePolicy()))
    assert vars(BreakerPolicy()) == vars(jfault.BreakerPolicy())


# -- the real engine behind the replica protocol --------------------------


CFG = dict(n_layers=2, vocab_size=128, max_seq_len=128, dtype=torch.float32)
ENGINE = dict(n_slots=4, max_len=128, block_size=8, prefill_chunk=8,
              cache_dtype=torch.float32, prefix_cache=True, device="cpu")


def _groups(seed=9, n_groups=4, per=3):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_groups):
        shared = [int(t) for t in rs.randint(1, 128, size=16)]
        out.append([shared + [int(t) for t in rs.randint(1, 128, size=8)]
                    for _ in range(per)])
    return out


def _step_until(replicas, cond, limit=500):
    for _ in range(limit):
        if cond():
            return
        for r in replicas:
            r.step()
    raise AssertionError("the replicas did not get there")


def test_engine_replicas_route_drain_and_fail_over(tmp_path):
    torch.manual_seed(0)
    model = DecoderLM(gpt2_config("test", **CFG))
    model.init_weights(torch.Generator().manual_seed(0))
    jnl = Journal(str(tmp_path / "journal.jsonl"), host0_only=False,
                  validate=True)
    clock = [0.0]
    reps = [EngineReplica(name, ServeEngine(model, journal=jnl, **ENGINE),
                          clock=lambda: clock[0]) for name in "AB"]
    breakers = {r.name: CircuitBreaker(
        r.name, BreakerPolicy(min_observations=3, open_s=60.0),
        clock=lambda: clock[0], journal=jnl) for r in reps}
    rt = Router(reps, block_size=8, policy="affinity",
                gate=lambda r: breakers[r.name].allow(),
                clock=lambda: clock[0], journal=jnl)
    groups = _groups()
    reqs, where, moved = {}, {}, set()

    def submit(g, j):
        rep = rt.route(groups[g][j])
        req = rep.submit(groups[g][j], 6)
        reqs[(g, j)], where[(g, j)] = req, rep.name
        return req

    # groups 0 and 1: the first request prefills, then the rest follow
    for g in (0, 1):
        first = submit(g, 0)
        _step_until(reps, lambda: first.t_first_token is not None)
        for j in (1, 2):
            submit(g, j)
    assert [where[(g, 0)] for g in (0, 1)] == ["A", "B"]
    _step_until(reps, lambda: any(r.state == "running" and r.n_generated > 1
                                  for k, r in reqs.items() if k[0] == 1))
    # B stops making progress (from here on only A steps): its breaker
    # opens and new work avoids it
    for _ in range(3):
        breakers["B"].observe(False)
    assert breakers["B"].state == "open"
    for g in (2, 3):
        first = submit(g, 0)
        _step_until(reps[:1], lambda: first.t_first_token is not None)
        for j in (1, 2):
            submit(g, j)
    assert all(where[(g, j)] == "A" for g in (2, 3) for j in range(3))
    # drain B onto A
    b = reps[1]
    for req in b.drain():
        moved.add(req.rid)
        reps[0].resubmit(req)
    released = rt.forget("B")
    assert moved and released > 0 and b.retired
    assert rt.healthy() == [reps[0]]
    _step_until(reps, lambda: all(r.idle() for r in reps))
    finished = reps[0].take_finished() + b.take_finished()
    rids = [r.rid for r in finished]
    assert sorted(rids) == sorted(r.rid for r in reqs.values())
    assert all(len(r.out_tokens) == 6 for r in finished)
    stats = rt.stats()
    assert stats["n_routed"] == 12 and stats["n_affinity"] == 8
    assert reps[0].prefix_stats()["hit_requests"] >= 6
    # tokens: one engine serving the same prompts alone
    ref = ServeEngine(model, **ENGINE)
    alone = {k: ref.submit(p, 6) for k, p in (
        ((g, j), groups[g][j]) for g in range(4) for j in range(3))}
    ref.run()
    for k, req in reqs.items():
        if req.rid not in moved:
            assert req.out_tokens == alone[k].out_tokens, k
    jnl.close()
    recs = Journal.read(str(tmp_path / "journal.jsonl"))
    done = [r["rid"] for r in recs if r["name"] == "serve.request_done"]
    assert sorted(done) == sorted(rids)
    # the later requests of a group that stayed put hit the cache of
    # its first's replica
    hits = {r["rid"]: r["cached_tokens"] for r in recs
            if r["name"] == "serve.prefix" and r.get("kind") == "match"
            and r["hit"]}
    stayed = [req.rid for (g, j), req in reqs.items()
              if j and req.rid not in moved]
    assert len(stayed) >= 6 and all(hits.get(rid) == 16 for rid in stayed)
    doc = doctor.gateway_doctor(str(tmp_path))
    assert doc["ok"] and doc["breaker_transitions"] == [
        {"t": doc["breaker_transitions"][0]["t"], "replica": "B",
         "from": "closed", "to": "open"}]
    assert doc["culprit"]["replica"] == "B"


# -- the doctor ---------------------------------------------------------------


def _doctor_journal(directory):
    """Every event the doctor reads, in a current and a rotated file."""
    def rec(t, name, **kw):
        return json.dumps({"name": name, "t": t, "wall": 1e9 + t, **kw})

    old = [rec(0.1, "serve.step", replica="r0"),
           rec(0.2, "gateway.request", rid=1, tenant="t0", replica="r0"),
           rec(0.3, "gateway.request", rid=2, tenant="t1", replica="r1"),
           rec(0.35, "gateway.request", rid=3, tenant="t1", replica="r1")]
    cur = [rec(0.4, "serve.step", replica="r1"),
           rec(0.5, "chaos.fault", kind="stall", replica="r1"),
           rec(0.6, "gateway.breaker", replica="r1", **{"from": "closed",
                                                        "to": "open"}),
           rec(0.7, "gateway.failover", kind="requeue", replica="r1",
               reason="heartbeat", n_requeued=2, rids=[2, 3]),
           rec(0.71, "gateway.failover", kind="parked", rid=3),
           rec(0.8, "gateway.hedge", kind="dispatch", rid=1),
           rec(0.85, "gateway.hedge", kind="win", rid=1, winner="hedge"),
           rec(0.86, "gateway.hedge", kind="win", rid=2, winner="primary"),
           rec(0.9, "gateway.reject", kind="rate_limit"),
           rec(0.91, "gateway.reject", kind="rate_limit"),
           rec(0.92, "gateway.reject", kind="backpressure"),
           rec(1.0, "gateway.degrade", level=2, prev=1, reason="breach",
               shed_classes=[1]),
           rec(1.1, "gateway.restore", level=0, prev=2, reason="recovered",
               shed_classes=[]),
           rec(1.2, "serve.step", replica="r0"),
           rec(1.3, "serve.request_done", rid=1),
           rec(1.4, "serve.request_done", rid=2),
           '{"name": "serve.step", "t": 1.5, "rep']  # a torn last line
    (directory / "gateway.jsonl.1").write_text("\n".join(old) + "\n")
    (directory / "gateway.jsonl").write_text("\n".join(cur))


def test_gateway_doctor_matches_jax(tmp_path, capsys):
    _doctor_journal(tmp_path)
    with pytest.warns(UserWarning):
        got = doctor.gateway_doctor(str(tmp_path))
    want = jdoctor.gateway_doctor(str(tmp_path))
    assert got == want
    assert got["lost_rids"] == [3] and got["ok"] is False
    assert got["rotated_generation"] and got["culprit"]["how"] == (
        "fault:stall")
    assert doctor.format_gateway_doctor(got) == (
        jdoctor.format_gateway_doctor(want))
    # the CLI: JSON out, exit 1 on a lost request, as JAX's
    capsys.readouterr()
    assert cli(["doctor", "--gateway-dir", str(tmp_path), "--json"]) == 1
    assert json.loads(capsys.readouterr().out) == want
    assert cli(["doctor", "--gateway-dir",
                str(tmp_path / "gateway.jsonl")]) == 1
    assert "cohort broken first by: r1" in capsys.readouterr().out
    missing = doctor.gateway_doctor(str(tmp_path / "nowhere"))
    assert missing == jdoctor.gateway_doctor(str(tmp_path / "nowhere"))
    assert doctor.format_gateway_doctor(missing) == (
        jdoctor.format_gateway_doctor(missing))
