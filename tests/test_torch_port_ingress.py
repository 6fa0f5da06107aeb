"""The gateway's ingress half (``inference/gateway/{ingress,controller,
chaos}.py`` and ``obs/slo_monitor.py``) against the JAX package's, on the
same inputs.

- ``chaos_smoke`` (the light and the gentle scenario) and
  ``fleet_chaos``: the port's results equal JAX's, and the journals they
  write, normalised as the scenarios normalise them (the wall clock
  dropped), equal JAX's line for line; ``tadnn gateway --chaos`` prints
  JAX's line and both exit alike;
- ``Gateway`` over ``SimReplica``s on an injected clock, by a seeded
  script: token-bucket 429s and queue 503s with their Retry-After
  estimates, a killed replica's heartbeat failover, a stalled one's
  breaker and hedges, the degrade ladder shedding the batch class: every
  accepted request, every refusal, the summary, each rid's delivered
  stream and the journal equal JAX's;
- ``monitor_records`` over one gateway journal gives JAX's summary, and
  ``tadnn monitor --check`` JAX's exit codes;
- an ``HttpIngress`` round trip on the CPU: two ``EngineReplica``s over a
  GPT-2 ``test`` engine (``device="cpu"``) behind a ``Gateway``, eight
  requests POSTed at once stream exactly the tokens one engine gives the
  same prompts alone, a rate-limited tenant gets HTTP 429, a bad path
  404 and ``/healthz`` the summary.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu.inference.gateway import (
    chaos as jchaos,
)
from torch_automatic_distributed_neural_network_tpu.inference.gateway import (
    fault as jfault,
)
from torch_automatic_distributed_neural_network_tpu.inference.gateway import (
    ingress as jingress,
)
from torch_automatic_distributed_neural_network_tpu.inference.gateway import (
    router as jrouter,
)
from torch_automatic_distributed_neural_network_tpu.obs import (
    slo_monitor as jslm,
)
from torch_automatic_distributed_neural_network_tpu.obs.journal import (
    Journal as JJournal,
)
from torch_automatic_distributed_neural_network_tpu.tune import slo as jslo
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.inference import (
    gateway,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.gateway import (
    EngineReplica,
    Gateway,
    GatewayError,
    HttpIngress,
    chaos,
    fault,
    ingress,
    router,
    sse_generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    ServeEngine,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    slo_monitor,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import slo

torch.set_num_threads(1)

SIDES = {
    "jax": dict(chaos=jchaos, fault=jfault, ingress=jingress, router=jrouter,
                Journal=JJournal, slm=jslm, slo=jslo),
    "port": dict(chaos=chaos, fault=fault, ingress=ingress, router=router,
                 Journal=Journal, slm=slo_monitor, slo=slo),
}


def _records(mod, path):
    return mod["Journal"].read(str(path))


def test_gateway_exports_what_jax_does():
    from torch_automatic_distributed_neural_network_tpu.inference import (
        gateway as jgateway,
    )

    assert set(jgateway.__all__) <= set(gateway.__all__)


@pytest.fixture(scope="module")
def port_light(tmp_path_factory):
    """The port's light chaos scenario and the journal it writes (the
    monitor test reads it too)."""
    path = tmp_path_factory.mktemp("chaos") / "light.jsonl"
    return chaos.chaos_smoke(journal_path=str(path), scale="light"), path


@pytest.mark.parametrize("scale", ("light", "gentle"))
def test_chaos_smoke_equals_jax(scale, tmp_path, request):
    out = {}
    for side, mod in SIDES.items():
        path = tmp_path / f"{side}.jsonl"
        if side == "port" and scale == "light":
            result, path = request.getfixturevalue("port_light")
        else:
            result = mod["chaos"].chaos_smoke(
                journal_path=str(path), scale=scale,
                autoscale=scale != "gentle")
        out[side] = (result, mod["chaos"]._normalize(_records(mod, path)))
    (got, got_lines), (want, want_lines) = out["port"], out["jax"]
    assert got == want
    assert got["ok"] and got["deterministic"]
    assert got_lines == want_lines


def test_fleet_chaos_equals_jax(tmp_path, capsys):
    out = {}
    for side, mod in SIDES.items():
        path = tmp_path / f"{side}.jsonl"
        out[side] = (mod["chaos"].fleet_chaos(journal_path=str(path),
                                              seed=3),
                     mod["chaos"]._normalize(_records(mod, path)))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0]["ok"] and out["port"][0]["stream_parity"]
    assert out["port"][1] == out["jax"][1]
    # the plan is seeded and never faults replica0
    plan = chaos.fault_plan(3, 4)
    assert [vars(e) for e in plan] == [vars(e) for e in
                                       jchaos.fault_plan(3, 4)]
    assert all(e.replica != 0 for e in plan)
    # tadnn gateway --chaos prints the same line and exits alike; with
    # no mode it exits 2
    for argv in (["gateway", "--chaos", "--seed", "3"], ["gateway"]):
        rc = cli(argv)
        got = capsys.readouterr().out
        assert rc == jcli.main(argv) == (2 if len(argv) == 1 else 0)
        assert got == capsys.readouterr().out


def _scripted(mod, seed=7):
    """A seeded run of a ``Gateway`` over three ``SimReplica``s on a
    virtual clock: rate limits, queue limits, a kill, a stall (breaker
    and hedges), the degrade ladder.  Returns everything observable."""
    clock = [0.0]

    def now():
        return clock[0]

    jnl = mod["Journal"](None, host0_only=False, clock=now)

    def make(name):
        return mod["router"].SimReplica(
            name, n_slots=2, block_size=8, max_len=128, prefill_chunk=8,
            prefix_cache=True, clock=now, journal=jnl)

    reps = [make(f"replica{i}") for i in range(3)]
    gw = mod["ingress"].Gateway(
        reps, journal=jnl, clock=now, rate_limit_per_s=12.0, burst=2,
        queue_limit=5, heartbeat_s=0.05,
        hedge=mod["fault"].HedgePolicy(after_s=0.12,
                                       max_hedges_per_request=1),
        breaker=mod["fault"].BreakerPolicy(window_s=0.1, min_observations=5,
                                           failure_rate=0.5, open_s=0.3,
                                           clean_s=0.1),
        step_costs=(5e-3, 5e-3))
    rs = np.random.RandomState(seed)
    plan, t = [], 0.0
    for i in range(90):
        t += float(rs.exponential(1 / 60.0))
        n = int(rs.randint(10, 30))
        prompt = [1] * 8 + [int(x) for x in rs.randint(2, 100, size=n - 8)]
        plan.append((t, f"t{i % 3}", prompt, int(rs.randint(4, 12)),
                     "batch" if i % 4 == 3 else "interactive"))
    events = [(0.35, lambda: reps[1].kill()),
              (0.5, lambda: setattr(reps[2], "stalled", True)),
              (0.8, lambda: gw.set_degrade(2, reason="script")),
              (1.0, lambda: setattr(reps[2], "stalled", False)),
              (1.3, lambda: gw.set_degrade(0, reason="script"))]
    outcomes, expected = [], {}
    i = e = 0
    while clock[0] < 6.0 and (i < len(plan) or e < len(events)
                              or not gw.idle() or gw._meta):
        now_t = clock[0]
        while e < len(events) and events[e][0] <= now_t:
            events[e][1]()
            e += 1
        while i < len(plan) and plan[i][0] <= now_t:
            _, tenant, prompt, max_new, prio = plan[i]
            try:
                req = gw.submit(prompt, max_new, tenant=tenant,
                                priority=prio, eos_id=0, n_decode=max_new)
                expected[req.rid] = max_new
                outcomes.append(("ok", req.rid))
            except mod["ingress"].GatewayError as err:
                outcomes.append((type(err).__name__, err.status,
                                 round(err.retry_after, 9), str(err)))
            i += 1
        gw.step()
        clock[0] = now_t + 5e-3
    streams = {rid: gw.delivered(rid) for rid in expected}
    return (outcomes, gw.summary(), streams,
            mod["chaos"]._normalize(list(jnl.records)))


def test_gateway_on_sim_replicas_equals_jax():
    got, want = _scripted(SIDES["port"]), _scripted(SIDES["jax"])
    outcomes, summary, streams, lines = got
    assert outcomes == want[0]
    assert summary == want[1]
    assert streams == want[2]
    assert lines == want[3]
    kinds = {o[0] for o in outcomes}
    assert {"ok", "RateLimited", "Saturated"} <= kinds
    assert summary["failovers"] >= 1 and summary["hedges"] >= 1
    names = {json.loads(line)["name"] for line in lines}
    assert {"gateway.degrade", "gateway.restore", "gateway.failover",
            "gateway.hedge", "gateway.reject"} <= names
    # every accepted stream completed, ending in the emulated EOS
    assert all(s and s[-1] == 0 for s in streams.values())


def test_monitor_records_and_cli_equal_jax(port_light, tmp_path, capsys):
    path = port_light[1]
    records = Journal.read(str(path))
    for spec, window in (("p99_ms<=2500", 1.0), ("ttft_ms<=500", 0.5),
                         ("", 2.0)):
        kw = dict(window_s=window, breach_after=2, recover_after=2)
        got = slo_monitor.monitor_records(
            records, slo_monitor.MonitorPolicy(
                slo=slo.SLOSpec.parse(spec), **kw), journal=Journal())
        want = jslm.monitor_records(
            records, jslm.MonitorPolicy(slo=jslo.SLOSpec.parse(spec), **kw),
            journal=JJournal())
        assert got == want
        assert slo_monitor.format_summary(got) == jslm.format_summary(want)
    assert got["overall"]["n_done"] > 0
    extra = {"streams": 8, "new_tokens": 96, "max_new": 12,
             "prompt_len": 24, "slots": 4, "block_size": 8}
    assert slo_monitor.drift_check(50.0, extra, journal=Journal()) == (
        jslm.drift_check(50.0, extra, journal=JJournal()))
    drift = tmp_path / "bench.json"
    drift.write_text(json.dumps({"extra": extra}))
    for argv in ([str(path), "--json"],
                 [str(path), "--slo", "p99_ms<=2500", "--check", "--json"],
                 [str(path), "--slo", "p99_ms<=1e9", "--check",
                  "--drift", str(drift), "--json"],
                 [str(path), "--slo", "bogus<=1"],
                 [str(tmp_path / "missing.jsonl")],
                 [str(path), "--follow", "--replay"]):
        rc = cli(["monitor", *argv])
        got = capsys.readouterr().out
        assert rc == jcli.main(["monitor", *argv])
        want = capsys.readouterr().out
        assert got == want, argv


def _engine(model):
    return ServeEngine(model, n_slots=4, max_len=96, block_size=8,
                       prefix_cache=True, device="cpu")


def test_http_ingress_round_trip_on_cpu():
    cfg = gpt2_config("test", n_layers=2, vocab_size=128, max_seq_len=96,
                      dtype=torch.float32)
    model = DecoderLM(cfg).init_weights(torch.Generator().manual_seed(1))
    rs = np.random.RandomState(5)
    shared = [int(t) for t in rs.randint(1, 128, size=16)]
    prompts = [shared + [int(t) for t in rs.randint(1, 128, size=8)]
               for _ in range(8)]
    reps = [EngineReplica(f"replica{i}", _engine(model)) for i in range(2)]
    gw = Gateway(reps, journal=Journal(), rate_limit_per_s=1e-3, burst=8)
    slow = gw._bucket("slow")
    slow.burst = slow.tokens = 1.0
    out = {"frames": []}

    async def drive():
        ing = HttpIngress(gw, host="127.0.0.1", port=0)
        await ing.start()
        try:
            out["streams"] = await asyncio.gather(*(
                asyncio.to_thread(sse_generate, "127.0.0.1", ing.port, {
                    "prompt": p, "max_new_tokens": 6, "tenant": "a"})
                for p in prompts))
            out["slow"] = await asyncio.to_thread(
                sse_generate, "127.0.0.1", ing.port,
                {"prompt": prompts[0], "max_new_tokens": 2,
                 "tenant": "slow"}, on_event=out["frames"].append)
            try:
                await asyncio.to_thread(
                    sse_generate, "127.0.0.1", ing.port,
                    {"prompt": prompts[0], "max_new_tokens": 2,
                     "tenant": "slow"})
            except GatewayError as e:
                out["429"] = (str(e), e.status, e.retry_after)
            out["health"] = await asyncio.to_thread(_get, ing.port,
                                                    "/healthz")
            out["404"] = await asyncio.to_thread(_get, ing.port, "/nope")
        finally:
            await ing.stop()

    asyncio.run(drive())
    ref = _engine(model)
    alone = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ref.run()
    for events, req in zip(out["streams"], alone):
        toks = [e for e in events if "token" in e]
        assert [e["i"] for e in toks] == list(range(6))
        assert [e["token"] for e in toks] == req.out_tokens
        assert events[-1]["done"] and events[-1]["usage"]["n_new"] == 6
    assert out["slow"][-1]["done"] and out["frames"] == out["slow"]
    msg, status, retry_after = out["429"]
    assert msg.startswith("HTTP 429") and status == 429
    assert retry_after == 1000.0  # one token at the 1e-3/s refill
    status, body = out["health"]
    assert status == 200 and body["ok"] and body["accepted"] == 9
    assert body["rejected"] == 1 and body["router"]["n_routed"] == 9
    assert out["404"][0] == 404


def _get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()
