"""The port's what-if simulator (``tune/simulate.py``, with
``analysis/serve_lint.serve_estimate`` sizing the pool) against the JAX
package's, on the same inputs.

- ``TrafficMix.parse`` and ``sample`` give JAX's mixes and request lists
  for several seeded spellings;
- ``replay_serve`` drives the port's ``Scheduler``, ``BlockAllocator``
  and ``PrefixCache`` through JAX's phase order: reserve and optimistic
  admission, chunked and single-shot prefill, disaggregated steps, the
  prefix cache, a pool small enough to preempt: every output equals
  JAX's (floats within ``rel 1e-12``);
- ``replay_bench_record`` of one dict literal equals JAX's;
- ``simulate`` on GPT-2 ``test`` over ``cpu-8`` (fanned out over its
  host counts) equals JAX's report, predictions and all, within
  ``rel 1e-12``, the cache key aside, every record it journals valid
  against the event schema;
- ``tadnn simulate --json`` prints JAX's report and exits as JAX's does,
  2 for a malformed SLO or an unknown kind.
"""

import json

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.tune import (
    simulate as jsim,
)
from torch_automatic_distributed_neural_network_tpu.tune import slo as jslo
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.models import GPT2
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
    as_default,
)
from torch_automatic_distributed_neural_network_tpu_torch.planner import (
    abstract_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import (
    SLOSpec,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import (
    simulate as sim,
)

torch.set_num_threads(1)

REL = 1e-12


def assert_close(got, want, path=""):
    """Equal structures; floats within REL, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=1e-15), path
    else:
        assert got == want, path


MIXES = ("", "rate=16,n=64,prompt=128,max_new=128,decode=96",
         "rate=40,n=48,prompt=24,max_new=12,jitter=0,seed=3,shared=16",
         "rate=0,n=20,prompt=200,max_new=100,jitter=0.9,seed=7")


def test_traffic_mix_parse_and_sample_equal_jax():
    for text in MIXES:
        mix, jmix = sim.TrafficMix.parse(text), jsim.TrafficMix.parse(text)
        assert vars(mix) == vars(jmix)
        for max_len in (64, 256):
            assert mix.sample(max_len=max_len) == jmix.sample(
                max_len=max_len)
    for bad in ("rate", "bogus=1"):
        with pytest.raises(ValueError) as e:
            sim.TrafficMix.parse(bad)
        with pytest.raises(ValueError) as je:
            jsim.TrafficMix.parse(bad)
        assert str(e.value) == str(je.value)


REPLAYS = (
    dict(admission="reserve"),
    dict(admission="optimistic", num_blocks=40),
    dict(admission="optimistic", num_blocks=24, spec_lookahead=2),
    dict(admission="reserve", prefill_chunk=None),
    dict(admission="reserve", disaggregate=True, kv_ship_s=2e-4,
         dcn_step_s=1e-4),
    dict(admission="optimistic", prefix_cache=True, shared_prefix=16,
         num_blocks=48),
    dict(admission="reserve", prefix_cache=True, shared_prefix=112,
         prefill_chunks_per_step=2),
)


@pytest.mark.parametrize("kw", REPLAYS, ids=lambda kw: ",".join(kw))
def test_replay_serve_equals_jax(kw):
    shared = kw.get("shared_prefix", 0)
    mix = sim.TrafficMix.parse(
        f"rate=60,n=40,prompt=48,max_new=24,decode=16,seed=11,"
        f"shared={shared}")
    requests = mix.sample(max_len=128)
    common = dict(n_slots=4, block_size=8, max_len=128,
                  decode_step_s=2e-3, prefill_chunk_s=3e-3)
    got = sim.replay_serve(requests, **common, **kw)
    want = jsim.replay_serve(requests, **common, **kw)
    assert_close(got, want)
    assert got["n_finished"] == len(requests)


def test_replay_bench_record_equals_jax():
    extra = {"streams": 16, "new_tokens": 900, "max_new": 64,
             "prompt_len": 256, "slots": 8, "block_size": 16,
             "max_len": 1024, "admission": "optimistic",
             "prefill_chunk": 32, "speculative": 0,
             "breakdown": {"decode_step_ms": 21.5, "prefill_chunk_ms": 9.25},
             "prefix_cache": True, "shared_prefix": 64}
    assert_close(sim.replay_bench_record(extra),
                 jsim.replay_bench_record(extra))
    bare = {"streams": 4, "max_new": 8, "prompt_len": 10, "slots": 2,
            "block_size": 8}
    assert_close(sim.replay_bench_record(bare),
                 jsim.replay_bench_record(bare))


def _gpt2_test_pair():
    jm = JGPT2("test")
    import jax
    import jax.numpy as jnp

    jabs = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    with torch.device("meta"):
        pm = GPT2("test")
    return jabs, jm.cfg, abstract_params(pm), pm.cfg


@pytest.mark.parametrize("policy_kw", (
    dict(),
    dict(preemption_rate_per_h=0.2, mission_hours=48.0,
         restart_window_s=1800.0, disaggregate=True, prefix_cache=True,
         admissions=("optimistic",), grad_accums=(1, 2), top_k=0),
), ids=("default", "survival-disagg-prefix"))
def test_simulate_equals_jax(policy_kw):
    jabs, jcfg, pabs, pcfg = _gpt2_test_pair()
    traffic = "rate=24,n=48,prompt=96,max_new=32,decode=24,shared=64"
    slo = "p99_ms<=4000,headroom>=0.1"
    kw = dict(use_cache=False, batch_items=8 * 1025, **policy_kw)
    want = jsim.simulate(jabs, ["cpu-8"], model_cfg=jcfg,
                         policy=jsim.SimulatePolicy(**kw),
                         traffic=jsim.TrafficMix.parse(traffic),
                         slo=jslo.SLOSpec.parse(slo))
    jnl = Journal(validate=True)
    with as_default(jnl):
        got = sim.simulate(pabs, ["cpu-8"], model_cfg=pcfg,
                           policy=sim.SimulatePolicy(**kw),
                           traffic=sim.TrafficMix.parse(traffic),
                           slo=SLOSpec.parse(slo))
    # every record honours the event schema: the sweep's replay records
    # carry their required ``source`` (the JAX package's omit it)
    replays = jnl.named("simulate.replay")
    assert replays and {r["source"] for r in replays} == {"sweep"}
    assert got.pop("key") != want.pop("key")
    assert got["topologies"] == ["cpu-8", "cpu-4x2", "cpu-2x4", "cpu-1x8"]
    assert_close(got, want)
    assert got["predictions"] and got["cache"] == "off"


def test_cli_simulate_json_equals_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TADNN_TUNE_CACHE", str(tmp_path / "cache.jsonl"))
    argv = ["simulate", "--family", "gpt2", "--size", "test", "--seq", "64",
            "--topology", "cpu-8", "--grad-accums", "1",
            "--traffic", "rate=20,n=24,prompt=32,max_new=16",
            "--slo", "p99_ms<=5000", "--json"]

    def report(main, extra=()):
        assert main(argv + list(extra)) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    want, got = report(jcli.main), report(cli)
    assert got.pop("key") != want.pop("key")
    assert_close(got, want)
    out = tmp_path / "report.json"
    assert report(cli, ["--out", str(out)])["cache"] == "hit"
    assert json.loads(out.read_text())["cache"] == "hit"
    for bad in (["--slo", "p99_ms=>1"], ["--traffic", "bogus=2"],
                ["--topology", "tpu-8"]):
        args = argv[:-1] + bad + ["--json"]
        assert cli(args) == jcli.main(args) == 2
    capsys.readouterr()
