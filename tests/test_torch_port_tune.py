"""The port's tuner (``tune/{space,cost,cache,tuner}.py``, the pure half of
``obs/trace.py``, ``training/resilience``'s survival math and ``tadnn
tune``) against the JAX package's, on the same inputs.

Models are the ``test`` presets of GPT-2, Llama (GQA) and MoE: meta
tensors on the port's side (``planner.abstract_params``), ``jax.eval_shape``
of the default (layer-scanned) modules on JAX's.  Topologies: ``cpu-8``
and ``cpu-4x2`` (``parse_topology`` on both sides), and an 8-card and a
4 x 8-card H100 fleet given to both sides as the same ``ChipSpec``
through ``chip_override``.  On every model and topology:

- ``enumerate_candidates`` keeps and prunes the same candidates, at the
  default batch and at one that prunes by memory;
- ``candidate_memory`` and ``score`` equal JAX's per candidate: bytes
  exactly, times within ``rel 1e-12`` (the port charges JAX's layout:
  ``space.charge_view``);
- ``rank``'s order and ``tune``'s decision (the cache off) equal JAX's.

One departure is held too: the port splits q/k/v by whole heads, so it
prunes a tensor degree that does not divide both head counts (Llama's 2
kv heads under ``tensor`` 4, GPT-2's 4 or 12 heads under ``tensor`` 8),
where JAX keeps it; its lists and decisions are JAX's with those
candidates taken out, and ``make_plan(strategy="tuned")`` builds the plan
it picks on every fleet here.

``window_budget_exhausted``, ``survival_probability`` and
``exposed_fraction`` give JAX's values exactly on seeded inputs; the
cache's round trip, invalidation and last-match-wins behave as in JAX's
``tests/test_tune.py`` (the port's key digests its own parameter names,
so it never equals JAX's); ``tadnn tune --json`` on the CPU prints JAX's
rows (the cache key aside) for the 8-device topology JAX's tests run on.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu import core as jcore
from torch_automatic_distributed_neural_network_tpu import topology as jtopo
from torch_automatic_distributed_neural_network_tpu import tune as jtune
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.models import Llama as JLlama
from torch_automatic_distributed_neural_network_tpu.models import MoE as JMoE
from torch_automatic_distributed_neural_network_tpu.obs import trace as jtrace
from torch_automatic_distributed_neural_network_tpu.training import (
    resilience as jres,
)
from torch_automatic_distributed_neural_network_tpu_torch import AutoDistribute
from torch_automatic_distributed_neural_network_tpu_torch import planner
from torch_automatic_distributed_neural_network_tpu_torch import topology
from torch_automatic_distributed_neural_network_tpu_torch import tune
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    GPT2,
    Llama,
    MoE,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import trace
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
    as_default,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    resilience,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import (
    cache as tune_cache,
)

torch.set_num_threads(1)

REL = 1e-12
FAMILIES = {"gpt2": (JGPT2, GPT2), "llama": (JLlama, Llama),
            "moe": (JMoE, MoE)}
# NVIDIA's H100 SXM data sheet, as the port's topology table has it
H100 = dict(flops_per_s=989.4e12, hbm_bytes=80 * 10**9,
            hbm_bytes_per_s=3.35e12, ici_bytes_per_s=450e9,
            dcn_bytes_per_s=50e9)
TOPOLOGIES = ("cpu-8", "cpu-4x2", "h100-8", "h100-8x4")


@functools.lru_cache(maxsize=None)
def models(family):
    """(jax abstract params, port abstract params, port heads)."""
    jcls, pcls = FAMILIES[family]
    jm = jcls("test")
    jabs = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    with torch.device("meta"):
        pm = pcls("test")
    return jabs, planner.abstract_params(pm), (pm.cfg.n_heads,
                                               pm.cfg.kv_heads)


def topologies(name):
    """The same fleet for both packages."""
    if name.startswith("cpu"):
        return jtopo.parse_topology(name), topology.parse_topology(name)
    per, _, hosts = name.partition("-")[2].partition("x")
    kw = dict(num_devices=int(per) * int(hosts or 1),
              num_hosts=int(hosts or 1), platform="gpu", device_kind="h100",
              num_slices=int(hosts or 1), devices_per_slice=int(per))
    return (jtopo.Topology(chip_override=jtopo.ChipSpec(**H100), **kw),
            topology.Topology(chip_override=topology.ChipSpec(**H100), **kw))


def port_cand(c):
    return tune.Candidate(c.strategy, c.degrees, c.grad_accum, c.zero1)


def port_builds(c, heads):
    """Whether the port's whole-head split takes ``c``'s tensor degree
    (the space prunes it otherwise; JAX keeps it)."""
    t = dict(c.degrees).get("tensor", 1)
    return heads[0] % t == 0 and heads[1] % t == 0


def port_decision(jr, heads):
    """JAX's ``TuneResult`` as the port decides: the best of JAX's
    ranking that the port builds (JAX's fallback stays)."""
    if jr.source != "cost_model":
        return (jr.strategy, jr.degrees, jr.grad_accum, jr.zero1, jr.source)
    builds = [e.candidate for e in jr.ranked if port_builds(e.candidate,
                                                             heads)]
    assert len(builds) > 1  # else the port falls back where JAX ranks
    c = builds[0]
    return (c.strategy, c.degrees_dict, c.grad_accum, c.zero1, "cost_model")


def assert_close(got, want, path=""):
    """Equal structures; floats within REL, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=1e-15), path
    else:
        assert got == want, path


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("topo_name", TOPOLOGIES)
def test_space_and_cost_equal_jax(family, topo_name):
    jabs, pabs, heads = models(family)
    jt, pt = topologies(topo_name)
    # the default batch, and larger ones whose activations prune
    # candidates (the tensor-parallel ones first: fewer batch shards)
    for items in (4096, 1 << 19, 1 << 22):
        kw = dict(grad_accums=(1, 2), batch_items=items)
        jkept, jpruned = jtune.enumerate_candidates(jabs, jt, **kw)
        kept, pruned = tune.enumerate_candidates(pabs, pt, heads=heads,
                                                 **kw)
        builds = functools.partial(port_builds, heads=heads)
        assert [c.label() for c in kept] == [
            c.label() for c in jkept if builds(c)]
        assert [(c, why) for c, why in pruned if builds(c)] == [
            (port_cand(c), why) for c, why in jpruned if builds(c)]
        jall = jkept + [c for c, _ in jpruned]
        refused = [(c, why) for c, why in pruned if not builds(c)]
        assert sorted(c.label() for c, _ in refused) == sorted(
            c.label() for c in jall if not builds(c))
        assert all(why.startswith("heads: tensor degree ")
                   for _, why in refused)
        for jc in jall:
            assert tune.space.candidate_memory(
                pabs, port_cand(jc), batch_items=items, heads=heads) == (
                jtune.space.candidate_memory(jabs, jc, batch_items=items))
        jranked = jtune.rank(jabs, jt, jkept, batch_items=items)
        ranked = tune.rank(pabs, pt, kept, batch_items=items, heads=heads)
        jranked = [e for e in jranked if builds(e.candidate)]
        assert [e.candidate.label() for e in ranked] == [
            e.candidate.label() for e in jranked]
        for got, want in zip(ranked, jranked):
            assert got.fits == want.fits
            assert got.step_time_s == pytest.approx(want.step_time_s,
                                                    rel=REL)
            assert_close(got.to_json(), want.to_json())
    # a measured overlap scales the comm term alike
    jc = jtune.enumerate_candidates(jabs, jt)[0][-1]
    assert_close(
        tune.score(pabs, pt, port_cand(jc), heads=heads,
                   measured_overlap=0.3).to_json(),
        jtune.score(jabs, jt, jc, measured_overlap=0.3).to_json())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tune_decision_equals_jax(family):
    jabs, pabs, heads = models(family)
    for topo_name in TOPOLOGIES:
        jt, pt = topologies(topo_name)
        for ga in ((1,), (1, 2, 4)):
            jr = jtune.tune(jabs, jt, policy=jtune.TunePolicy(
                grad_accums=ga, use_cache=False))
            r = tune.tune(pabs, pt, heads=heads, policy=tune.TunePolicy(
                grad_accums=ga, use_cache=False))
            assert (r.strategy, r.degrees, r.grad_accum, r.zero1,
                    r.source) == port_decision(jr, heads)
    # one device: both fall back to the auto heuristic
    jr = jtune.tune(jabs, jtopo.parse_topology("cpu-1"),
                    policy=jtune.TunePolicy(use_cache=False))
    jnl = Journal()
    with as_default(jnl):
        r = tune.tune(pabs, topology.parse_topology("cpu-1"), heads=heads,
                      policy=tune.TunePolicy(use_cache=False))
    assert (r.strategy, r.degrees, r.source) == (jr.strategy, jr.degrees,
                                                 "fallback")
    assert [x["name"] for x in jnl.records[1:]] == ["tune.fallback"]


@pytest.mark.parametrize("family,size,topo_name", [
    ("gpt2", "small", "h100-16"), ("gpt2", "test", "h100-8x4"),
    ("llama", "test", "cpu-8")])
def test_tuned_make_plan_builds_what_jax_would_split(family, size,
                                                     topo_name):
    """Fleets where JAX's space keeps a tensor degree that does not
    divide the head counts (GPT-2 small's 12 heads under 8, GPT-2
    test's 4 under 8, Llama test's 2 kv heads under 4): the port's
    tuned plan is the best of JAX's ranking that it builds, and
    ``make_plan`` builds it."""
    jcls, pcls = FAMILIES[family]
    jabs = jax.eval_shape(lambda: jcls(size).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    with torch.device("meta"):
        pm = pcls(size)
    pabs, heads = planner.abstract_params(pm), (pm.cfg.n_heads,
                                                pm.cfg.kv_heads)
    jt, pt = topologies(topo_name)
    jr = jtune.tune(jabs, jt, policy=jtune.TunePolicy(use_cache=False))
    assert not all(port_builds(e.candidate, heads) for e in jr.ranked)
    policy = tune.TunePolicy(use_cache=False)
    plan = planner.make_plan(pabs, topology=pt, strategy="tuned",
                             heads=heads, tune_policy=policy)
    strategy, degrees, _, zero1, _ = port_decision(jr, heads)
    assert (plan.strategy, plan.zero1) == (strategy, zero1)
    assert {a: n for a, n in plan.degrees.items() if n > 1} == {
        a: n for a, n in degrees.items() if n > 1}
    assert port_builds(tune.Candidate(strategy, tuple(degrees.items())),
                       heads)


def test_survival_and_exposed_fraction_equal_jax():
    rs = np.random.RandomState(17)
    for _ in range(40):
        times = sorted(rs.uniform(0, 7200, size=rs.randint(0, 9)).tolist())
        kw = dict(max_restarts=int(rs.randint(0, 4)),
                  window_s=float(rs.choice([60.0, 600.0, 3600.0])))
        assert resilience.window_budget_exhausted(times, **kw) == (
            jres.window_budget_exhausted(times, **kw))
    for rate, hours, window, seed in ((0.0, 24, 3600, 0), (0.5, 24, 3600, 0),
                                      (0.05, 24, 7 * 86400, 0),
                                      (2.0, 12, 1800, 3), (0.3, 48, 600, 9)):
        kw = dict(rate_per_hour=rate, mission_hours=hours,
                  window_s=window, seed=seed, samples=512)
        assert resilience.survival_probability(**kw) == (
            jres.survival_probability(**kw))
    steps = [{"collective_s": float(c), "exposed_collective_s": float(e)}
             for c, e in rs.uniform(0, 1, size=(6, 2))]
    for recs in (steps, steps[:1], [], [{"collective_s": 0.0}]):
        assert trace.exposed_fraction(recs) == jtrace.exposed_fraction(recs)
    assert tune.cost.overlap_from_trace(steps) == (
        jtune.cost.overlap_from_trace(steps))
    # the interval attribution on a hand-made timeline (microseconds)
    parsed = {"steps": [{"step": 0, "ts": 0.0, "dur": 100.0},
                        {"step": 1, "ts": 100.0, "dur": 50.0}],
              "ops": [{"name": "fusion.1", "ts": 0.0, "dur": 40.0},
                      {"name": "all-reduce-start.2", "ts": 30.0,
                       "dur": 30.0},
                      {"name": "all-gather.3", "ts": 90.0, "dur": 30.0},
                      {"name": "dot.4", "ts": 110.0, "dur": 5.0}]}
    kw = dict(flops_per_step=1e6, peak_flops_per_chip=1e9, n_chips=2)
    assert trace.attribute(parsed, **kw) == jtrace.attribute(parsed, **kw)
    assert [trace.is_collective(o["name"]) for o in parsed["ops"]] == [
        jtrace.is_collective(o["name"]) for o in parsed["ops"]]


def test_cache_roundtrip_invalidation_and_last_match(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    _, pabs, _ = models("gpt2")
    sig = tune_cache.params_signature(pabs)
    assert sig == tune_cache.params_signature(dict(reversed(pabs.items())))
    _, pt = topologies("h100-8")
    fp = tune_cache.topology_fingerprint(pt)
    pol = tune.TunePolicy()
    key = tune_cache.cache_key(sig, fp, pol)
    assert key == tune_cache.cache_key(sig, dict(fp), tune.TunePolicy())
    assert tune_cache.lookup(key, path=path) is None
    tune_cache.store(key, {"strategy": "dp", "degrees": {"data": 8}},
                     path=path)
    assert tune_cache.lookup(key, path=path) == {
        "strategy": "dp", "degrees": {"data": 8}}
    # a shape, a dtype, the topology and the policy each change the key
    name = "layers.0.mlp.up_proj.weight"
    reshaped = {**pabs, name: torch.empty(64, 128, device="meta")}
    recast = {**pabs, name: pabs[name].to(torch.bfloat16)}
    other = tune_cache.topology_fingerprint(topologies("h100-8x4")[1])
    for k in (tune_cache.cache_key(tune_cache.params_signature(reshaped),
                                   fp, pol),
              tune_cache.cache_key(tune_cache.params_signature(recast),
                                   fp, pol),
              tune_cache.cache_key(sig, other, pol),
              tune_cache.cache_key(sig, fp, tune.TunePolicy(top_k=5)),
              tune_cache.cache_key(sig, fp, tune.TunePolicy(zero1=False))):
        assert k != key and tune_cache.lookup(k, path=path) is None
    # the port digests its own names: never JAX's key for the model
    jabs = models("gpt2")[0]
    assert sig != jtune.cache.params_signature(jabs)
    # last match wins, and compaction keeps it
    tune_cache.store("k", {"strategy": "dp"}, path=path)
    tune_cache.store("k", {"strategy": "fsdp"}, path=path)
    assert tune_cache.lookup("k", path=path)["strategy"] == "fsdp"
    stats = tune_cache.compact_jsonl(path)
    assert (stats["kept"], stats["dropped"]) == (2, 1)
    assert tune_cache.lookup("k", path=path)["strategy"] == "fsdp"
    # the tuner stores a ranked decision and replays it (a fresh file:
    # the record stored above sits under this very key)
    path = str(tmp_path / "tuner.jsonl")
    jnl = Journal()
    with as_default(jnl), pytest.warns(UserWarning, match="heads="):
        r1 = tune.tune(pabs, pt, cache_path=path)
        r2 = tune.tune(pabs, pt, cache_path=path)
    assert (r1.source, r2.source) == ("cost_model", "cache")
    assert (r2.strategy, r2.degrees, r2.zero1) == (r1.strategy, r1.degrees,
                                                   r1.zero1)
    names = [r["name"] for r in jnl.records]
    assert names.index("tune.cache_hit") > names.index("tune.decision")
    # the head counts join the key: the same shapes under other heads
    # decide afresh
    with as_default(Journal()):
        r3 = tune.tune(pabs, pt, cache_path=path, heads=(4, 4))
        r4 = tune.tune(pabs, pt, cache_path=path, heads=(4, 2))
    assert r3.key not in (r1.key, r4.key)
    assert (r3.source, r4.source) == ("cost_model", "cost_model")


def test_cli_tune_json_equals_jax(tmp_path, capsys, monkeypatch):
    """JAX's ``tadnn tune`` on its 8 CPU devices against the port's with
    ``--topology cpu-8``, both liveness profiles refused (each package
    ranks on its activation heuristic; the profiles themselves are held
    to each other in ``tests/test_torch_port_search.py``): the same
    rows, and the same decision but for the key."""
    monkeypatch.setenv("TADNN_TUNE_CACHE", str(tmp_path / "cache.jsonl"))

    def no_profile(*a, **k):
        raise NotImplementedError("activation profile")

    monkeypatch.setattr(jcore.AutoDistribute, "activation_profile",
                        no_profile)
    monkeypatch.setattr(AutoDistribute, "activation_profile", no_profile)
    argv = ["tune", "--family", "gpt2", "--size", "test", "--seq", "64",
            "--batch", "8", "--grad-accums", "1,2", "--json"]

    def rows(main, extra):
        assert main(argv + extra) == 0
        return [json.loads(line) for line in
                capsys.readouterr().out.strip().splitlines()]

    want = rows(jcli.main, [])
    got = rows(cli, ["--topology", "cpu-8"])
    assert len(got) == len(want) > 2
    for g, w in zip(got[:-1], want[:-1]):
        assert_close(g, w)
    assert {k: v for k, v in got[-1].items() if k != "cache_key"} == {
        k: v for k, v in want[-1].items() if k != "cache_key"}
    assert got[-1]["source"] == "cost_model"
    # the second call answers from the cache, as JAX's does
    again = rows(cli, ["--topology", "cpu-8"])
    assert again[-1]["source"] == "cache"
    assert rows(cli, ["--topology", "cpu-8", "--no-zero1", "--no-cache"]
                )[-1]["source"] == "cost_model"
    assert cli(["tune", "--family", "gpt2", "--size", "test",
                "--topology", "tpu-8"]) == 2
