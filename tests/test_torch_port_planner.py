"""The PyTorch port's planner against the JAX package's, on abstract
shapes only (meta tensors on the port's side, ``jax.eval_shape`` on
JAX's): GPT-2 and Llama at the ``test`` presets and at full width
(GPT-2 small, Llama 3.2 1B), strategies ``dp``, ``fsdp``, ``tp``,
``tp_fsdp`` and ``dp`` + ZeRO-1 on meshes of 2, 4 and 8; and ResNet
(ResNet18Thin and ResNet-50) under ``dp``, ``fsdp``, ``tp`` and
``tp_fsdp`` on the same meshes, whose conv kernels are [out, in, kh,
kw] in the port and HWIO in flax, and where no tensor rule matches, so
``tp`` replicates everything and ``tp_fsdp`` is FSDP, in both packages.

The two packages lay the weights out differently (``nn.Linear``'s
[out, in] against flax's [in, H, hd] kernels), so a spec is not
compared dim by dim: per parameter, under the interop name map
(``interop.jax_param_path``), the set of mesh axes it uses and the
elements one device holds (``leaf_shard_slices``) must be equal, for
the parameter and for its ZeRO-1 optimizer spec.  The port's column
split takes whole heads (JAX splits head_dim), so where ``tensor`` does
not divide a head count the port refuses the plan, naming the numbers.
Exact equality everywhere: the quantities are integers.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu import topology as jtopo
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.models import Llama as JLlama
from torch_automatic_distributed_neural_network_tpu.models import resnet as jresnet
from torch_automatic_distributed_neural_network_tpu_torch import planner
from torch_automatic_distributed_neural_network_tpu_torch import topology
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    jax_param_path,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
    llama_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import resnet

MODELS = {("gpt2", "test"): (JGPT2, gpt2_config),
          ("gpt2", "small"): (JGPT2, gpt2_config),
          ("llama", "test"): (JLlama, llama_config),
          ("llama", "1b"): (JLlama, llama_config)}


@functools.lru_cache(maxsize=None)
def abstract_pair(family, size):
    jcls, port_cfg = MODELS[(family, size)]
    jm = jcls(size, scan_layers=False)
    jabs = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    jflat = dict(jplanner._flatten_with_paths(jabs))
    cfg = port_cfg(size)
    with torch.device("meta"):
        pabs = planner.abstract_params(DecoderLM(cfg))
    return jabs, jflat, pabs, (cfg.n_heads, cfg.kv_heads)


def _count(shape, spec, degrees, slices):
    (first,) = slices(shape, spec, degrees)[:1]
    return math.prod(b - a for a, b in first)


def _assert_same_specs(jflat_specs, port_specs, jflat, pabs, degrees):
    assert len(port_specs) == len(jflat_specs)
    for name, spec in port_specs.items():
        jpath = jax_param_path(name)
        jspec = jflat_specs[jpath]
        assert planner.spec_axes(spec) == jplanner.spec_axes(jspec), (
            name, spec, jspec)
        got = _count(tuple(pabs[name].shape), spec, degrees,
                     planner.leaf_shard_slices)
        want = _count(jflat[jpath].shape, jspec, degrees,
                      jplanner.leaf_shard_slices)
        assert got == want, (name, spec, jspec)


def _heads_divide(heads, degrees):
    t = degrees.get("tensor", 1)
    return heads[0] % t == 0 and heads[1] % t == 0


STRATEGIES = [("dp", False), ("fsdp", False), ("tp", False),
              ("tp_fsdp", False), ("dp", True)]
CASES = [(m, s, z, n) for m in MODELS for s, z in STRATEGIES
         for n in (2, 4, 8)]


@pytest.mark.parametrize(
    "model,strategy,zero1,n", CASES,
    ids=[f"{m[0]}-{m[1]}-{s}{'+zero1' if z else ''}-{n}"
         for m, s, z, n in CASES])
def test_make_plan_matches_jax(model, strategy, zero1, n):
    jabs, jflat, pabs, heads = abstract_pair(*model)
    jplan = jplanner.make_plan(jabs, strategy=strategy, zero1=zero1,
                               devices=jax.devices()[:n])
    jdeg = jtopo.mesh_degrees(jplan.mesh)
    kw = dict(strategy=strategy, zero1=zero1, heads=heads,
              topology=topology.parse_topology(f"cpu-{n}"))
    if not _heads_divide(heads, jdeg):
        with pytest.raises(ValueError, match=f"tensor degree {jdeg['tensor']}"):
            planner.make_plan(pabs, **kw)
        return
    plan = planner.make_plan(pabs, **kw)
    assert (plan.strategy, plan.degrees, plan.remat, plan.zero1) == (
        jplan.strategy, jdeg, jplan.remat, jplan.zero1)
    assert planner.spec_axes(plan.batch_spec) == jplanner.spec_axes(
        jplan.batch_spec)
    jspecs = dict(jplanner._flatten_with_paths(jplan.param_specs))
    _assert_same_specs(jspecs, plan.param_specs, jflat, pabs, jdeg)
    if zero1:
        jopt = dict(jplanner._flatten_with_paths(jplan.opt_spec_tree))
        _assert_same_specs(jopt, plan.opt_spec_tree, jflat, pabs, jdeg)
    for grad_accum in (1, 2):
        want = jplanner.expected_collective_bytes(
            jplan, jabs, grad_dtype=jnp.bfloat16, grad_accum=grad_accum)
        got = planner.expected_collective_bytes(
            plan, pabs, grad_dtype=torch.bfloat16, grad_accum=grad_accum)
        for key in ("strategy", "mesh", "grad_accum", "grad_dtype",
                    "per_device", "total_wire_bytes", "model_dependent"):
            assert got[key] == want[key], key


RESNETS = {"thin": (jresnet.ResNet18Thin, resnet.ResNet18Thin),
           "50": (jresnet.ResNet50, resnet.ResNet50)}
RESNET_CASES = [(m, s, n) for m in RESNETS
                for s in ("dp", "fsdp", "tp", "tp_fsdp") for n in (2, 4, 8)]


@functools.lru_cache(maxsize=None)
def resnet_pair(name):
    jcls, pcls = RESNETS[name]
    jm = jcls(dtype=jnp.float32)
    jabs = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))["params"]
    with torch.device("meta"):
        pabs = planner.abstract_params(pcls(dtype=torch.float32))
    return jabs, dict(jplanner._flatten_with_paths(jabs)), pabs


@pytest.mark.filterwarnings("ignore:.*(ZERO|no parameter matched)")
@pytest.mark.parametrize("model,strategy,n", RESNET_CASES,
                         ids=[f"resnet{m}-{s}-{n}" for m, s, n in RESNET_CASES])
def test_resnet_plan_matches_jax(model, strategy, n):
    """Per parameter the axes and the elements a device holds, under the
    interop name map (BatchNorm's ``scale``/``bias`` keep their names;
    the running statistics are buffers, outside the plan, as
    ``batch_stats`` is outside JAX's), and the strategy, degrees, remat
    and collective bytes."""
    jabs, jflat, pabs = resnet_pair(model)
    jplan = jplanner.make_plan(jabs, strategy=strategy,
                               devices=jax.devices()[:n])
    jdeg = jtopo.mesh_degrees(jplan.mesh)
    plan = planner.make_plan(pabs, strategy=strategy,
                             topology=topology.parse_topology(f"cpu-{n}"))
    assert (plan.strategy, plan.degrees, plan.remat) == (
        jplan.strategy, jdeg, jplan.remat)
    jspecs = dict(jplanner._flatten_with_paths(jplan.param_specs))
    _assert_same_specs(jspecs, plan.param_specs, jflat, pabs, jdeg)
    want = jplanner.expected_collective_bytes(jplan, jabs,
                                              grad_dtype=jnp.bfloat16)
    got = planner.expected_collective_bytes(plan, pabs,
                                            grad_dtype=torch.bfloat16)
    for key in ("per_device", "total_wire_bytes", "model_dependent"):
        assert got[key] == want[key], key


KINDS = ["cpu", "mystery-accelerator"]
AUTO = [(m, k, n) for m in MODELS for k in KINDS for n in (1, 2, 4, 8)]


@pytest.mark.parametrize("model,kind,n", AUTO,
                         ids=[f"{m[0]}-{m[1]}-{k}-{n}" for m, k, n in AUTO])
def test_choose_strategy_and_auto_plan_match_jax(model, kind, n):
    """The auto policy from model bytes against the device kind's memory
    (the CPU sim's 8 GiB; the default 16 GiB for a kind neither table
    knows), and the auto plan's degrees and remat."""
    jabs, _, pabs, heads = abstract_pair(*model)
    jt = jtopo.Topology(num_devices=n, num_hosts=1, platform="cpu",
                        device_kind=kind)
    pt = topology.Topology(num_devices=n, num_hosts=1, platform="cpu",
                           device_kind=kind)
    want = jplanner.choose_strategy(jabs, jt)
    assert planner.choose_strategy(pabs, pt) == want
    strategy, degrees = want
    full = jtopo._resolve_degrees(n, degrees)
    jplan = jplanner.make_plan(jabs, mesh=full, strategy=strategy)
    plan = planner.make_plan(pabs, strategy="auto", topology=pt, heads=heads)
    assert (plan.strategy, plan.degrees) == (strategy, full)
    # JAX's make_plan reads the memory of its own devices; the remat rule
    # is given the kind's memory here through the same formula
    hbm = jplanner._hbm_bytes(kind)
    assert planner._hbm_bytes(kind) == hbm
    if strategy in ("fsdp", "tp_fsdp"):
        assert plan.remat is True and jplan.remat is True
    else:
        pb = jplanner.tree_bytes(jabs) // max(1, full.get("tensor", 1))
        assert plan.remat == (4.0 * pb > 0.5 * hbm)


def test_tree_bytes_and_expert_detection_match_jax():
    for model in MODELS:
        jabs, _, pabs, _ = abstract_pair(*model)
        assert planner.tree_bytes(pabs) == jplanner.tree_bytes(jabs)
        assert planner.detect_expert_count(pabs) is None
        assert planner.tp_applicable(pabs, planner.TRANSFORMER_RULES)
    bank = {"layers.0.moe.experts_up": torch.empty(8, 16, 32, device="meta"),
            "layers.0.moe.router.weight": torch.empty(16, 8, device="meta")}
    assert planner.detect_expert_count(bank) == 8
    specs = planner.param_spec_tree(bank, {"expert": 4, "data": 2}, "ep")
    assert specs["layers.0.moe.experts_up"] == planner.P("expert")
    assert specs["layers.0.moe.router.weight"] == planner.P()


def test_spec_helpers_match_jax():
    from jax.sharding import PartitionSpec as JP

    P = planner.P
    for spec, jspec in ((P(None, "tensor"), JP(None, "tensor")),
                        (P(("data", "fsdp")), JP(("data", "fsdp"))),
                        (P(), JP())):
        assert planner.spec_to_json(spec) == jplanner.spec_to_json(jspec)
        assert planner.spec_from_json(planner.spec_to_json(spec)) == spec
        assert planner.spec_axes(spec) == jplanner.spec_axes(jspec)
        for shape in ((8, 12), (6, 16)):
            deg = {"tensor": 2, "data": 2, "fsdp": 2}
            assert planner.leaf_shard_slices(shape, spec, deg) == (
                jplanner.leaf_shard_slices(shape, jspec, deg))
    assert repr(P("fsdp", None)) == "P('fsdp', None)"
    assert P(None) != P() and planner._norm_spec([None]) == P()


def test_planner_refuses_what_is_not_ported(monkeypatch, tmp_path):
    _, jabs, pabs, heads = abstract_pair("gpt2", "test")
    topo = topology.parse_topology("cpu-4")
    # the tuned strategy is ported: on 4 CPU devices it picks JAX's plan
    # (its cost model ranks, the cache off)
    from torch_automatic_distributed_neural_network_tpu import tune as jtune
    from torch_automatic_distributed_neural_network_tpu_torch import tune

    monkeypatch.setenv("TADNN_TUNE_CACHE", str(tmp_path / "tune.jsonl"))
    plan = planner.make_plan(pabs, strategy="tuned", topology=topo,
                             heads=heads,
                             tune_policy=tune.TunePolicy(use_cache=False))
    jplan = jplanner.make_plan(jabs, strategy="tuned",
                               devices=jax.devices()[:4],
                               tune_policy=jtune.TunePolicy(use_cache=False))
    assert (plan.strategy, plan.degrees, plan.zero1, plan.remat) == (
        jplan.strategy, jtopo.mesh_degrees(jplan.mesh), jplan.zero1,
        jplan.remat)
    # sequence and pipeline parallelism are ported: each alone takes its
    # axis out of the devices first, as JAX's planner does; together
    # they are its ValueError
    for kw, axis in ((dict(seq=2), "seq"), (dict(pipe=2), "pipe")):
        plan = planner.make_plan(pabs, topology=topo, **kw)
        assert (plan.degrees[axis], plan.degrees["data"]) == (2, 2)
        assert (plan.stages is None) == (axis == "seq")
    with pytest.raises(ValueError, match="seq-parallel \\+ pipeline"):
        planner.make_plan(pabs, topology=topo, seq=2, pipe=2)
    plan = planner.make_plan(pabs, mesh={"pipe": 2, "data": 2})
    assert plan.stages["layers.1.mlp.up_proj.weight"] == 1
    with pytest.raises(ValueError, match="Unknown strategy"):
        planner.make_plan(pabs, strategy="bogus", topology=topo)
    with pytest.raises(ValueError, match="MoE"):
        planner.make_plan(pabs, strategy="ep", topology=topo)
    with pytest.warns(UserWarning, match="ZERO"):
        planner.param_spec_tree({"w": torch.empty(8, 8, device="meta")},
                                {"tensor": 2}, "tp")


def test_describe_names_every_parameter_and_the_zero1_specs():
    _, _, pabs, heads = abstract_pair("gpt2", "test")
    plan = planner.make_plan(pabs, strategy="dp", zero1=True, heads=heads,
                             topology=topology.parse_topology("cpu-2"))
    text = plan.describe()
    assert text.startswith("ShardPlan(strategy=dp+zero1")
    assert "layers.1.mlp.up_proj.weight: P()  [opt: P('data')]" in text
    assert len(text.splitlines()) == len(pabs) + 1


def test_single_device_plan_on_the_card_and_the_cpu():
    """One device: ``dp`` on ``{"data": 1}``, remat from the device's
    memory (the H100 table entry; a live card's own ``total_memory``
    rides in ``chip_override``)."""
    _, _, pabs, heads = abstract_pair("gpt2", "small")
    for topo in (topology.parse_topology("h100-1"),
                 topology.parse_topology("cpu-1")):
        plan = planner.make_plan(pabs, topology=topo, heads=heads)
        assert plan.strategy == "dp" and plan.degrees["data"] == 1
        assert plan.remat is False
    tight = topology.Topology(
        num_devices=1, num_hosts=1, platform="gpu", device_kind="h100",
        chip_override=topology.ChipSpec(1e15, 2**30, 1e12, 1e11, 1e10))
    assert planner.make_plan(pabs, topology=tight).remat is True


def test_fleet_plans_equal_the_table_the_card_checks():
    """``chip_smoke.py`` plans GPT-2 1p3b and Llama 3.2 1B for fleets of
    1, 4 and 8 H100s on the card and requires ``FLEET_PLANS``: the same
    function gives the same table here."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.fleet_plans(torch) == smoke.FLEET_PLANS
