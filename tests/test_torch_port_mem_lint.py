"""The port's memory lint against the JAX package's
(``analysis/mem_lint.py``, ``analysis.memory_check``, ``tadnn check
--memory``, the Trainer's preflight budget and the tuner's liveness
profile), on the CPU; JAX on its 8 simulated CPU devices.

- ``sharded_tree_bytes`` equals JAX's on the same leaves and specs
  (exact); the persistent terms of GPT-2 ``test`` (params, optimizer
  state, batch) under ``dp`` and ``fsdp`` degrees of 1, 2 and 8 equal
  JAX's exactly, the optimizer less JAX's int32 step count (4 bytes on
  the device; the port's count is a host int).
- The transient peak of the port's traced step (fake tensors, one
  device) lies within 2x of JAX's liveness walk on the same model and
  batch; the ratio is printed.
- JAX's findings tests (ML001-ML003, the headroom, ``resolve_budget``,
  ``parse_size``) give the same codes and messages; ``tadnn check
  --memory --device cpu`` exits as JAX's does for a 1 KiB and a 64 KiB
  budget, a real budget, ``--ignore ML001``, an unknown code and ``--json``;
  JAX's ``TestPreflightBudget`` behaves the same in the port.
- ``activation_profile`` has JAX's keys and ``batch_items``; JAX's
  ``test_oom_candidate_pruned_fitting_one_survives`` gives the same
  decision with the port's profile.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_automatic_distributed_neural_network_tpu as tad
from torch_automatic_distributed_neural_network_tpu import analysis as janalysis
from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu import topology as jtopo
from torch_automatic_distributed_neural_network_tpu.analysis import (
    mem_lint as jmem_lint,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.models import MLP as JMLP
from torch_automatic_distributed_neural_network_tpu.training import (
    next_token_loss as jnext_token_loss,
    softmax_xent_loss as jsoftmax_xent_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    MLP,
    AutoDistribute,
    adamw,
    next_token_loss,
    softmax_xent_loss,
    topology,
)
from torch_automatic_distributed_neural_network_tpu_torch import analysis
from torch_automatic_distributed_neural_network_tpu_torch import planner
from torch_automatic_distributed_neural_network_tpu_torch.analysis import (
    mem_lint,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.obs import Journal
from torch_automatic_distributed_neural_network_tpu_torch.planner import P
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    Trainer,
    TrainerConfig,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import (
    space as tune_space,
)


def codes(findings):
    return [f.code for f in findings]


def sds(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch(n=64, d=8, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(n, d).astype(np.float32),
            "label": rs.randint(0, 10, size=(n,)).astype(np.int32)}


def _small_ad(strategy="fsdp", grad_accum=1):
    return AutoDistribute(MLP(features=(32, 10), in_features=8),
                          optimizer=adamw(1e-3), loss_fn=softmax_xent_loss,
                          strategy=strategy, grad_accum=grad_accum,
                          device="cpu")


def _synthetic_est(mod, peak, act, *, remat=True):
    rest = peak - act
    return mod.MemEstimate(
        params_bytes=rest, optimizer_bytes=0, model_state_bytes=0,
        batch_bytes=0, activation_bytes=act, peak_bytes=peak,
        strategy="fsdp", degrees={"fsdp": 8}, grad_accum=1, remat=remat,
        transient_by_class={})


# ---------------------------------------------------------------------------
# the persistent terms: JAX's bytes
# ---------------------------------------------------------------------------


def test_sharded_tree_bytes_equals_jax():
    jtree = {"w": sds(8, 4), "b": sds(8, 4)}
    jspecs = {"w": JP("fsdp", None), "b": JP(None, None)}
    want = jmem_lint.sharded_tree_bytes(jtree, jspecs, {"fsdp": 8})
    tree = {"b": meta(8, 4), "w": meta(8, 4)}
    specs = {"b": P(None, None), "w": P("fsdp", None)}
    got = mem_lint.sharded_tree_bytes(tree, specs, {"fsdp": 8})
    assert got == want == (8 * 4 * 4 // 8 + 8 * 4 * 4, 2 * 8 * 4 * 4)


@pytest.mark.parametrize("strategy,degree", [
    ("dp", 1), ("dp", 8), ("fsdp", 2), ("fsdp", 8)])
def test_gpt2_persistent_terms_equal_jax(strategy, degree):
    """GPT-2 ``test`` (vocab 256, S 32, B 8): params, optimizer state and
    batch per device under the plan's specs at ``degree`` devices."""
    jmodel = JGPT2("test", vocab_size=256, max_seq_len=32)
    jbatch = {"tokens": np.zeros((8, 33), np.int32)}
    jabs = jax.eval_shape(jmodel.init, jax.random.key(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    axis = "data" if strategy == "dp" else "fsdp"
    jplan = jplanner.make_plan(
        jabs, mesh=jtopo.build_mesh(devices=jax.devices()[:degree],
                                    **{axis: degree}), strategy=strategy)
    jopt = jax.eval_shape(optax.adamw(1e-3).init, jabs)
    jbatch_abs = {k: sds(*v.shape, dtype=v.dtype) for k, v in jbatch.items()}
    want = jmem_lint.estimate_step_memory(
        None, jplan, jabs, opt_state=jopt, batch=jbatch_abs)

    ad = AutoDistribute(GPT2("test", vocab_size=256, max_seq_len=32),
                        optimizer=adamw(1e-3), loss_fn=next_token_loss,
                        device="cpu")
    params, opt, ms, batch = ad.abstract_state(jbatch, meshless=True)
    plan = planner.make_plan(planner.abstract_params(ad.model),
                             mesh={axis: degree}, strategy=strategy)
    got = mem_lint.estimate_step_memory(None, plan, params, opt_state=opt,
                                        model_state=ms, batch=batch)
    print(strategy, degree, got.params_bytes, want.params_bytes,
          got.optimizer_bytes, want.optimizer_bytes)
    assert got.params_bytes == want.params_bytes
    assert got.batch_bytes == want.batch_bytes
    assert got.optimizer_bytes == want.optimizer_bytes - 4
    assert got.activation_bytes == want.activation_bytes == 0


def test_transient_peak_within_2x_of_jax():
    """One device, GPT-2 ``test`` (vocab 256, S 64, B 4, fsdp at degree
    1): the port's liveness walk over its traced step against JAX's over
    its jaxpr (both static; tolerance: a ratio in [0.5, 2])."""
    jsample = {"tokens": np.zeros((4, 65), np.int32)}
    jad = tad.AutoDistribute(
        JGPT2("test", vocab_size=256, max_seq_len=64),
        optimizer=optax.adamw(1e-3), loss_fn=jnext_token_loss,
        strategy="fsdp", devices=jax.devices()[:1])
    _, want = janalysis.memory_check(jad, jsample, rng=jax.random.key(0),
                                     budget="16GiB", compiled=False)
    ad = AutoDistribute(GPT2("test", vocab_size=256, max_seq_len=64),
                        optimizer=adamw(1e-3), loss_fn=next_token_loss,
                        strategy="fsdp", device="cpu")
    _, got = analysis.memory_check(ad, jsample, budget="16GiB")
    ratio = got["activation_bytes"] / want["activation_bytes"]
    print(f"transient port / JAX: {got['activation_bytes']} / "
          f"{want['activation_bytes']} = {ratio:.3f}; static / measured "
          f"{got['static_over_compiled']}")
    assert 0.5 <= ratio <= 2.0
    assert (got["params_bytes"], got["batch_bytes"]) == (
        want["params_bytes"], want["batch_bytes"])
    assert 0.5 <= got["static_over_compiled"] <= 2.0


# ---------------------------------------------------------------------------
# JAX's estimator and findings tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["16GiB", "2MiB", "1KiB", "32GB", "1500MB",
                                  "4K", "95 GiB", "512", "1.5GiB"])
def test_resolve_budget_parses_as_jax(text):
    assert mem_lint.resolve_budget(text) == jmem_lint.resolve_budget(text)
    assert mem_lint.resolve_budget(1024) == 1024


def test_estimate_has_consistent_breakdown():
    findings, rep = analysis.memory_check(_small_ad(), _batch(),
                                          budget="16GiB", compiled=False)
    assert rep["peak_bytes"] == (
        rep["params_bytes"] + rep["optimizer_bytes"]
        + rep["model_state_bytes"] + rep["batch_bytes"]
        + rep["activation_bytes"])
    assert rep["params_bytes"] > 0 and rep["activation_bytes"] > 0
    # adamw: two f32 moments mirroring the sharded param tree
    assert rep["optimizer_bytes"] == pytest.approx(
        2 * rep["params_bytes"], rel=0.05)
    assert rep["strategy"] == "fsdp" and rep["degrees"] == {}
    assert not [f for f in findings if f.layer in ("mem", "dtype")]


def test_grad_accum_shrinks_transient():
    reps = {}
    for ga in (1, 4):
        _, reps[ga] = analysis.memory_check(
            _small_ad(grad_accum=ga), _batch(), budget="16GiB",
            compiled=False)
    assert reps[4]["activation_bytes"] < reps[1]["activation_bytes"]
    assert reps[4]["grad_accum"] == 4


def test_persistent_only_without_trace():
    ad = _small_ad()
    ad.build_plan(None, _batch())
    params, opt, _, _ = ad.abstract_state(_batch(), meshless=True)
    est = mem_lint.estimate_step_memory(None, ad.plan, params,
                                        opt_state=opt)
    assert est.activation_bytes == 0
    assert est.peak_bytes == est.params_bytes + est.optimizer_bytes


@pytest.mark.parametrize("peak,act,budget,headroom,remat", [
    (1000, 200, 500, 0.1, True),      # ML001
    (950, 200, 1000, 0.1, True),      # ML002
    (950, 200, 1000, 0.0, True),      # headroom 0: nothing
    (950, 200, 1000, 0.3, True),      # headroom 0.3: ML002
    (1000, 800, 500, 0.1, False),     # ML001 + ML003
    (1000, 800, 500, 0.1, True),      # remat on: no ML003
])
def test_memory_findings_equal_jax(peak, act, budget, headroom, remat):
    want = jmem_lint.lint_memory(
        _synthetic_est(jmem_lint, peak, act, remat=remat),
        budget_bytes=budget, headroom=headroom)
    got = mem_lint.lint_memory(
        _synthetic_est(mem_lint, peak, act, remat=remat),
        budget_bytes=budget, headroom=headroom)
    assert [(f.code, f.severity, f.where, f.msg) for f in got] == [
        (f.code, f.severity, f.where, f.msg) for f in want]
    if codes(got)[:1] == ["ML001"]:
        assert analysis.exit_code(got) == 1 and "OOM" in got[0].msg


def test_real_model_oom_end_to_end():
    findings, rep = analysis.memory_check(_small_ad(), _batch(), budget=1024,
                                          compiled=False)
    assert "ML001" in codes(findings)
    assert rep["budget_bytes"] == 1024
    assert analysis.exit_code(findings) == 1


# ---------------------------------------------------------------------------
# tadnn check --memory
# ---------------------------------------------------------------------------

SMALL_CLI = ["check", "--memory", "--no-source", "--no-compiled",
             "--size", "32,10", "--batch", "64"]


@pytest.mark.parametrize("extra,rc,needle", [
    (["--budget", "1KiB"], 1, "ML001"),
    (["--budget", "64KiB"], 1, "ML001"),
    (["--budget", "16GiB"], 0, "memory estimate"),
    (["--budget", "64KiB", "--ignore", "ML001", "--ignore", "ML002",
      "--ignore", "ML003"], 0, "peak"),
    (["--budget", "16GiB", "--ignore", "NOPE1"], 2, None),
])
def test_check_memory_exits_as_jax(extra, rc, needle, capsys):
    assert jcli.main(SMALL_CLI + extra) == rc
    capsys.readouterr()
    assert cli(SMALL_CLI + extra + ["--device", "cpu"]) == rc
    out = capsys.readouterr().out
    if needle:
        assert needle in out
    if "ML001" not in extra and rc == 0:
        assert "ML001" not in out


def test_check_memory_json_as_jax(capsys):
    argv = SMALL_CLI + ["--budget", "16GiB", "--json"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got["memory"]) == set(want["memory"])
    assert got["memory"]["budget_bytes"] == 16 * 2**30
    assert got["memory"]["peak_bytes"] > 0
    # the measured run (the step on fake tensors) beside the estimate
    assert cli(SMALL_CLI[:-5] + ["--size", "32,10", "--batch", "64",
                                 "--budget", "16GiB", "--json",
                                 "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)["memory"]
    assert rep["compiled"]["per_device_peak_bytes"] > 0
    assert 0.5 <= rep["static_over_compiled"] <= 2.0


# ---------------------------------------------------------------------------
# the Trainer's preflight budget (JAX's TestPreflightBudget)
# ---------------------------------------------------------------------------


class TestPreflightBudget:
    def _fit(self, cfg, journal):
        data = (_batch(seed=i) for i in range(cfg.steps))
        Trainer(_small_ad(), cfg, journal=journal).fit(data)
        return journal

    def test_predicted_oom_raises_under_raise_action(self):
        cfg = TrainerConfig(steps=1, preflight=True,
                            preflight_action="raise", preflight_budget=1024)
        with pytest.raises(analysis.PreflightError) as ei:
            self._fit(cfg, Journal())
        assert "ML001" in str(ei.value)

    def test_preflight_ignore_unblocks(self):
        cfg = TrainerConfig(
            steps=1, preflight=True, preflight_action="raise",
            preflight_budget=1024,
            preflight_ignore=("ML001", "ML002", "ML003"))
        j = self._fit(cfg, Journal())
        assert j.named("lint.summary")[0]["errors"] == 0

    def test_preflight_journals_mem_estimate(self):
        cfg = TrainerConfig(steps=1, preflight=True,
                            preflight_budget="16GiB")
        j = self._fit(cfg, Journal())
        (est,) = j.named("lint.mem_estimate")
        assert est["phase"] == "preflight" and est["peak_bytes"] > 0
        assert est["budget_bytes"] == 16 * 2**30


# ---------------------------------------------------------------------------
# the tuner's liveness profile
# ---------------------------------------------------------------------------


def test_activation_profile_has_jax_keys():
    jad = tad.AutoDistribute(
        JMLP(features=(32, 10)), optimizer=optax.adamw(1e-3),
        loss_fn=jsoftmax_xent_loss, strategy="fsdp")
    want = jad.activation_profile(jax.random.key(0), _batch())
    got = _small_ad().activation_profile(None, _batch())
    assert set(got) == set(want) and got["batch_items"] == want[
        "batch_items"] == 64
    for variant in ("noremat", "remat"):
        assert set(got[variant]) == set(want[variant])
        assert got[variant]["peak_bytes"] > 0
    assert got["noremat"]["batch_bytes"] > 0


def test_oom_candidate_pruned_fitting_one_survives():
    """JAX's decision with the port's profile: every candidate fits at the
    default safety; at 1e-7 the replicated dp candidate is pruned by the
    measured liveness and sharded fsdp survives."""
    prof = _small_ad().activation_profile(None, _batch())
    abstract = planner.abstract_params(_small_ad().model)
    topo = topology.parse_topology("h100-8")
    kept, pruned = tune_space.enumerate_candidates(
        abstract, topo, act_profile=prof, batch_items=64)
    assert {c.strategy for c in kept} >= {"dp", "fsdp"} and not pruned
    kept, pruned = tune_space.enumerate_candidates(
        abstract, topo, act_profile=prof, batch_items=64, safety=1e-7)
    assert "fsdp" in {c.strategy for c in kept}
    assert "dp" in {c.strategy for c, _ in pruned}
    why = dict((c.strategy, w) for c, w in pruned)["dp"]
    assert "memory:" in why and "liveness" in why
