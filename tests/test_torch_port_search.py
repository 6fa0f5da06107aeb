"""The port's ``AutoDistribute.compile_report``, ``strategy="search"``,
``hbm_fit_budget`` and ``tadnn fit`` against the JAX package's (its
``tests/test_profiling.py`` search cases), on the CPU; the multi-device
cases on 2 gloo ranks of ``tests/torch_port_dist_worker.py``, beside
GL002's hidden all-gather and DT003 (``tests/test_torch_port_lint.py``).

- One device: ``search`` is the no-op to ``dp`` with an empty
  ``search_report``, as JAX's.
- 2 ranks: GPT-2 ``test`` takes ``dp`` at the first rung with ``fits``
  True, as JAX's on 2 devices, and then trains (a finite loss); with
  the budget between the ``dp`` and ``fsdp`` rungs' measured peaks it
  escalates in JAX's ladder order (``dp`` does not fit, ``fsdp`` does).
  The traced step's collectives (the plan's: the gradients' all-reduce
  under dp, the all-gather and reduce-scatter under fsdp, ZeRO-1's
  reduce-scatter and all-gather over data) raise no GL002;
  ``memory_check``'s ``static_over_compiled`` lies in [0.5, 2].
- ``compile_report`` returns JAX's keys and measures with nothing
  allocated; K1's FLOPs are its registered formula's (exact); a tuner
  trial's ``compiled_flops`` come from it; ``tadnn fit --device cpu``
  prints JAX's keys, line for line.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch
from torch_port_spawn import spawn

import torch_automatic_distributed_neural_network_tpu as tad
from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.training import (
    next_token_loss as jnext_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    AutoDistribute,
    adamw,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.ops import (
    flash_attention as fa,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import measure
from torch_automatic_distributed_neural_network_tpu_torch.utils import (
    profiling,
)

MODEL = {"size": "test", "vocab_size": 512, "max_seq_len": 64}
SAMPLE = {"tokens": np.zeros((8, 65), np.int32)}
# the real tokens the traceable step and ``ad.step`` both train on
REAL = {"tokens": np.random.RandomState(7).randint(
    0, 512, (8, 65)).astype(np.int32)}
# the traceable step against ``step`` on the same state: the same ops in
# the same order (fp32; ``mixed`` keeps fp32 masters), so equal up to
# the summation order of a collective
STEP_TOL = 1e-6


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn(2, {"lint": {"model": MODEL, "batch": SAMPLE,
                              "real_batch": REAL}},
                 tmp_path_factory.mktemp("lint2"))["lint"]


def _jax_ad(devices):
    return tad.AutoDistribute(
        JGPT2("test", vocab_size=512, max_seq_len=64),
        optimizer=optax.adamw(1e-4), loss_fn=jnext_token_loss,
        strategy="search", devices=devices)


def test_search_single_device_noop_as_jax():
    jad = _jax_ad(jax.devices()[:1])
    assert jad.build_plan(jax.random.key(0), SAMPLE).strategy == "dp"
    ad = AutoDistribute(GPT2(**MODEL), optimizer=adamw(1e-4),
                        loss_fn=next_token_loss, strategy="search",
                        device="cpu")
    assert ad.build_plan(None, SAMPLE).strategy == "dp"
    assert ad.search_report == jad.search_report == []


def test_search_picks_dp_on_two_ranks_then_trains(two_ranks):
    jad = _jax_ad(jax.devices()[:2])
    jplan = jad.build_plan(jax.random.key(0), SAMPLE)
    got = two_ranks["search"]
    assert got["strategy"] == jplan.strategy == "dp"
    assert [(e["strategy"], e["fits"]) for e in got["report"]] == [
        (e["strategy"], e["fits"]) for e in jad.search_report] == [
        ("dp", True)]
    entry = got["report"][0]
    assert set(entry) == set(jad.search_report[0])
    assert entry["peak_bytes"] > 0 and entry["flops"] > 0
    assert np.isfinite(got["loss"])


def test_search_escalates_in_jax_ladder_order(two_ranks):
    esc = two_ranks["escalated"]
    peaks = esc["peaks"]
    assert peaks["fsdp"] < esc["budget"] < peaks["dp"]
    assert esc["strategy"] == "fsdp"
    assert [(e["strategy"], e["remat"], e["fits"]) for e in esc["report"]] \
        == [("dp", None, False), ("fsdp", None, True)]
    assert tuple(e["strategy"] for e in esc["report"]) == tuple(
        s for s, _ in tad.AutoDistribute._SEARCH_LADDER_DENSE[:2])


def test_traced_step_collectives_are_the_plans(two_ranks):
    steps = two_ranks["steps"]
    dp, fsdp = steps["dp"], steps["fsdp"]
    assert dp["findings"] == [] and fsdp["findings"] == []
    assert {(r["kind"], r["axes"]) for r in dp["inventory"]} == {
        ("reduce", ("data",))}
    assert {(r["kind"], r["axes"]) for r in fsdp["inventory"]} == {
        ("gather", ("fsdp",)), ("scatter", ("fsdp",))}
    assert dp["degrees"] == {"data": 2} and fsdp["degrees"] == {"fsdp": 2}
    # ZeRO-1: the gradients reduce-scattered onto the optimizer's shard
    # over data and the fresh values all-gathered back; half the moments
    zero1 = steps["zero1"]
    assert zero1["findings"] == []
    assert {(r["kind"], r["axes"]) for r in zero1["inventory"]} == {
        ("scatter", ("data",)), ("gather", ("data",))}
    assert zero1["optimizer_bytes"] < 0.6 * dp["optimizer_bytes"]
    assert zero1["peak"] < dp["peak"]
    for rec in (dp, fsdp, zero1):
        assert 0.5 <= rec["static_over_compiled"] <= 2.0
        print("static_over_compiled", rec["degrees"],
              rec["static_over_compiled"])


@pytest.mark.parametrize("kw", [{"remat": True}, {"remat": False},
                                {"grad_accum": 2}, {"precision": "mixed"}],
                         ids=["remat", "no_remat", "grad_accum_2", "mixed"])
def test_traceable_step_equals_step(kw):
    """``traceable_step`` run on real copies of the state gives the loss,
    parameters and optimizer state that ``ad.step`` gives from it (within
    ``STEP_TOL``, observed 0.0): the function the lints, the preflight
    and ``compile_report`` trace is the step."""
    from torch.utils._pytree import tree_leaves, tree_map

    torch.manual_seed(0)
    ad = AutoDistribute(GPT2(**MODEL), optimizer=adamw(1e-3),
                        loss_fn=next_token_loss, device="cpu", **kw)
    state = ad.init(torch.Generator().manual_seed(0), REAL)
    for key, want in kw.items():
        got = {"remat": ad.remat, "grad_accum": ad._grad_accum,
               "precision": ad.precision.name}[key]
        assert got == want

    def clone(t):
        return t.detach().clone() if isinstance(t, torch.Tensor) else t

    before = {n: clone(t) for n, t in state.params.items()}
    args = ({n: clone(t) for n, t in state.params.items()},
            tree_map(clone, state.opt_state),
            {n: clone(t) for n, t in state.model_state.items()},
            dict(ad._to_device(REAL)))
    loss, params, opt_state = ad.traceable_step()(
        *args, ad._generator(state, 0))
    new, metrics = ad.step(state, REAL)
    assert abs(float(loss) - float(metrics["loss"])) <= STEP_TOL
    assert params.keys() == new.params.keys()
    for n, t in params.items():
        assert t.dtype == new.params[n].dtype
        assert float((t - new.params[n]).abs().max()) <= STEP_TOL, n
    got, want = tree_leaves(opt_state), tree_leaves(new.opt_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype
            assert float((a - b).abs().max()) <= STEP_TOL
        else:
            assert a == b
    # the step moved the parameters: not two copies of the initial state
    assert all(float((new.params[n] - before[n]).abs().max()) > 0
               for n in ("embed", "pos_embed"))


@pytest.mark.parametrize("strategy", ["dp", "fsdp", "zero1"])
def test_traceable_step_equals_step_on_two_ranks(two_ranks, strategy):
    """Under dp, fsdp and ZeRO-1 on 2 gloo ranks the traceable step, on
    real copies of rank 0's local shards, gives what ``ad.step`` gives
    (within ``STEP_TOL``): the collectives it writes out are the
    wrappers' reductions."""
    rec = two_ranks["traceable_vs_step"][strategy]
    assert rec["shapes_match"]
    for key in ("loss", "params", "opt_state"):
        assert rec[key] <= STEP_TOL, (key, rec)


def test_hidden_all_gather_is_gl002_on_two_ranks(two_ranks):
    (f,) = two_ranks["hidden"]["findings"]
    assert f["code"] == "GL002" and "'data'" in f["msg"]
    assert "allgather" in f["msg"] or "all_gather" in f["msg"]
    (rec,) = two_ranks["hidden"]["inventory"]
    assert rec["kind"] == "gather" and rec["bytes"] == 2 * 8 * 4 * 4
    # the same collective over the tensor axis of a tp plan: the
    # planner's own pattern, not flagged
    assert two_ranks["tp"] == []


def test_python_scalar_into_a_collective_is_dt003(two_ranks):
    assert [f["code"] for f in two_ranks["dt003"]] == ["DT003"]


def test_compile_report_keys_and_nothing_allocated():
    jad = tad.AutoDistribute(
        JGPT2("test", vocab_size=512, max_seq_len=64),
        optimizer=optax.adamw(1e-4), loss_fn=jnext_token_loss,
        strategy="dp", devices=jax.devices()[:1])
    want = jad.compile_report(jax.random.key(0), SAMPLE)
    with torch.device("meta"):
        model = GPT2(**MODEL)
    ad = AutoDistribute(model, optimizer=adamw(1e-4),
                        loss_fn=next_token_loss, device="cpu")
    got = ad.compile_report(None, SAMPLE)
    # JAX's keys but its executable's (``bytes_accessed``,
    # ``generated_code_size``): the port compiles no program
    assert set(got) <= set(want)
    assert set(got["memory"]) == {"argument_size", "temp_size",
                                  "output_size", "alias_size"}
    assert set(got["memory"]) <= set(want["memory"])
    mem = got["memory"]
    assert got["per_device_peak_bytes"] == (
        mem["argument_size"] + mem["temp_size"] + mem["output_size"]
        - mem["alias_size"])
    # the parameters, updated in place, are their own alias
    n_params = sum(p.numel() for p in model.parameters()) * 4
    assert mem["alias_size"] == n_params
    assert got["flops"] > 0 and ad.last_compile_error is None
    # still meta: nothing was materialized
    assert all(p.is_meta for p in model.parameters())
    assert AutoDistribute.hbm_fit_budget("cpu") == pytest.approx(
        tad.AutoDistribute.hbm_fit_budget("cpu"))


def test_k1_flops_are_its_formula():
    q = torch.zeros(2, 64, 4, 32)
    with profiling.Flops() as flops:
        fa.flash_forward(q, q, q, causal=True)
    assert flops.total == 2 * 2 * 2 * 4 * 64 * 64 * 32


def test_tuner_trial_flops_come_from_compile_report():
    ad = AutoDistribute(GPT2(**MODEL), optimizer=adamw(1e-4),
                        loss_fn=next_token_loss, device="cpu")
    ad.build_plan(None, SAMPLE)
    assert measure._compiled_flops(ad, None, SAMPLE) == ad.compile_report(
        None, SAMPLE)["flops"] > 0


def test_fit_cli_prints_jax_keys(capsys):
    argv = ["fit", "--family", "gpt2", "--size", "test", "--seq", "64",
            "--batch", "8", "--strategy", "dp"]

    def lines(main, extra):
        assert main(argv + extra) == 0
        return [json.loads(x) for x in
                capsys.readouterr().out.strip().splitlines()]

    want = lines(jcli.main, [])
    got = lines(cli, ["--device", "cpu"])
    assert [set(x) for x in got] == [set(x) for x in want]
    assert got[0]["fits"] is True and got[-1]["chosen_strategy"] == "dp"
    # one device under search: JAX's 1-device no-op line
    got = lines(cli, ["--device", "cpu", "--strategy", "search"])
    assert got[0] == {"strategy": "dp", "note": "1-device no-op"}
