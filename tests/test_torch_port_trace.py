"""The port's ``obs/trace.py`` on ``torch.profiler``, ``obs/comms.py``,
``Trainer(trace_every_n=)`` and ``tadnn trace`` / ``tadnn profile``
against the JAX package's, on the CPU.

- ``attribute`` on one seeded synthetic timeline gives JAX's records
  exactly; the same timeline spelled with this package's names (c10d
  ops, gloo annotations, NCCL kernels) gives the same numbers.
- ``parse_trace`` on a hand-written Chrome trace laid out as a CUDA
  capture is (``gpu_user_annotation`` windows, kernels and memcpys on
  the device lane, ``c10d::*`` ops with their ``Input Dims``) reads the
  device windows and lane and each collective's result bytes, the
  tensor list's dtype from the NCCL annotation of its size.
- ``StepTracer`` / ``trace_steps`` on GPT-2 ``test`` on the CPU: one
  window a step, ``compute_s > 0``, a ``trace.step`` record a step
  naming the ``.json.gz`` written under ``logdir``.
- On 2 gloo ranks (``tests/torch_port_spawn.py``), GPT-2 ``test`` under
  ``dp`` and ``fsdp``: each category the plan models (``grad_allreduce``
  under dp; ``param_allgather`` and ``grad_reduce_scatter`` under fsdp
  with the plan's loss-level remat off) measures within 2x of
  ``comms.comm_profile`` — ratio 1.0 under dp; 1.41 and 0.5 under fsdp,
  where each layer's own remat gathers it a third time and a
  reduce-scatter's result is its shard — and ``comm_profile``'s
  per-device bytes equal JAX's on 2 CPU devices exactly.  With the
  plan's remat on too, every layer is recomputed once more:
  ``param_allgather`` measures above 2x of the model's two gathers a
  step (2.83; ROADMAP Queue 3 logs the model's gap).
- ``Trainer(trace_every_n=3)`` traces the steps JAX's Trainer traces
  over 7 steps; its losses are bitwise those of an untraced run; a
  capture that fails after the step journals ``trace.error`` and keeps
  the step's result (losses still bitwise), one that fails before it
  runs the plain step.
- ``tadnn trace --device cpu`` prints a record a traced step and
  journals them; a ``.py`` target runs with ``TADNN_TRACE_EVERY_N``
  exported; ``tadnn profile --device cpu`` writes its trace.
"""

import gzip
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch
from torch_port_spawn import spawn

import torch_automatic_distributed_neural_network_tpu as jtad
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.obs import (
    comms as jcomms,
)
from torch_automatic_distributed_neural_network_tpu.obs import (
    trace as jtrace,
)
from torch_automatic_distributed_neural_network_tpu.training import (
    next_token_loss as jnext_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    AutoDistribute,
    SyntheticLM,
    adamw,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    journal,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    trace as obs_trace,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    Trainer,
    TrainerConfig,
)

torch.set_num_threads(1)

PORT_NAMES = {"all-reduce-start.2": "c10d::allreduce_",
              "all-gather.9": "ncclDevKernel_AllGather_RING_LL",
              "reduce-scatter.4": "gloo:reduce_scatter",
              "all-to-all.1": "c10d::alltoall_base_"}


def _timeline(seed=0):
    """Two step windows of seeded compute and collective ops (us)."""
    rs = np.random.RandomState(seed)
    steps, ops = [], []
    t = 0.0
    for step in (3, 4):
        dur = float(rs.uniform(800, 1200))
        steps.append({"step": step, "ts": t, "dur": dur})
        for k in range(12):
            s = t + float(rs.uniform(-50, dur))
            name = (list(PORT_NAMES)[k % 4] if k % 3 == 0
                    else f"fusion.{k}")
            ops.append({"name": name, "ts": s,
                        "dur": float(rs.uniform(5, 300)), "tid": k % 2})
        t += dur + 100
    return {"steps": steps, "ops": ops}


def test_attribute_matches_jax_and_reads_port_names():
    parsed = _timeline()
    kw = dict(flops_per_step=2e9, peak_flops_per_chip=1e12, n_chips=2)
    got = obs_trace.attribute(parsed, **kw)
    assert got == jtrace.attribute(parsed, **kw)
    assert all(r["collective_s"] > 0 and r["compute_s"] > 0 for r in got)
    ported = {"steps": parsed["steps"], "ops": [
        {**o, "name": PORT_NAMES.get(o["name"], o["name"])}
        for o in parsed["ops"]]}
    assert obs_trace.attribute(ported, **kw) == got
    assert obs_trace.exposed_fraction(got) == jtrace.exposed_fraction(got)
    for name, fam in (("c10d::allreduce_", "all-reduce"),
                      ("c10d::_allgather_base_", "all-gather"),
                      ("c10d::allgather_into_tensor_coalesced_",
                       "all-gather"),
                      ("c10d::_reduce_scatter_base_", "reduce-scatter"),
                      ("c10d::reduce_scatter_tensor_coalesced_",
                       "reduce-scatter"),
                      ("ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                       "all-reduce"),
                      ("ncclDevKernel_SendRecv", "collective-permute"),
                      ("c10d::broadcast_", "broadcast"),
                      ("aten::mm", None), ("flash_fwd_sm90", None),
                      ("c10d::barrier", None)):
        assert obs_trace.collective_family(name) == fam, name
    for op, cat in (("c10d::allreduce_", "grad_allreduce"),
                    ("c10d::_allgather_base_", "param_allgather"),
                    ("c10d::_reduce_scatter_base_", "grad_reduce_scatter")):
        assert obs_trace.CATEGORY_BY_OP[op] == cat


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def test_parse_trace_reads_a_cuda_capture(tmp_path):
    ev = [
        _x("tadnn_step#1", "user_annotation", 0, 900),
        _x("tadnn_step#2", "user_annotation", 1000, 900),
        _x("tadnn_step#1", "gpu_user_annotation", 50, 800),
        _x("tadnn_step#2", "gpu_user_annotation", 1050, 700),
        _x("aten::mm", "cpu_op", 10, 20),
        _x("flash_fwd_sm90", "kernel", 60, 100),
        _x("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", 140, 200),
        _x("Memcpy HtoD", "gpu_memcpy", 400, 50),
        _x("flash_fwd_sm90", "kernel", 1100, 100),
        _x("c10d::allreduce_", "cpu_op", 100, 5,
           **{"Input Dims": [[[808]], [], []],
              "Input type": ["TensorList", "", ""]}),
        _x("nccl:all_reduce", "user_annotation", 101, 3,
           **{"Input Dims": [[808]], "Input type": ["c10::BFloat16"]}),
        _x("c10d::_allgather_base_", "cpu_op", 200, 5,
           **{"Input Dims": [[544], [272], [], []],
              "Input type": ["float", "float", "", "Scalar"]}),
        _x("c10d::_reduce_scatter_base_", "cpu_op", 1200, 5,
           **{"Input Dims": [[132], [264], []],
              "Input type": ["float", "float", ""]}),
        _x("c10d::_reduce_scatter_base_", "cpu_op", 5000, 5,
           **{"Input Dims": [[7], [14], []],
              "Input type": ["float", "float", ""]}),
    ]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    parsed = obs_trace.parse_trace(str(path))
    assert [(s["step"], s["ts"], s["dur"]) for s in parsed["steps"]] == [
        (1, 50, 800), (2, 1050, 700)]
    assert [o["name"] for o in parsed["ops"]] == [
        "flash_fwd_sm90", "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
        "Memcpy HtoD", "flash_fwd_sm90"]
    assert [c["bytes"] for c in parsed["collectives"]] == [
        808 * 2, 544 * 4, 132 * 4, 7 * 4]
    recs = obs_trace.attribute(parsed)
    assert recs[0]["collectives"] == {"all-reduce": pytest.approx(2e-4)}
    assert recs[0]["compute_s"] == pytest.approx(150e-6)
    assert recs[1]["collective_s"] == 0.0
    # per step, averaged over the two host windows; the op outside them
    # is not counted
    assert obs_trace.measured_collective_bytes(parsed) == {
        "all-gather": {"count": 0, "payload_bytes": 1088},
        "all-reduce": {"count": 0, "payload_bytes": 808},
        "reduce-scatter": {"count": 0, "payload_bytes": 264}}
    with journal.as_default(journal.Journal()) as j:
        xc = obs_trace.crosscheck_collectives(
            obs_trace.measured_collective_bytes(parsed),
            {"grad_allreduce": {"payload_bytes": 800},
             "param_allgather": {"payload_bytes": 4000}})
    assert [(c["category"], c["ratio"], c["within_2x"]) for c in xc] == [
        ("grad_allreduce", 1.01, True), ("param_allgather", 0.272, False),
        ("grad_reduce_scatter", None, False)]
    assert len(j.named("trace.collective")) == 3


def _gpt2_ad(**kw):
    return AutoDistribute(GPT2("test", vocab_size=128, max_seq_len=16),
                          optimizer=adamw(1e-2), loss_fn=next_token_loss,
                          device="cpu", **kw)


def test_trace_steps_on_gpt2_cpu(tmp_path):
    ad = _gpt2_ad()
    batch = SyntheticLM(vocab_size=128, seq_len=17, batch_size=2).batch(0)
    state = ad.init(torch.Generator().manual_seed(0), batch)
    state, _ = ad.step(state, batch)
    timeline = {}
    with journal.as_default(journal.Journal()) as j:
        state, recs = obs_trace.trace_steps(
            ad.step, state, batch, steps=2, first_step=1,
            logdir=str(tmp_path), flops_per_step=1e6, timeline=timeline)
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert r["wall_s"] > 0 and r["n_ops"] > 0
        assert 0 < r["compute_s"] <= r["wall_s"] + 1e-9
        assert r["collective_s"] == r["exposed_collective_s"] == 0.0
        assert r["measured_mfu"] > 0
    (path,) = {e["trace"] for e in j.named("trace.step")}
    assert path.endswith(".json.gz") and os.path.dirname(path) == str(
        tmp_path)
    assert len(timeline["host_steps"]) == 2
    assert obs_trace.measured_collective_bytes(timeline) == {}
    assert state.step == 3


RUNS = ({"name": "dp", "kw": {"strategy": "dp"}},
        {"name": "fsdp", "kw": {"strategy": "fsdp", "remat": False}},
        {"name": "fsdp-remat", "kw": {"strategy": "fsdp"}})
MODEL = {"size": "test", "vocab_size": 256, "max_seq_len": 32}


@pytest.fixture(scope="module")
def traced_gloo(tmp_path_factory):
    batch = {"tokens": np.random.RandomState(0).randint(
        0, 256, size=(4, 33)).astype(np.int32)}
    job = {"trace": {"model": MODEL, "batch": batch, "steps": 2,
                     "runs": RUNS}}
    return spawn(2, job, tmp_path_factory.mktemp("trace_gloo"))["trace"]


def test_gloo_collective_bytes_within_2x_of_the_model(traced_gloo):
    dp, fsdp, remat = (traced_gloo[r["name"]] for r in RUNS)
    assert dp["degrees"]["data"] == 2 and fsdp["degrees"]["fsdp"] == 2
    assert not fsdp["remat"] and remat["remat"]
    for run, cats in ((dp, ("grad_allreduce",)),
                      (fsdp, ("param_allgather", "grad_reduce_scatter"))):
        xc = {c["category"]: c for c in run["xc"]}
        for cat in cats:
            assert run["per_device"][cat] > 0
            assert xc[cat]["within_2x"], xc[cat]
        assert all(r["collective_s"] > 0 for r in run["recs"])
    assert {c["category"]: c["ratio"] for c in dp["xc"]}[
        "grad_allreduce"] == pytest.approx(1.0, abs=1e-3)
    assert "c10d::allreduce_" in dp["names"]
    assert {"c10d::_allgather_base_", "c10d::_reduce_scatter_base_"} <= set(
        fsdp["names"])
    # the loss-level recompute gathers every layer again
    ag = {c["category"]: c for c in remat["xc"]}["param_allgather"]
    assert ag["ratio"] > 2.0
    assert remat["journal"].count("trace.step") == 2


def test_comm_profile_equals_jax_on_two_devices(traced_gloo):
    sample = {"tokens": np.zeros((4, 33), np.int32)}
    for run in RUNS[:2]:
        ad = jtad.AutoDistribute(
            JGPT2(MODEL["size"], vocab_size=MODEL["vocab_size"],
                  max_seq_len=MODEL["max_seq_len"]),
            optimizer=optax.adamw(1e-3), loss_fn=jnext_token_loss,
            devices=jax.devices()[:2], **run["kw"])
        est = jcomms.comm_profile(ad, jax.random.key(0), sample)
        want = {k: v["payload_bytes"] for k, v in est["per_device"].items()}
        assert traced_gloo[run["name"]]["per_device"] == want, run["name"]


def _fit(tmp_path, steps, every, **cfg):
    losses = []
    j = journal.Journal()
    trainer = Trainer(
        _gpt2_ad(), TrainerConfig(steps=steps, log_every=0,
                                  trace_every_n=every, preflight=False,
                                  trace_dir=str(tmp_path), **cfg),
        journal=j,
        callbacks=[lambda i, s, m: losses.append(float(m["loss"]))])
    gen = torch.Generator().manual_seed(0)
    trainer.fit(SyntheticLM(vocab_size=128, seq_len=17, batch_size=2),
                rng=gen)
    return trainer, j, losses


def _jax_traced_steps(monkeypatch, steps, every):
    """The steps JAX's Trainer hands to trace_steps (the capture
    stubbed: the step runs once, unprofiled)."""
    from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
        SyntheticClassification,
    )
    from torch_automatic_distributed_neural_network_tpu.models import MLP
    from torch_automatic_distributed_neural_network_tpu.training import (
        Trainer as JTrainer,
    )
    from torch_automatic_distributed_neural_network_tpu.training import (
        TrainerConfig as JTrainerConfig,
    )
    from torch_automatic_distributed_neural_network_tpu.training import (
        softmax_xent_loss,
    )

    seen = []

    def fake(step_fn, state, batch, *, first_step, **kw):
        seen.append(first_step)
        return step_fn(state, batch)[0], []

    monkeypatch.setattr(jtrace, "trace_steps", fake)
    ad = jtad.AutoDistribute(MLP(features=(16, 10)),
                             optimizer=optax.sgd(0.1),
                             loss_fn=softmax_xent_loss,
                             devices=jax.devices()[:1])
    JTrainer(ad, JTrainerConfig(steps=steps, log_every=0,
                                trace_every_n=every, preflight=False),
             journal=jtad.obs.Journal(None)).fit(
        SyntheticClassification(batch_size=8))
    return seen


def test_trainer_traces_jax_steps_with_bitwise_losses(tmp_path,
                                                      monkeypatch):
    want = _jax_traced_steps(monkeypatch, 7, 3)
    trainer, j, traced = _fit(tmp_path / "a", 7, 3)
    assert [e["step"] for e in j.named("trace.step")] == want == [3, 6]
    assert not j.named("trace.error")
    assert trainer.goodput["seconds"]["trace"] > 0
    assert trainer.goodput["seconds"]["step"] > 0
    _, _, plain = _fit(tmp_path / "b", 7, 0)
    assert traced == plain and len(plain) == 7


def test_trainer_capture_failure_keeps_the_step(tmp_path, monkeypatch):
    _, _, plain = _fit(tmp_path / "plain", 5, 0)

    def broken_parse(path):
        raise RuntimeError("no timeline here")

    monkeypatch.setattr(obs_trace, "parse_trace", broken_parse)
    _, j, got = _fit(tmp_path / "after", 5, 2)
    errs = j.named("trace.error")
    assert [e["step"] for e in errs] == [2, 4]
    assert "no timeline here" in errs[0]["error"]
    assert got == plain  # the step ran once, its result kept
    monkeypatch.undo()

    def broken_enter(self):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(obs_trace.StepTracer, "__enter__", broken_enter)
    _, j, got = _fit(tmp_path / "before", 5, 2)
    assert len(j.named("trace.error")) == 2 and got == plain


def test_trace_and_profile_cli_on_cpu(tmp_path, capsys, monkeypatch):
    jpath = str(tmp_path / "j.jsonl")
    args = ["trace", "--device", "cpu", "--family", "mlp", "--size",
            "32,16,10", "--seq", "4", "--batch", "8", "--journal", jpath,
            "--logdir", str(tmp_path / "prof")]
    assert cli(args + ["--json"]) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(r["compute_s"] > 0 for r in recs)
    events = journal.Journal.read(jpath)
    assert [e["step"] for e in events if e["name"] == "trace.step"] == [
        1, 2, 3]
    assert cli(args + ["--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("traced 1 step(s) on 1 x ")
    assert "journal written to" in out
    assert cli(["trace", "notes.txt"]) == 2

    script = tmp_path / "script.py"
    script.write_text(
        "import os, sys\n"
        "from torch.profiler import record_function\n"
        "with record_function('user_region'):\n"
        "    print(os.environ['TADNN_TRACE_EVERY_N'], sys.argv[1:])\n")
    monkeypatch.delenv("TADNN_TRACE_EVERY_N", raising=False)
    monkeypatch.delenv("TADNN_JOURNAL", raising=False)
    assert cli(["trace", "--every", "4", str(script), "--", "x"]) == 0
    assert capsys.readouterr().out == "4 ['x']\n"
    logdir = tmp_path / "profile"
    assert cli(["profile", "--device", "cpu", "--logdir", str(logdir),
                str(script)]) == 0
    assert capsys.readouterr().out.endswith(
        f"profile trace written to {logdir}\n")
    (written,) = logdir.iterdir()
    with gzip.open(written, "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "user_region" in names
