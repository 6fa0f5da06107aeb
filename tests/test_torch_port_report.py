"""The port's ``obs/report.py`` and ``tadnn report`` against the JAX
package's, on the same inputs.

- One journal of real port records — a ``Trainer.fit`` with a metrics
  file, two profiler-traced steps and a checkpoint, ``tadnn serve
  --smoke`` on the CPU, the tuner's records, the collectives' crosscheck,
  the lint and protocol records and an SLO incident (what the fixture
  journals itself validated against the event schema) — is written
  again, record by record, through each package's ``Journal`` (one virtual
  clock each, so the ``t`` stamps agree) into its own directory with a
  copy of the metrics file.  ``generate`` gives equal dicts once the two
  directories' paths are normalised, and ``format_report`` equal text;
  so does ``tadnn report --json``, and ``--merge`` of two host journals.
- ``check_bench`` and ``check_simulate`` on synthetic bench records in
  ``tmp_path`` (fresh, stale, unmeasurable, regressed, missing, the
  serving trajectory armed; a serving record replayed within and outside
  the 2x band, a missing and an unreadable one) give JAX's exit codes and
  messages, and ``tadnn report --check`` / ``--check-simulate`` JAX's
  exit codes and lines.  No test reads the repository's bench records.

Exact equality throughout: the report is file parsing and arithmetic on
the same numbers.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu.obs import (
    journal as jjournal,
)
from torch_automatic_distributed_neural_network_tpu.obs import (
    report as jreport,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    AutoDistribute,
    SyntheticLM,
    adamw,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    analysis,
    tune,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    journal,
    report,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    trace as obs_trace,
)
from torch_automatic_distributed_neural_network_tpu_torch.topology import (
    parse_topology,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    CheckpointManager,
    MetricsLogger,
    Trainer,
    TrainerConfig,
)

torch.set_num_threads(1)


def _clock():
    """A virtual clock: 0.25 s a reading."""
    ticks = iter(range(10**9))
    return lambda: next(ticks) * 0.25


@pytest.fixture(scope="module")
def run_records(tmp_path_factory):
    """(records, metrics file) of a real port run on the CPU."""
    d = tmp_path_factory.mktemp("portrun")
    jpath, mpath = str(d / "journal.jsonl"), str(d / "metrics.jsonl")
    jnl = journal.Journal(jpath, validate=True)
    ad = AutoDistribute(GPT2("test", vocab_size=128, max_seq_len=16),
                        optimizer=adamw(1e-2), loss_fn=next_token_loss,
                        device="cpu")
    metrics = MetricsLogger(mpath, flops_per_step=1e9, console=False,
                            device="cpu")
    trainer = Trainer(
        ad, TrainerConfig(steps=5, log_every=1, ckpt_every=4,
                          trace_every_n=2, trace_dir=str(d / "profile"),
                          preflight=True),
        metrics=metrics, journal=jnl,
        ckpt=CheckpointManager(str(d / "ckpt"), device="cpu"))
    trainer.fit(SyntheticLM(vocab_size=128, seq_len=17, batch_size=2))
    trainer.ckpt.close()
    with journal.as_default(jnl):
        assert cli(["serve", "--smoke", "--device", "cpu",
                    "--journal", jpath]) == 0
        abstract = {f"w{i}": torch.empty(64, 64, device="meta")
                    for i in range(4)}
        tune.tune(abstract, parse_topology("cpu-8"),
                  policy=tune.TunePolicy(use_cache=False,
                                         act_profile=None))
        obs_trace.crosscheck_collectives(
            {"all-reduce": {"count": 4, "payload_bytes": 1000},
             "all-gather": {"count": 2, "payload_bytes": 5000}},
            {"grad_allreduce": {"payload_bytes": 990},
             "param_allgather": {"payload_bytes": 1500}})
        findings = [analysis.Finding("PC007", "warn", "protocol",
                                     "scheduler", "cap"),
                    analysis.Finding("SL003", "error", "source", "a.py:3",
                                     "bad")]
        analysis.journal_findings(findings, phase="check")
        jnl.event("lint.protocol", model="allocator", scope=1,
                  states=4776, transitions=22080, depth=15,
                  frontier_peak=757, wall_s=1.5, complete=True,
                  violations=0)
        jnl.event("slo.breach", window_start_s=10.0, window_end_s=15.0,
                  violating_windows=2, violations=["p99_ms<=10"])
        jnl.event("slo.recover", window_start_s=25.0, window_end_s=30.0,
                  ok_windows=2)
    jnl.close()
    return journal.Journal.read(jpath), mpath


def _write_both(records, metrics_path, tmp_path):
    """The records through each package's Journal, with the metrics
    file beside each; returns the two run directories."""
    dirs = []
    for name, jmod in (("port", journal), ("jax", jjournal)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(metrics_path, d / "metrics.jsonl")
        j = jmod.Journal(str(d / "journal.jsonl"), clock=_clock())
        for rec in records:
            if rec["name"] == "journal.start":
                continue
            fields = {k: v for k, v in rec.items()
                      if k not in ("kind", "name", "t", "wall", "depth")}
            j.event(rec["name"], **fields)
        j.close()
        dirs.append(d)
    return dirs


def _normalised(obj, d):
    return json.loads(json.dumps(obj).replace(str(d), "RUN"))


def test_generate_and_format_equal_jax(run_records, tmp_path):
    records, metrics_path = run_records
    names = {r["name"] for r in records}
    # the run wrote what the report's sections read
    assert {"plan", "comms.estimate", "trace.step", "trace.collective",
            "goodput", "serve.step", "serve.request_done", "tune.decision",
            "lint.summary", "lint.protocol", "ckpt.save"} <= names
    port_dir, jax_dir = _write_both(records, metrics_path, tmp_path)
    got = report.generate(str(port_dir))
    want = jreport.generate(str(jax_dir))
    assert _normalised(got, port_dir) == _normalised(want, jax_dir)
    assert got["trace"]["n_steps"] == 2
    text = report.format_report(got)
    assert text.replace(str(port_dir), "RUN") == jreport.format_report(
        want).replace(str(jax_dir), "RUN")
    assert "trace:" in text and "exposed-comm crosscheck" in text


def test_report_cli_equals_jax(run_records, tmp_path, capsys):
    records, metrics_path = run_records
    port_dir, jax_dir = _write_both(records, metrics_path, tmp_path)
    outs = []
    for main, d in ((cli, port_dir), (jcli.main, jax_dir)):
        assert main(["report", str(d), "--json"]) == 0
        outs.append(_normalised(json.loads(capsys.readouterr().out), d))
        assert main(["report", str(d / "journal.jsonl")]) == 0
        outs.append(capsys.readouterr().out.replace(str(d), "RUN"))
    assert outs[0] == outs[2] and outs[1] == outs[3]
    # per-host journals merged first, a straggler called out
    for main, d in ((cli, tmp_path / "mp"), (jcli.main, tmp_path / "mj")):
        d.mkdir()
        for host, wall in ((0, 0.010), (1, 0.016)):
            j = journal.Journal(str(d / f"journal.host{host}.jsonl"),
                                host0_only=False, meta={"host": host},
                                clock=_clock())
            for k in range(4):
                j.event("trace.step", step=k, wall_s=wall, trace="t")
            j.close()
        assert main(["report", str(d), "--merge"]) == 0
        outs.append(capsys.readouterr().out.replace(str(d), "RUN"))
    assert outs[4] == outs[5]
    assert "hosts: 2" in outs[4] and "straggler" in outs[4]


def _round(d, n, rec, prefix="BENCH", wrapped=True):
    payload = {"n": n, "cmd": "python bench.py", "rc": 0, "tail": "",
               "parsed": rec} if wrapped else rec
    (d / f"{prefix}_r{n:02d}.json").write_text(json.dumps(payload))


def _last_good(d, metric, value, name="BENCH_LAST_GOOD.json"):
    (d / name).write_text(json.dumps({"gpt2": {
        "result": {"metric": metric, "value": value, "unit": "t/s",
                   "vs_baseline": 1.0, "extra": {}},
        "measured_utc": "2026-07-31T01:04:15Z", "device_kind": "H100"}}))


def _bench_dirs(tmp_path):
    """Synthetic bench directories, one a case, from a seeded stream."""
    rs = np.random.RandomState(7)
    base = float(rs.uniform(500, 1500))
    cases = {
        "fresh": lambda d: (_last_good(d, "m", base),
                            _round(d, 6, {"metric": "m",
                                          "value": base * 0.95})),
        "stale": lambda d: (_last_good(d, "m", base), _round(d, 6, {
            "metric": "m_backend_unreachable", "value": 0.0,
            "status": "backend_unreachable", "stale": True,
            "stale_of": "r02"})),
        "unmeasurable": lambda d: (
            _round(d, 5, {"metric": "m", "value": base}),
            _round(d, 6, {"metric": "m_unmeasurable_down", "value": 0})),
        "regressed": lambda d: (_last_good(d, "m", base),
                                _round(d, 6, {"metric": "m",
                                              "value": base * 0.8})),
        "missing": lambda d: None,
        "unwrapped": lambda d: _round(d, 6, {"metric": "m", "value": 5.0},
                                      wrapped=False),
        "serve_armed": lambda d: (
            _last_good(d, "m", base),
            _round(d, 6, {"metric": "m", "value": base}),
            _last_good(d, "tok", 100.0, "SERVE_LAST_GOOD.json"),
            _round(d, 3, {"metric": "tok", "value": 70.0},
                   prefix="SERVE_BENCH")),
    }
    for name, make in cases.items():
        d = tmp_path / name
        d.mkdir()
        make(d)
        yield name, d


def test_check_bench_equals_jax(tmp_path, capsys):
    seen = {}
    for name, d in _bench_dirs(tmp_path):
        got = report.check_bench(str(d))
        assert got == jreport.check_bench(str(d)), name
        seen[name] = got[0]
        assert cli(["report", str(d), "--check"]) == got[0]
        port_out = capsys.readouterr().out
        assert jcli.main(["report", str(d), "--check"]) == got[0]
        assert port_out == capsys.readouterr().out
    assert seen == {"fresh": 0, "stale": 1, "unmeasurable": 1,
                    "regressed": 1, "missing": 1, "unwrapped": 0,
                    "serve_armed": 1}
    # explicit paths: one trajectory
    d = tmp_path / "fresh"
    kw = dict(bench_path=str(d / "BENCH_r06.json"),
              last_good_path=str(d / "BENCH_LAST_GOOD.json"))
    assert report.check_bench(str(d), **kw) == jreport.check_bench(
        str(d), **kw)


def _serve_record(d, n, value, **extra):
    rec = {"metric": "serve_tokens_per_s", "value": value, "extra": {
        "streams": 8, "max_new": 16, "prompt_len": 24, "slots": 4,
        "block_size": 8, "max_len": 64, "new_tokens": 128,
        "mean_occupancy": 0.9, "preemptions": 0,
        "breakdown": {"decode_step_ms": 4.0, "prefill_chunk_ms": 6.0},
        **extra}}
    _round(d, n, rec, prefix="SERVE_BENCH")


def test_check_simulate_equals_jax(tmp_path, capsys):
    cases = {"missing": lambda d: None,
             "unreadable": lambda d: (d / "SERVE_BENCH_r01.json")
             .write_text("{not json"),
             "within": lambda d: _serve_record(d, 2, 700.0),
             "outside": lambda d: _serve_record(d, 2, 9000.0,
                                                preemptions=40)}
    codes = {}
    for name, make in cases.items():
        d = tmp_path / name
        d.mkdir()
        make(d)
        with journal.as_default(journal.Journal()) as pj, \
                jjournal.as_default(jjournal.Journal()) as jj:
            got = report.check_simulate(str(d))
            want = jreport.check_simulate(str(d))
        assert got == want, name
        strip = ("t", "wall")
        assert [{k: v for k, v in r.items() if k not in strip}
                for r in pj.records] == [
            {k: v for k, v in r.items() if k not in strip}
            for r in jj.records]
        codes[name] = got[0]
        assert cli(["report", str(d), "--check-simulate"]) == got[0]
        port_out = capsys.readouterr().out
        assert jcli.main(["report", str(d), "--check-simulate"]) == got[0]
        assert port_out == capsys.readouterr().out
    assert codes == {"missing": 1, "unreadable": 1, "within": 0,
                     "outside": 1}
