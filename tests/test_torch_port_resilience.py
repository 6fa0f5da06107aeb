"""The port's resilience helpers, config overrides, goodput meter and
journal against the JAX package's on the same inputs.  Everything here is
host arithmetic on exact values (hashes, counters, schedules), so the
comparisons are exact; the goodput fractions are compared within 1e-12
(the same float sums in the same order)."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.obs import goodput as jgoodput
from torch_automatic_distributed_neural_network_tpu.obs import journal as jjournal
from torch_automatic_distributed_neural_network_tpu.training import (
    resilience as jres,
)
from torch_automatic_distributed_neural_network_tpu.utils import config as jconfig
from torch_automatic_distributed_neural_network_tpu_torch.core import TrainState
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    GoodputMeter,
    Journal,
    as_default,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    journal as tjournal,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    resilience as tres,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import (
    config as tconfig,
)


def test_restart_policy_matches_jax():
    kw = dict(max_restarts=3, window_s=10.0, backoff_base_s=0.5,
              backoff_factor=3.0, backoff_max_s=20.0, jitter=0.25, seed=11)
    port, ref = tres.RestartPolicy(**kw), jres.RestartPolicy(**kw)
    assert [port.delay_s(n) for n in range(1, 9)] == [
        ref.delay_s(n) for n in range(1, 9)]
    times = [0.0, 1.0, 2.0, 12.5, 13.0, 13.5, 14.0, 30.0]
    assert [port.note_failure(t) for t in times] == [
        ref.note_failure(t) for t in times]
    assert port.recent_failures == ref.recent_failures
    no_jitter = dict(kw, jitter=0.0)
    assert (tres.RestartPolicy(**no_jitter).delay_s(3)
            == jres.RestartPolicy(**no_jitter).delay_s(3) == 4.5)


def test_anomaly_guard_matches_jax_on_a_spike_and_a_nan():
    rs = np.random.RandomState(0)
    losses = list(3.0 - 0.01 * np.arange(20) + 0.02 * rs.randn(20))
    losses[12] = 9.0            # a spike
    losses[15] = float("nan")   # a NaN
    losses[17] = float("inf")
    cfg = dict(window=8, spike_sigma=4.0, min_history=5)
    port = tres.AnomalyGuard(tres.AnomalyConfig(**cfg))
    ref = jres.AnomalyGuard(jres.AnomalyConfig(**cfg))
    got = [port.check(x) for x in losses]
    assert got == [ref.check(x) for x in losses]
    assert got[12] == "spike" and got[15] == got[17] == "non-finite"
    assert list(port._window) == list(ref._window)


def test_chaos_plan_fires_match_jax():
    kw = dict(seed=5, exception_at=(3,), nan_at=(7, 9), p_exception=0.2,
              p_torn_ckpt=0.5, p_nan=0.1, p_stall=0.3, p_sigkill=0.05)
    port, ref = tres.ChaosPlan(**kw), jres.ChaosPlan(**kw)
    for kind in ("exception", "torn_ckpt", "nan", "stall", "sigkill",
                 "journal_partition", "shard_tear"):
        got = [port.fires(kind, s) for s in range(200)]
        assert got == [ref.fires(kind, s) for s in range(200)], kind
    assert port.fires("exception", 3) and port.fires("nan", 9)


def _tree(root):
    for i, rel in enumerate(("state/.metadata", "state/__0_0.distcp",
                             "config", "state/extra/x.bin")):
        path = os.path.join(root, "12", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(bytes(range(256)) * (i + 1))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_tear_checkpoint_tears_the_same_files_as_jax(tmp_path, fraction):
    """DCP's hidden ``.metadata`` is torn too (os.walk, not a glob)."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    _tree(port)
    _tree(ref)
    n = tres.tear_checkpoint(port, 12, seed=3, fraction=fraction)
    assert n == jres.tear_checkpoint(ref, 12, seed=3, fraction=fraction)

    def sizes(root):
        return {os.path.relpath(os.path.join(d, f), root):
                os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(root) for f in fs}

    assert sizes(port) == sizes(ref)
    if fraction == 1.0:
        assert n == 4 and sizes(port)["12/state/.metadata"] == 256 // 3


@dataclasses.dataclass(frozen=True)
class _Inner:
    size: str = "small"
    seq_len: int = 512
    lr: float = 3e-4


@dataclasses.dataclass(frozen=True)
class _Cfg:
    model: _Inner = _Inner()
    extra: dict = dataclasses.field(default_factory=lambda: {"a": 1})
    kind: type = int
    tags: tuple = ("x", 2)


def test_apply_overrides_matches_jax():
    overrides = ["model.size=test", "model.seq_len=64", "model.lr=1e-3",
                 "extra.b=[1, 2]", "extra.a=hello world"]
    port = tconfig.apply_overrides(_Cfg(), overrides)
    assert port == jconfig.apply_overrides(_Cfg(), overrides)
    assert port.model.seq_len == 64 and port.extra["b"] == [1, 2]
    assert tconfig.to_dict(port) == jconfig.to_dict(port)
    assert tconfig.to_json(port) == jconfig.to_json(port)
    for bad, err in ((["model.depth=3"], KeyError), (["model"], ValueError),
                     (["model.size.x=1"], KeyError)):
        with pytest.raises(err):
            tconfig.apply_overrides(_Cfg(), bad)
        with pytest.raises(err):
            jconfig.apply_overrides(_Cfg(), bad)


def test_goodput_meter_matches_jax_on_a_fake_clock(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    port, ref = GoodputMeter(), jgoodput.GoodputMeter()
    for bucket, dt in (("compile", 2.5), ("step", 0.25), ("step", 0.25),
                       ("input_stall", 0.125), ("checkpoint", 1.0),
                       ("eval", 0.5)):
        for meter in (port, ref):
            t0 = now[0]
            with meter.measure(bucket):
                now[0] = t0 + dt
            now[0] = t0  # both meters see the same interval
        now[0] += dt + 0.0625  # unclaimed time goes to idle
    for meter in (port, ref):
        meter.add("step", -1.0)  # clamped at 0, as in JAX
    a, b = port.summary(), ref.summary()
    assert a["seconds"] == b["seconds"]
    for k in a["fractions"]:
        assert a["fractions"][k] == pytest.approx(b["fractions"][k],
                                                  abs=1e-12)
    assert a["goodput"] == pytest.approx(0.5 / a["total_wall_s"], abs=1e-12)
    with pytest.raises(ValueError, match="unknown goodput bucket"):
        port.add("compute", 1.0)


def _state():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=g),
              "b": torch.randn(3, generator=g).to(torch.bfloat16)}
    opt = ({"count": 3, "mu": {n: p * 0.5 for n, p in params.items()},
            "nu": {n: p * p for n, p in params.items()}}, (), {"count": 3})
    return TrainState(step=3, params=params, opt_state=opt, seed=123)


def test_manifest_round_trips_and_one_flipped_bit_is_detected(tmp_path):
    state = _state()
    leaves = tres.flatten_state(state)
    assert sorted(leaves) == [
        "opt_state/0/count", "opt_state/0/mu/b", "opt_state/0/mu/w",
        "opt_state/0/nu/b", "opt_state/0/nu/w", "opt_state/2/count",
        "params/b", "params/w", "seed", "step"]
    path = tres.write_manifest(str(tmp_path), 3, state)
    assert os.path.basename(path) == "manifest-3.json"
    doc = tres.read_manifest(str(tmp_path), 3)
    assert doc["step"] == 3 and doc["version"] == tres.MANIFEST_VERSION
    assert doc["leaves"]["params/b"]["dtype"] == "bfloat16"
    assert doc["leaves"]["step"] == {
        "sha256": doc["leaves"]["step"]["sha256"], "shape": [],
        "dtype": "int64"}
    assert tres.verify_tree(state, doc) == []
    # the same checksums from the named host leaves
    assert tres.leaf_checksums(leaves) == doc["leaves"]
    flipped = state.params["b"].view(torch.int16).clone()
    flipped[1] ^= 1  # one bit of one bf16 element
    state.params["b"] = flipped.view(torch.bfloat16)
    assert tres.verify_tree(state, doc) == ["checksum mismatch at params/b"]
    state.seed = 124
    assert "checksum mismatch at seed" in tres.verify_tree(state, doc)
    del state.params["w"]
    assert "missing leaf params/w" in tres.verify_tree(state, doc)
    # a torn manifest reads as no manifest
    with open(path, "r+b") as f:
        f.truncate(10)
    assert tres.read_manifest(str(tmp_path), 3) is None


def test_list_and_quarantine_match_jax(tmp_path):
    for root in ("port", "jax"):
        for name in ("2", "4", "10", "6.corrupt", "8.tmp-99", "x"):
            os.makedirs(tmp_path / root / name)
        (tmp_path / root / "manifest-4.json").write_text("{}")
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tres.list_steps(port) == jres.list_steps(ref) == [2, 4, 10]
    j = Journal()
    with as_default(j):
        dst = tres.quarantine_step(port, 4, reason="torn")
    assert os.path.basename(dst) == os.path.basename(
        jres.quarantine_step(ref, 4, reason="torn")) == "4.corrupt"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert [r["quarantined"] for r in j.named("ckpt.corrupt")] == [
        "4.corrupt"]


def test_chaos_data_poisons_float_leaves_of_the_scheduled_steps():
    class Src:
        step_indexed = True

        def batch(self, i):
            return {"ids": np.full((2, 3), i, np.int32),
                    "mask": np.ones((2, 3), np.float32),
                    "w": torch.ones(2)}

    data = tres.ChaosData(Src(), tres.ChaosPlan(nan_at=(2,)))
    clean, bad = data.batch(1), data.batch(2)
    assert np.isfinite(clean["mask"]).all()
    assert np.isnan(bad["mask"]).all() and torch.isnan(bad["w"]).all()
    np.testing.assert_array_equal(bad["ids"], 2)
    with pytest.raises(ValueError, match="step-indexed"):
        tres.ChaosData([1, 2], tres.ChaosPlan())


def test_journal_reader_matches_jax_on_torn_lines(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with Journal(path) as j:
        j.event("a.one", x=1)
        with j.span("a.two"):
            pass
    with open(path, "a") as f:
        f.write('[1, 2]\n{"kind": "event", "name": "torn"')
    with pytest.warns(UserWarning, match="skipped 2"):
        got = tjournal.Journal.read(path)
    with pytest.warns(UserWarning, match="skipped 2"):
        want = jjournal.Journal.read(path)
    assert got == want
    assert [r["name"] for r in got] == ["journal.start", "a.one", "a.two"]


def test_journal_rotation_taps_and_defaults(tmp_path, monkeypatch):
    path = str(tmp_path / "r.jsonl")
    monkeypatch.setenv("TADNN_JOURNAL_MAX_BYTES", "400")
    seen = []
    j = Journal(path)
    j.subscribe(lambda rec: seen.append(rec["name"]))
    for i in range(12):
        j.event("tick", i=i, pad="x" * 40)
    j.close()
    assert j.rotations >= 2
    assert os.path.exists(path + ".1")
    head = json.loads(open(path).readline())
    assert head["name"] == "journal.rotated"
    assert seen.count("tick") == 12
    # the module-level event/span write to the installed default only
    mem = Journal()
    with as_default(mem):
        tjournal.event("ckpt.save", step=1)
        with tjournal.span("ckpt.restore", step=1):
            pass
    tjournal.event("nowhere")
    assert [r["name"] for r in mem.named("ckpt")] == ["ckpt.save",
                                                     "ckpt.restore"]
    assert mem.named("ckpt.save")[0]["step"] == 1
