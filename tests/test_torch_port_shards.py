"""The PyTorch port's per-process sharded checkpoints
(``training/shards.py``), per-host input slicing
(``data.shard_for_host``) and journal merge (``obs/aggregate.py``), in
one process against the JAX package.  The multi-process cases (2 and 4
gloo ranks, resharding across plans and worlds) are in
``test_torch_port_multiproc.py`` and ``test_torch_port_distributed.py``.

Tolerances: exact throughout — rows, merged records, leaf owners and
restored states are compared for equality (a checkpoint restores bytes,
never values near them).
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.data import (
    shard_for_host as jshard_for_host,
)
from torch_automatic_distributed_neural_network_tpu.obs import aggregate as jaggregate
from torch_automatic_distributed_neural_network_tpu.training import shards as jshards
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    AutoDistribute,
    SyntheticLM,
    adamw,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.data import (
    HostBatch,
    shard_for_host,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import Journal
from torch_automatic_distributed_neural_network_tpu_torch.obs import aggregate
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    resilience,
    shards,
)
from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
    ShardedCheckpoint,
    tear_shard,
)

BATCH = {"input_ids": np.arange(8 * 5, dtype=np.int32).reshape(8, 5),
         "mask": np.arange(8, dtype=np.float32)}


class _Mesh:
    """The three things ``shard_for_host`` reads off a DeviceMesh."""

    def __init__(self, degrees, rank):
        self.mesh_dim_names = tuple(degrees)
        self.shape = tuple(degrees.values())
        coords, r = {}, rank
        for name, n in reversed(degrees.items()):  # row-major ranks
            coords[name], r = r % n, r // n
        self._coords = coords

    def get_local_rank(self, name):
        return self._coords[name]


@pytest.mark.parametrize("count", [1, 2, 4])
def test_shard_for_host_rows_match_jax(count):
    for index in range(count):
        got = shard_for_host(BATCH, process_index=index, process_count=count)
        want = jshard_for_host(BATCH, process_index=index,
                               process_count=count)
        assert isinstance(got, HostBatch) and got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("degrees", [{"data": 4}, {"fsdp": 4},
                                     {"data": 2, "fsdp": 2}])
def test_shard_for_host_on_a_plans_mesh_matches_jax(degrees):
    """Every rank on the batch axes (dp, fsdp, the hybrid): the mesh's
    batch coordinate is the process index, rows as JAX's."""
    for rank in range(4):
        got = shard_for_host(BATCH, mesh=_Mesh(degrees, rank))
        want = jshard_for_host(BATCH, process_index=rank, process_count=4)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


def test_shard_for_host_under_a_tensor_axis_gives_the_batch_coordinates_rows():
    """A deliberate difference: on data 2 x tensor 2 the ranks of one
    tensor group hold the same rows (their data coordinate's half), where
    JAX's host feeds its devices and slices by process."""
    for rank in range(4):
        got = shard_for_host(BATCH, mesh=_Mesh({"data": 2, "tensor": 2},
                                               rank))
        want = jshard_for_host(BATCH, process_index=rank // 2,
                               process_count=2)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    with pytest.raises(ValueError, match="not divisible"):
        shard_for_host({"x": np.zeros((3, 2))}, process_index=0,
                       process_count=2)


def _journals(tmp_path):
    """Hand-written per-host journals: two hosts' steps interleaved on the
    wall clock, a torn line, host ids from meta and from the names."""
    d = tmp_path / "run"
    d.mkdir()
    recs = {
        "journal_host0.jsonl": [
            {"name": "journal.start", "kind": "event", "t": 0.0,
             "wall": 100.0, "host": 0},
            {"name": "trace.step", "kind": "event", "t": 1.0, "wall": 101.0,
             "wall_s": 0.5, "trace": "a"},
            {"name": "trace.step", "kind": "event", "t": 2.0, "wall": 103.0,
             "wall_s": 0.7, "trace": "b"}],
        "journal_host1.jsonl": [
            {"name": "trace.step", "kind": "event", "t": 5.0, "wall": 102.0,
             "wall_s": 0.6, "trace": "c"},
            {"name": "launch.step", "kind": "event", "t": 6.0, "wall": 104.0,
             "step": 1, "loss": 2.5}],
        "serve.p2.jsonl": [
            {"name": "serve.step", "kind": "event", "t": 0.5, "wall": 100.5}],
    }
    for name, rows in recs.items():
        with open(d / name, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            if name == "journal_host1.jsonl":
                f.write('{"name": "torn')
    (d / "journal.merged.jsonl").write_text("")
    (d / "notes.txt").write_text("not a journal")
    return str(d)


def test_aggregate_merges_like_jax(tmp_path):
    d = _journals(tmp_path)
    assert aggregate.find_host_journals(d) == jaggregate.find_host_journals(d)
    paths = aggregate.find_host_journals(d)
    with pytest.warns(UserWarning):
        got = aggregate.merge(paths)
    with pytest.warns(UserWarning):
        want = jaggregate.merge(paths)
    assert got == want
    assert [r["host"] for r in got] == [0, 2, 0, 1, 0, 1]
    mapping = {7: paths[0], 9: paths[2]}
    assert aggregate.merge(mapping) == jaggregate.merge(mapping)
    assert aggregate.host_skew(got) == jaggregate.host_skew(want)
    assert aggregate.host_skew(got)["n_hosts"] == 2
    out = aggregate.merge_run(d)  # the torn line warned above, once
    assert Journal.read(out) == got
    with pytest.raises(FileNotFoundError):
        aggregate.merge_run(str(tmp_path))


def _ad(precision="fp32"):
    return AutoDistribute(GPT2("test", vocab_size=128, max_seq_len=32),
                          optimizer=adamw(1e-2), loss_fn=next_token_loss,
                          device="cpu", precision=precision)


def _data():
    return SyntheticLM(vocab_size=128, seq_len=17, batch_size=2)


def _leaves(state):
    return {k: resilience.as_tensor(v).clone()
            for k, v in resilience.flatten_state(state).items()}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_sharded_roundtrip_same_plan_bitwise(tmp_path, precision):
    """One process: save, step on, restore: every leaf bitwise, bf16
    leaves through the npz as their raw bits with the dtype's name in
    ``meta.json``."""
    ad, data = _ad(precision), _data()
    state = ad.init(torch.Generator().manual_seed(0), data.batch(0))
    with ShardedCheckpoint(str(tmp_path / "ck")) as ck:
        state, _ = ad.step(state, data.batch(0))
        ck.save(1, state)
        ck.wait()
        want = _leaves(state)
        state, _ = ad.step(state, data.batch(1))
        assert ck.latest_step() == 1 and not ck.save(1, state)
        restored = ck.restore(state)
    ad.adopt_state(restored)
    got = _leaves(restored)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    meta = shards.read_meta(str(tmp_path / "ck"), 1)
    dtype = "bfloat16" if precision == "bf16" else "float32"
    assert meta["leaves"]["params/embed"]["dtype"] == dtype
    assert meta["world"] == 1 and meta["leaves"]["step"]["dtype"] == "int64"
    report = shards.verify_directory(str(tmp_path / "ck"))
    assert report["healthy"] and report["best_step"] == 1


def test_torn_shard_falls_back_one_step_and_journals(tmp_path):
    """The Trainer with a ShardedCheckpoint: step 4's shard torn, the
    resumed fit quarantines it (``ckpt.corrupt``), falls back exactly one
    save interval to step 2 and replays steps 3-4 bitwise."""
    def trainer(steps, journal=None):
        losses = {}
        t = Trainer(_ad(), TrainerConfig(steps=steps, log_every=0,
                                         ckpt_every=2, preflight=False),
                    ckpt=ShardedCheckpoint(str(tmp_path / "ck")),
                    callbacks=[lambda s, st, m: losses.__setitem__(
                        s, float(m["loss"]))], journal=journal)
        return t, losses

    first, want = trainer(4)
    first.fit(_data())
    first.ckpt.close()
    assert first.ckpt.all_steps() == [2, 4]
    assert tear_shard(str(tmp_path / "ck"), 4)
    assert not tear_shard(str(tmp_path / "ck"), 5)
    j = Journal()
    second, got = trainer(4, journal=j)
    state = second.fit(_data())
    second.ckpt.close()
    assert int(state.step) == 4
    assert sorted(got) == [3, 4]  # resumed at step 2: one interval lost
    assert got == {s: want[s] for s in (3, 4)}
    (corrupt,) = [r for r in j.records if r["name"] == "ckpt.corrupt"]
    assert corrupt["step"] == 4 and "checksum mismatch" in corrupt["reason"]
    assert os.path.isdir(tmp_path / "ck" / "4.corrupt")
    assert shards.list_complete_steps(str(tmp_path / "ck")) == [2, 4]


def test_logical_hosts_commit_only_when_every_host_landed(tmp_path):
    """JAX's logical-host mode in one process: each host persists the
    leaves it owns (the same stable hash as JAX's), the step commits once
    both markers exist, and it restores whole."""
    paths = [f"params/layers.{i}.w" for i in range(64)]
    assert ({p: shards._leaf_owner(p, 4) for p in paths}
            == {p: jshards._leaf_owner(p, 4) for p in paths})
    ad, data = _ad(), _data()
    state = ad.init(torch.Generator().manual_seed(0), data.batch(0))
    want = _leaves(state)
    d = str(tmp_path / "ck")
    with ShardedCheckpoint(d, host=1, world=2) as h1:
        h1.save(3, state)
        h1.wait()
    assert not shards.is_complete(d, 3)  # host 0 has not landed
    with ShardedCheckpoint(d, host=0, world=2) as h0:
        h0.save(3, state)
        h0.wait()
        assert shards.is_complete(d, 3) and h0.latest_step() == 3
        state, _ = ad.step(state, data.batch(0))
        restored = h0.restore(state)
    owned = [json.load(open(os.path.join(d, "3", f"host-{i}.json")))
             for i in range(2)]
    leaves = [{s["leaf"] for s in m["shards"]} for m in owned]
    assert leaves[0] and leaves[1] and not leaves[0] & leaves[1]
    assert leaves[0] | leaves[1] == set(want)
    got = _leaves(restored)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_doctor_reads_a_sharded_directory(tmp_path, capsys):
    ad, data = _ad(), _data()
    state = ad.init(torch.Generator().manual_seed(0), data.batch(0))
    d = str(tmp_path / "ck")
    with ShardedCheckpoint(d) as ck:
        for step in (1, 2):
            ck.save(step, state)
        ck.wait()
    assert cli(["doctor", d]) == 0
    assert "restore would resume from step 2" in capsys.readouterr().out
    tear_shard(d, 2)
    assert cli(["doctor", d, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert [s["ok"] for s in report["steps"]] == [False, True]
    tear_shard(d, 1)
    assert cli(["doctor", d]) == 1
