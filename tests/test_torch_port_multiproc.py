"""The PyTorch port's Trainer across processes: 2 gloo ranks on the CPU
(``torch_port_multiproc_worker.py``, spawned once, ``file://``
rendezvous in the test's own directory, a timeout on every process)
against the JAX package in one process.

- The Trainer on 2 ranks under dp, each rank on its own rows
  (``shard_for_host``), starts from JAX's initial GPT-2 ``test`` weights
  (``interop``) and takes 5 steps on fresh ``SyntheticLM`` batches: its
  losses are within 2e-5 relative of JAX's single-process Trainer on the
  same global batches (the same fp32 arithmetic, summed in another order
  across ranks).
- The drain: rank 1 alone gets SIGTERM after step 3; with
  ``preempt_check_every=2`` both ranks agree at step 4, stop after it and
  save once (the step committed is 4, and only 4).
- The divergence check: a healthy dp state passes; a state whose rank-1
  copy of one parameter moved by 1e-3 trips it on both ranks; a healthy
  fsdp state passes although the ranks' local sums differ (each sums its
  shards, reduced over the shard group before the compare).
- A rollback on a NaN batch (step 5, a ``ShardedCheckpoint`` every 2
  steps) lands both ranks on one step: when rank 1's scan lags (it sees
  step 2 as the newest while rank 0 sees 4) both restore step 2, and
  when rank 1 alone finds step 4 corrupt both reject it (host 0
  quarantines it) and restore step 2; the ranks' losses stay equal.
- ``CheckpointManager`` (DCP, coordinated) and ``ShardedCheckpoint``
  (per process) round-trip the state bitwise on 2 ranks under dp and
  fsdp.
- The port's ``meta.json`` for GPT-2 ``test`` under fsdp on 2 ranks
  lists the same per-leaf shapes and dtypes as JAX's on 2 devices, the
  leaves mapped through ``interop``, and specs with the same mesh axes
  and per-device size (as ``test_torch_port_planner.py`` compares the
  planner's specs).
"""

import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticLM as JSyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2
from torch_automatic_distributed_neural_network_tpu.training import Trainer as JTrainer
from torch_automatic_distributed_neural_network_tpu.training import TrainerConfig as JTrainerConfig
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu.training.shards import (
    ShardedCheckpoint as JShardedCheckpoint,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import gpt2_config

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_port_multiproc_worker.py"
VOCAB, SEQ, BATCH, STEPS = 128, 33, 8, 5
CFG = dict(vocab_size=VOCAB, max_seq_len=64, dtype=torch.float32)
DATA = dict(vocab_size=VOCAB, seq_len=SEQ, batch_size=BATCH)


@functools.lru_cache(maxsize=None)
def _jax_model():
    return GPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32)


def _jax_ad(world, strategy="dp"):
    return JAutoDistribute(_jax_model(), optimizer=optax.adamw(1e-3),
                           loss_fn=jlosses.next_token_loss, strategy=strategy,
                           devices=jax.devices()[:world])


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    """JAX's Trainer in one process (2 devices) on the global batches:
    its initial weights and its per-step losses."""
    ad = _jax_ad(2)
    data = JSyntheticLM(**DATA)
    state = ad.init(jax.random.key(0), data.batch(0))
    params0 = jax.tree.map(np.asarray, state.params)
    losses = {}
    trainer = JTrainer(ad, JTrainerConfig(steps=STEPS, log_every=0,
                                          preflight=False),
                       callbacks=[lambda s, st, m: losses.__setitem__(
                           s, float(m["loss"]))])
    trainer.fit(data, state=state)
    return params0, [losses[i + 1] for i in range(STEPS)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results of one 2-rank gloo world."""
    tmp = tmp_path_factory.mktemp("multiproc")
    params0, _ = _jax_trainer()
    cfg = gpt2_config("test", **CFG)
    job = {"cfg": {f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
           "state_dict": decoder_from_jax_params(
               params0, cfg, device="cpu").state_dict(),
           "data": DATA, "steps": STEPS}
    job_path = tmp / "job.pt"
    torch.save(job, job_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(rank), "2", str(tmp / "pg"),
         str(job_path), str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    errors = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {rank} timed out (a hung collective)")
        if proc.returncode:
            errors.append(f"rank {rank}: rc {proc.returncode}\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_trainer_on_two_ranks_matches_jax(port):
    _, want = _jax_trainer()
    for rank in range(2):
        np.testing.assert_allclose(port[rank]["trainer"], want, rtol=2e-5,
                                   atol=0)
    assert port[0]["trainer"] == port[1]["trainer"]


def test_sigterm_on_one_rank_drains_both_after_the_same_step(port):
    for rank in range(2):
        d = port[rank]["drain"]
        assert d["stopped_after"] == 4, d
        assert d["last_loss_step"] == 4, d
        assert d["steps"] == [4], d  # one save: the drain's


def test_divergence_check_trips_on_a_perturbed_rank(port):
    for rank in range(2):
        d = port[rank]["divergence"]
        assert d["dp_perturbed"] is not None
        assert "Parameter divergence across hosts at step 1" in (
            d["dp_perturbed"])
    # fsdp: the ranks hold different shards (their local sums differ),
    # and the healthy state passed the check all the same
    assert (port[0]["divergence"]["fsdp_local_sum"]
            != port[1]["divergence"]["fsdp_local_sum"])


@pytest.mark.parametrize("case", ["lag", "verdict"])
def test_rollback_lands_both_ranks_on_one_step(port, case):
    r0, r1 = (port[rank]["rollback"][case] for rank in range(2))
    for r in (r0, r1):
        assert r["rollback"] == [{"at_step": 5, "to_step": 2}], str(r)
        assert r["final_step"] == 6
    assert r0["losses"] == r1["losses"]
    assert sorted(r0["losses"]) == [1, 2, 3, 4, 5, 6]
    assert all(math.isfinite(v) for s, v in r0["losses"].items() if s != 5)
    if case == "verdict":  # host 0 quarantined the step rank 1 rejected
        assert r0["corrupt"] == [4] and r1["corrupt"] == []
        assert "4.corrupt" in r0["dirs"]
    else:
        assert r0["corrupt"] == r1["corrupt"] == []


@pytest.mark.parametrize("case", ["dp_dcp", "dp_sharded", "fsdp_dcp",
                                  "fsdp_sharded"])
def test_checkpoints_round_trip_bitwise_on_two_ranks(port, case):
    for rank in range(2):
        r = port[rank]["roundtrip"][case]
        assert r["keys"] and r["moved"], r
        assert r["bitwise"], r
        assert r["step"] == 2


def test_sharded_meta_matches_jax(port, tmp_path):
    """Per leaf of the train state (parameters and both Adam moments):
    the shape after the interop mapping, the dtype, and the spec's mesh
    axes with the per-device size, as JAX's ``meta.json`` under fsdp on
    2 devices records them."""
    meta = port[0]["meta"]
    assert meta == port[1]["meta"]
    assert meta["world"] == 2 and meta["degrees"]["fsdp"] == 2
    ad = _jax_ad(2, "fsdp")
    state = ad.init(jax.random.key(0), JSyntheticLM(**DATA).batch(0))
    with JShardedCheckpoint(str(tmp_path / "jax")) as ck:
        ck.save(0, state)
        ck.wait()
    import json

    with open(tmp_path / "jax" / "0" / "meta.json") as f:
        jmeta = json.load(f)
    cfg = gpt2_config("test", **CFG)
    # map each JAX parameter leaf to its port name: the bridge on a tree
    # of distinct constants (one value a leaf) finds where each lands
    params = jax.tree.map(np.asarray, state.params)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(treedef, [
        np.full(v.shape, i + 1, np.float32) for i, (_, v) in enumerate(flat)])
    port_named = decoder_from_jax_params(tagged, cfg, device="cpu").state_dict()
    jname = {}
    for name, t in port_named.items():
        (i,) = {int(v) for v in torch.unique(t).tolist()}
        path = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in flat[i - 1][0])
        jname[name] = path
    jleaves, pleaves = jmeta["leaves"], meta["leaves"]

    def per_device(shape, spec, degrees):
        n = math.prod(shape)
        for e in spec:
            for a in (e if isinstance(e, list) else [e]):
                if a:
                    n //= degrees.get(a, 1)
        return n

    def axes(spec):
        return sorted(a for e in spec for a in (e if isinstance(e, list)
                                                else [e]) if a)

    # a JAX leaf stacked over the layers ([n_layers, ...], scanned) is
    # one port leaf a layer: compare a layer's share of it
    stacked = {j: list(jname.values()).count(j) for j in jname.values()}
    n = 0
    for pname, jpath in jname.items():
        k = stacked[jpath]
        for prefix in ("params/", "opt_state/0/mu/", "opt_state/0/nu/"):
            p, j = pleaves[prefix + pname], jleaves[prefix + jpath]
            n += 1
            if k > 1:
                assert j["shape"][0] == k, (pname, j)
            assert math.prod(p["shape"]) * k == math.prod(j["shape"]), pname
            assert tuple(p["shape"]) == tuple(
                port_named[pname].shape), pname
            assert p["dtype"] == j["dtype"], pname
            assert axes(p["spec"]) == axes(j["spec"]), (pname, p, j)
            assert per_device(p["shape"], p["spec"], meta["degrees"]) * k == (
                per_device(j["shape"], j["spec"], jmeta["degrees"])), pname
    assert n == 3 * len(port_named) and len(stacked) == len(flat), n
