"""One rank of the PyTorch port's Trainer-across-processes tests on the
CPU (gloo).

Launched by ``tests/test_torch_port_multiproc.py``, one process a rank::

    python tests/torch_port_multiproc_worker.py <rank> <world> <init_file> \
        <job.pt> <out_dir>

``job.pt`` (``torch.save``) holds the model config's keyword arguments,
the starting ``state_dict`` (JAX's initial weights) and the step count.
In one gloo group this rank runs, in turn:

- ``trainer``: ``Trainer.fit`` under dp from those weights, each rank on
  its own rows of ``SyntheticLM``'s global batches (``shard_for_host``);
  the per-step losses;
- ``drain``: the same Trainer with a ``ShardedCheckpoint``; rank 1
  sends itself SIGTERM after step 3, ``preempt_check_every=2``; the
  step each rank stopped after and the committed steps;
- ``divergence``: ``Trainer._guard_divergence`` on a healthy state and
  on one whose rank-1 copy was perturbed, under dp; under fsdp on a
  healthy state whose ranks hold different shards;
- ``rollback``: the Trainer with a ``ShardedCheckpoint`` every 2 steps
  and a NaN batch at step 5, in two cases: rank 1's scan of the
  directory lags (it sees step 2 as the newest), and rank 1 alone finds
  step 4 corrupt; each rank's rollback record, journaled corrupt steps,
  the directory after the run and the per-step losses;
- ``roundtrip``: ``CheckpointManager`` and ``ShardedCheckpoint`` under dp
  and fsdp: save step 2, step on, restore step 2; the gathered state
  after the restore and at the save;
- ``meta``: the ``meta.json`` of a ``ShardedCheckpoint`` step saved
  under fsdp.

Every rank writes ``<out_dir>/rank<r>.pt``.  Imports torch, numpy and
the port only.
"""

import json
import os
import signal
import sys

import numpy as np
import torch

PORT = "torch_automatic_distributed_neural_network_tpu_torch"


def _ad(job, strategy):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        DecoderLM,
        TransformerConfig,
        adamw,
        next_token_loss,
    )

    model = DecoderLM(TransformerConfig(**job["cfg"]))
    model.load_state_dict(job["state_dict"])
    return AutoDistribute(model, optimizer=adamw(1e-3),
                          loss_fn=next_token_loss, device="cpu",
                          strategy=strategy)


class _Rows:
    """Step-indexed: this rank's rows of the global batches."""

    step_indexed = True

    def __init__(self, job):
        from torch_automatic_distributed_neural_network_tpu_torch.data import (
            SyntheticLM,
        )

        self._data = SyntheticLM(**job["data"])

    def batch(self, i):
        from torch_automatic_distributed_neural_network_tpu_torch.data import (
            shard_for_host,
        )

        return shard_for_host(self._data.batch(i))


def _trainer(job, out_dir, **cfg):
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        Trainer,
        TrainerConfig,
    )

    ad = _ad(job, "dp")
    data = _Rows(job)
    losses = {}

    def record(step, state, metrics):
        losses[step] = float(metrics["loss"])

    trainer = Trainer(ad, TrainerConfig(log_every=0, preflight=False, **cfg),
                      callbacks=[record], **job.get("trainer_kw", {}))
    return ad, data, trainer, losses


def _gathered(state):
    from torch_automatic_distributed_neural_network_tpu_torch.models.transformer_core import (
        gathered,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        resilience,
    )

    return {k: gathered(resilience.as_tensor(v)).detach().clone()
            for k, v in resilience.flatten_state(state).items()}


def run_trainer(job, out_dir):
    ad, data, trainer, losses = _trainer(job, out_dir, steps=job["steps"])
    trainer.fit(data, state=ad.init(None, data.batch(0)))
    return [losses[i + 1] for i in range(job["steps"])]


def run_drain(job, out_dir, rank):
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    ckpt = ShardedCheckpoint(os.path.join(out_dir, "drain"))
    ad, data, trainer, losses = _trainer(
        job, out_dir, steps=8, preempt_check_every=2)
    trainer.ckpt = ckpt

    def sigterm(step, state, metrics):
        if rank == 1 and step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.callbacks.append(sigterm)
    state = trainer.fit(data, state=ad.init(None, data.batch(0)))
    ckpt.wait()
    torch.distributed.barrier()  # the saves are per process: all landed
    return {"stopped_after": int(state.step), "steps": ckpt.all_steps(),
            "last_loss_step": max(losses)}


def run_divergence(job, out_dir, rank):
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        Trainer,
        TrainerConfig,
    )

    out = {}
    for strategy in ("dp", "fsdp"):
        ad = _ad(job, strategy)
        data = _Rows(job)
        state = ad.init(None, data.batch(0))
        state, _ = ad.step(state, data.batch(0))
        trainer = Trainer(ad, TrainerConfig(divergence_every=1))
        trainer._guard_divergence(state, 1)  # healthy: no raise
        local = sum(float((p.to_local() if hasattr(p, "to_local") else p)
                          .abs().sum()) for p in state.params.values())
        out[f"{strategy}_local_sum"] = local
        if strategy == "dp":
            with torch.no_grad():
                if rank == 1:
                    state.params["embed"].add_(1e-3)
            try:
                trainer._guard_divergence(state, 1)
                out["dp_perturbed"] = None
            except RuntimeError as e:
                out["dp_perturbed"] = str(e)
    return out


class _PoisonedRows(_Rows):
    """This rank's rows of the global batches with a float ``mask`` of
    ones, all NaN in batch ``nan_at`` (the loss reads it)."""

    def __init__(self, job, nan_at):
        super().__init__(job)
        self._nan_at = nan_at

    def batch(self, i):
        from torch_automatic_distributed_neural_network_tpu_torch.data import (
            shard_for_host,
        )

        b = dict(self._data.batch(i))
        fill = float("nan") if i == self._nan_at else 1.0
        b["mask"] = np.full(b["input_ids"].shape, fill, np.float32)
        return shard_for_host(b)


def run_rollback(job, out_dir, rank):
    from torch_automatic_distributed_neural_network_tpu_torch.obs import (
        Journal,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        AnomalyConfig,
        Trainer,
        TrainerConfig,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training.resilience import (
        CheckpointCorruptError,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    out = {}
    for case in ("lag", "verdict"):
        d = os.path.join(out_dir, f"rollback_{case}")
        ckpt = ShardedCheckpoint(d)
        save = ckpt.save

        def landed_save(*a, _save=save, _ckpt=ckpt, **kw):
            # every rank's files land before the run goes on, so that
            # the case, not a race of the writers, decides what is seen
            done = _save(*a, **kw)
            _ckpt.wait()
            torch.distributed.barrier()
            return done

        ckpt.save = landed_save
        if rank == 1 and case == "lag":
            latest, wait, lag = ckpt.latest_step, ckpt.wait, []

            def lagging_latest(_latest=latest, _ckpt=ckpt, _lag=lag):
                if _lag == [True]:  # once: the first scan of the walk
                    _lag.append(False)
                    return min(_ckpt.all_steps())
                return _latest()

            def marking_wait(_wait=wait, _lag=lag):
                _wait()
                if not _lag:  # the rollback's wait, before its walk
                    _lag.append(True)

            ckpt.latest_step, ckpt.wait = lagging_latest, marking_wait
        if rank == 1 and case == "verdict":
            checked, failed = ckpt._checked, []

            def failing(state, step, *a, _checked=checked, _failed=failed):
                if step == 4 and not _failed:
                    _failed.append(step)
                    raise CheckpointCorruptError("rank 1 alone: step 4")
                return _checked(state, step, *a)

            ckpt._checked = failing
        ad = _ad(job, "dp")
        data = _PoisonedRows(job, nan_at=4)  # step 5's batch
        losses = {}
        journal = Journal(host0_only=False)
        trainer = Trainer(
            ad, TrainerConfig(steps=6, ckpt_every=2, log_every=0,
                              preflight=False,
                              anomaly=AnomalyConfig(min_history=2)),
            ckpt=ckpt, journal=journal,
            callbacks=[lambda s, st, m: losses.__setitem__(
                s, float(m["loss"]))])
        state = trainer.fit(data, state=ad.init(None, data.batch(0)))
        ckpt.close()
        torch.distributed.barrier()
        out[case] = {
            "rollback": [{k: r[k] for k in ("at_step", "to_step")}
                         for r in journal.named("resilience.rollback")],
            "corrupt": [r["step"] for r in journal.named("ckpt.corrupt")],
            "dirs": sorted(os.listdir(d)),
            "losses": losses,
            "final_step": int(state.step),
        }
    return out


def run_roundtrip(job, out_dir):
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        CheckpointManager,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    out = {}
    for strategy in ("dp", "fsdp"):
        for kind, make in (("dcp", lambda d: CheckpointManager(d,
                                                               device="cpu")),
                           ("sharded", ShardedCheckpoint)):
            ad = _ad(job, strategy)
            data = _Rows(job)
            state = ad.init(None, data.batch(0))
            ckpt = make(os.path.join(out_dir, f"rt_{strategy}_{kind}"))
            for i in range(3):
                state, _ = ad.step(state, data.batch(i))
                if i == 1:
                    ckpt.save(2, state)
                    ckpt.wait()
                    saved = _gathered(state)
            changed = _gathered(state)
            state = ckpt.restore(state, step=2)
            ad.adopt_state(state)
            ckpt.close()
            got = _gathered(state)
            out[f"{strategy}_{kind}"] = {
                "bitwise": all(torch.equal(saved[k], got[k]) for k in saved),
                "moved": any(not torch.equal(saved[k], changed[k])
                             for k in saved if k.startswith("params/")),
                "step": state.step,
                "keys": sorted(saved) == sorted(got),
            }
    return out


def run_meta(job, out_dir, rank):
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    ad = _ad(job, "fsdp")
    data = _Rows(job)
    state = ad.init(None, data.batch(0))
    d = os.path.join(out_dir, "meta")
    with ShardedCheckpoint(d) as ckpt:
        ckpt.save(0, state)
        ckpt.wait()
    torch.distributed.barrier()
    with open(os.path.join(d, "0", "meta.json")) as f:
        return json.load(f)


def main(rank, world, init_file, job_path, out_dir):
    from torch_automatic_distributed_neural_network_tpu_torch import topology

    torch.set_num_threads(1)
    topology.initialize_distributed(
        backend="gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank)
    job = torch.load(job_path, weights_only=False)
    out = {"trainer": run_trainer(job, out_dir)}
    out["drain"] = run_drain(job, out_dir, rank)
    out["divergence"] = run_divergence(job, out_dir, rank)
    out["rollback"] = run_rollback(job, out_dir, rank)
    out["roundtrip"] = run_roundtrip(job, out_dir)
    out["meta"] = run_meta(job, out_dir, rank)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
