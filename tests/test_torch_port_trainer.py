"""The port's ``Trainer`` stack on the CPU against the JAX package's:

- GPT-2 ``test`` (vocab 512, seq 64), ``SyntheticLM``, ``adamw(1e-3)``,
  the same weights carried through ``interop``: the two Trainers' six
  step losses agree within 1e-4 (the tolerance of the ``AutoDistribute``
  trajectory test in ``test_torch_port_train.py``: fp32, the same
  arithmetic in another order), and their metrics records have the same
  keys;
- ``train_state_from_jax`` continues a JAX run: three more port steps
  give the JAX run's losses within 1e-4;
- an anomaly rollback on a ``ChaosData`` NaN batch lands on the same
  batch offset, rollback record and final step as the JAX Trainer's
  (exact: they are counters);
- port-only, exact: a run killed by ``FaultInjector`` and resumed under
  ``run_with_recovery`` ends bitwise equal to an uninterrupted run; a
  preemption drain saves and resumes; the ``train_gpt2`` example runs on
  the CPU; ``doctor`` exits 0 on a healthy chain and 1 when every step
  is torn (the assertions of the JAX package's
  ``tests/test_resilience.py`` doctor tests).
"""

import os
import signal
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import (
    AutoDistribute as JAutoDistribute,
)
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticLM as JSyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.training import (
    losses as jlosses,
)
from torch_automatic_distributed_neural_network_tpu.training import (
    metrics as jmetrics,
)
from torch_automatic_distributed_neural_network_tpu.training import (
    resilience as jres,
)
from torch_automatic_distributed_neural_network_tpu.training import (
    trainer as jtrainer,
)
from torch_automatic_distributed_neural_network_tpu.training.checkpoint import (
    CheckpointManager as JCheckpointManager,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    AutoDistribute,
    SyntheticLM,
    adamw,
    next_token_loss,
    write_token_file,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.examples import (
    train_gpt2,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    train_state_from_jax,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import Journal
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    AnomalyConfig,
    ChaosData,
    ChaosPlan,
    CheckpointManager,
    FaultInjector,
    MetricsLogger,
    PreemptionGuard,
    RestartPolicy,
    StallError,
    Trainer,
    TrainerConfig,
    run_with_recovery,
    tear_checkpoint,
)
from torch_automatic_distributed_neural_network_tpu_torch.training.elastic import (
    InjectedFault,
)

VOCAB, SEQ, BATCH, STEPS = 512, 64, 4, 6


def _jax_data():
    return JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ + 1, batch_size=BATCH)


def _jax_ad(seq=SEQ):
    jm = JGPT2("test", vocab_size=VOCAB, max_seq_len=seq,
               dtype=jnp.float32)
    return JAutoDistribute(jm, optimizer=optax.adamw(1e-3),
                           loss_fn=jlosses.next_token_loss,
                           devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's six steps from ``key(0)``: the initial
    parameters, each step's loss, the state after step 3 (numpy) and the
    metrics file."""
    metrics_path = str(tmp_path_factory.mktemp("jax") / "metrics.jsonl")
    jad = _jax_ad()
    data = _jax_data()
    state = jad.init(jax.random.key(0), data.batch(0))
    params0 = jax.tree.map(np.asarray, state.params)
    losses, at3 = [], {}

    def cb(step, st, m):
        losses.append(float(m["loss"]))
        if step == 3:  # before the next step donates these buffers
            at3["state"] = types.SimpleNamespace(
                step=np.asarray(st.step),
                params=jax.tree.map(np.asarray, st.params),
                opt_state=jax.tree.map(np.asarray, st.opt_state))

    logger = jmetrics.MetricsLogger(metrics_path, items_name="tokens",
                                    flops_per_step=1e9, console=False)
    trainer = jtrainer.Trainer(
        jad, jtrainer.TrainerConfig(steps=STEPS, log_every=1,
                                    preflight=False),
        metrics=logger, items_per_step=BATCH * SEQ, callbacks=[cb])
    trainer.fit(data, state=state)
    return params0, losses, at3["state"], metrics_path


def _port_ad(params, seq=SEQ):
    cfg = gpt2_config("test", vocab_size=VOCAB, max_seq_len=seq,
                      dtype=torch.float32)
    return AutoDistribute(decoder_from_jax_params(params, cfg, device="cpu"),
                          optimizer=adamw(1e-3), loss_fn=next_token_loss,
                          device="cpu")


def _records(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


def test_trainer_losses_match_jax(jax_run, tmp_path_factory):
    params0, jax_losses, _, jpath = jax_run
    ad = _port_ad(params0)
    data = SyntheticLM(vocab_size=VOCAB, seq_len=SEQ + 1, batch_size=BATCH)
    state = ad.init(None, data.batch(0))
    losses = []
    tpath = str(tmp_path_factory.mktemp("port") / "metrics.jsonl")
    j = Journal()
    trainer = Trainer(
        ad, TrainerConfig(steps=STEPS, log_every=1),
        metrics=MetricsLogger(tpath, items_name="tokens", flops_per_step=1e9,
                              console=False, device="cpu"),
        items_per_step=BATCH * SEQ, journal=j,
        callbacks=[lambda s, st, m: losses.append(float(m["loss"]))])
    state = trainer.fit(data, state=state)
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jax_losses, atol=1e-4, rtol=0)
    port_recs, jax_recs = _records(tpath), _records(jpath)
    assert [r["step"] for r in port_recs] == [r["step"] for r in jax_recs]
    assert [sorted(r) for r in port_recs] == [sorted(r) for r in jax_recs]
    np.testing.assert_allclose([r["loss"] for r in port_recs], jax_losses,
                               atol=1e-4, rtol=0)
    # the run's events: preflight skipped naming its item, plan, goodput
    (lint,) = j.named("lint.skipped")
    assert "Queue 1 item 7" in lint["error"]
    (start,) = j.named("run_start")
    # every mesh axis, as the JAX trainer journals its Mesh's degrees
    assert start["strategy"] == "dp" and start["mesh"] == {
        "pipe": 1, "data": 1, "fsdp": 1, "expert": 1, "seq": 1, "tensor": 1}
    good = trainer.goodput
    assert good["seconds"]["compile"] > 0 and good["seconds"]["step"] > 0
    assert sum(good["fractions"].values()) == pytest.approx(1.0)
    assert j.named("run_end")[0]["stop_step"] == STEPS


def test_train_state_from_jax_continues_a_jax_run(jax_run):
    _, jax_losses, at3, _ = jax_run
    cfg = gpt2_config("test", vocab_size=VOCAB, max_seq_len=SEQ,
                      dtype=torch.float32)
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        DecoderLM,
    )

    ad = AutoDistribute(DecoderLM(cfg), optimizer=adamw(1e-3),
                        loss_fn=next_token_loss, device="cpu")
    state = train_state_from_jax(ad, at3)
    assert state.step == 3
    assert state.opt_state[0]["count"] == state.opt_state[2]["count"] == 3
    data = SyntheticLM(vocab_size=VOCAB, seq_len=SEQ + 1, batch_size=BATCH)
    losses = []
    for i in range(3, STEPS):
        state, m = ad.step(state, data.batch(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_losses[3:], atol=1e-4, rtol=0)


class _MaskedLM:
    """SyntheticLM batches with an all-ones float ``mask``: the leaf a
    ChaosData NaN poisons (both packages' next_token_loss read it)."""

    step_indexed = True

    def __init__(self, seq):
        self.lm = JSyntheticLM(vocab_size=VOCAB, seq_len=seq + 1,
                               batch_size=2)

    def batch(self, i):
        ids = self.lm.batch(i)["input_ids"]
        return {"input_ids": ids, "mask": np.ones(ids.shape, np.float32)}


def test_anomaly_rollback_matches_jax(tmp_path):
    seq, steps = 16, 8
    plan_kw = dict(nan_at=(5,))
    cfg_kw = dict(steps=steps, log_every=0, ckpt_every=2)
    from torch_automatic_distributed_neural_network_tpu.obs import (
        Journal as JJournal,
    )

    jjournal = JJournal()
    jt = jtrainer.Trainer(
        _jax_ad(seq), jtrainer.TrainerConfig(
            anomaly=jres.AnomalyConfig(min_history=2), preflight=False,
            **cfg_kw),
        ckpt=JCheckpointManager(str(tmp_path / "jax"),
                                save_interval_steps=0),
        journal=jjournal)
    jstate = jt.fit(jres.ChaosData(_MaskedLM(seq), jres.ChaosPlan(**plan_kw)))
    jt.ckpt.close()

    j = Journal()
    ad = AutoDistribute(GPT2("test", vocab_size=VOCAB, max_seq_len=seq),
                        optimizer=adamw(1e-3), loss_fn=next_token_loss,
                        device="cpu")
    t = Trainer(ad, TrainerConfig(anomaly=AnomalyConfig(min_history=2),
                                  **cfg_kw),
                ckpt=CheckpointManager(str(tmp_path / "port"),
                                       device="cpu"),
                journal=j)
    state = t.fit(ChaosData(_MaskedLM(seq), ChaosPlan(**plan_kw)))
    t.ckpt.close()

    keys = ("reason", "at_step", "to_step", "skipped_batches",
            "batch_offset", "rollback")
    (rb,) = j.named("resilience.rollback")
    (jrb,) = [r for r in jjournal.records
              if r["name"] == "resilience.rollback"]
    assert {k: rb[k] for k in keys} == {k: jrb[k] for k in keys} == {
        "reason": "non-finite", "at_step": 6, "to_step": 4,
        "skipped_batches": 2, "batch_offset": 2, "rollback": 1}
    assert t._batch_offset == jt._batch_offset == 2
    assert state.step == int(jstate.step) == steps
    assert all(torch.isfinite(p).all() for p in state.params.values())
    # the offset is saved with the checkpoints after the rollback
    assert t.ckpt.restore_config(8)["_batch_offset"] == 2


def _tiny_trainer(ckpt_dir, steps, **kw):
    ad = AutoDistribute(GPT2("test", vocab_size=256, max_seq_len=16),
                        optimizer=adamw(1e-2), loss_fn=next_token_loss,
                        device="cpu")
    cfg = dict(steps=steps, log_every=0, ckpt_every=2)
    cfg.update(kw.pop("cfg", {}))
    return Trainer(ad, TrainerConfig(**cfg),
                   ckpt=CheckpointManager(str(ckpt_dir), device="cpu"), **kw)


def _tiny_data():
    return SyntheticLM(vocab_size=256, seq_len=17, batch_size=2)


def test_kill_and_resume_ends_bitwise_equal(tmp_path):
    clean = _tiny_trainer(tmp_path / "clean", 8)
    want = clean.fit(_tiny_data())
    clean.ckpt.close()

    j = Journal()
    fault = FaultInjector(5)
    killed = _tiny_trainer(tmp_path / "killed", 8, callbacks=[fault],
                           journal=j)
    restarts = []
    got = run_with_recovery(
        lambda: killed.fit(_tiny_data()),
        policy=RestartPolicy(max_restarts=2, backoff_base_s=0.0),
        on_restart=lambda n, e: restarts.append(type(e)))
    killed.ckpt.close()
    assert fault.fired and restarts == [InjectedFault]
    assert got.step == want.step == 8
    for name, p in want.params.items():
        assert torch.equal(got.params[name], p), name
    for key in ("mu", "nu"):
        for name, t in want.opt_state[0][key].items():
            assert torch.equal(got.opt_state[0][key][name], t), name
    assert got.opt_state[0]["count"] == 8 and got.seed == want.seed
    starts = [r["start_step"] for r in j.named("run_start")]
    assert starts == [0, 4]  # the restart resumed from step 4's save


def test_preemption_drain_saves_and_resumes(tmp_path):
    holder = {}

    def request_at_3(step, state, metrics):
        if step == 3:
            holder["trainer"].preempt.request()

    j = Journal()
    trainer = _tiny_trainer(tmp_path, 8, callbacks=[request_at_3],
                            journal=j)
    holder["trainer"] = trainer
    state = trainer.fit(_tiny_data())
    assert state.step == 3
    assert trainer.ckpt.latest_step() == 3
    (drain,) = j.named("preempt.drain")
    assert drain["step"] == 3 and drain["saved"]
    trainer.callbacks.clear()
    state = trainer.fit(_tiny_data())
    assert state.step == 8
    assert [r["start_step"] for r in j.named("run_start")] == [0, 3]
    trainer.ckpt.close()


def test_preemption_guard_chains_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested
        assert seen == [signal.SIGUSR1]  # the outer handler still runs
        guard.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is not guard._on_signal
    finally:
        signal.signal(signal.SIGUSR1, prev)
    # off the main thread install is a no-op
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "g", PreemptionGuard(signals=(signal.SIGUSR1,)).install()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and out["g"]._prev == {}


def test_stall_escalator_raises_in_training_thread():
    trainer = Trainer(None, TrainerConfig(watchdog_timeout_s=1.0))
    escalate = trainer._stall_escalator()  # bound to this thread
    threading.Timer(0.2, escalate, args=(9.9,)).start()
    with pytest.raises(StallError):
        for _ in range(200):  # the async exception lands between bytecodes
            time.sleep(0.05)


def test_what_is_not_ported_raises(tmp_path, monkeypatch):
    trainer = _tiny_trainer(tmp_path / "a", 2,
                            cfg=dict(preflight_action="raise"))
    with pytest.raises(NotImplementedError, match="item 7"):
        trainer.fit(_tiny_data())
    trainer = _tiny_trainer(tmp_path / "b", 2, cfg=dict(trace_every_n=1))
    with pytest.raises(NotImplementedError, match="item 7"):
        trainer.fit(_tiny_data())
    # parallel.strategy reaches AutoDistribute; the Trainer across
    # several processes is what raises (the launcher, item 3b)
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        trainer as trainer_mod,
    )

    monkeypatch.setattr(trainer_mod, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 3b"):
        train_gpt2.main(["model.size=test", "run.device=cpu",
                         "model.seq_len=16", "model.vocab_size=64",
                         "run.batch_size=2", "parallel.strategy=fsdp"])
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="item 3"):
        cli(["doctor", "--launch-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 7"):
        cli(["doctor", "--gateway-dir", str(tmp_path)])


def test_example_runs_on_the_cpu_and_doctor_reads_its_chain(tmp_path,
                                                           capsys):
    corpus = str(tmp_path / "corpus.bin")
    write_token_file(corpus, np.tile(
        np.random.RandomState(0).randint(0, 256, size=64), 40))
    ckpt = str(tmp_path / "ckpt")
    out = train_gpt2.main([
        "model.size=test", "model.seq_len=16", "model.vocab_size=256",
        "run.steps=4", "run.batch_size=2", "run.log_every=1",
        "run.device=cpu", f"run.ckpt_dir={ckpt}", "run.ckpt_every=2",
        "run.max_restarts=1", f"data.path={corpus}",
        f"run.metrics_path={tmp_path / 'metrics.jsonl'}"])
    printed = capsys.readouterr().out
    assert out["state"].step == 4 and out["data"].backend in ("native",
                                                               "numpy")
    # every mesh axis, as the JAX example prints its Mesh's degrees
    assert ("plan: dp mesh={'pipe': 1, 'data': 1, 'fsdp': 1, 'expert': 1, "
            "'seq': 1, 'tensor': 1}") in printed
    assert "final_step=4" in printed
    assert len(_records(str(tmp_path / "metrics.jsonl"))) == 4
    # doctor on the healthy chain
    assert cli(["doctor", ckpt]) == 0
    text = capsys.readouterr().out
    assert "fallback chain" in text and "ok, verified" in text
    assert "resume from step 4" in text
    # every step torn: nonzero, and an empty directory too
    for step in (2, 4):
        tear_checkpoint(ckpt, step)
    assert cli(["doctor", ckpt]) == 1
    text = capsys.readouterr().out
    assert "CORRUPT" in text and "NO restorable step" in text
    os.makedirs(tmp_path / "empty")
    assert cli(["doctor", str(tmp_path / "empty")]) == 1
