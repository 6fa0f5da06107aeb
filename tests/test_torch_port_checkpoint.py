"""The port's checkpoint layer (``training/checkpoint.py``) on the CPU:
save and restore of a GPT-2 ``test`` train state are bitwise (every
tensor ``torch.equal``, every int equal); a torn step is quarantined and
the fallback chain lands on an older one bitwise, or on a fresh init when
every step is torn; ``max_to_keep``, the save refusals and
``restore_config`` behave as the JAX package's Orbax manager does; and
the asynchronous save writes the state as it was when ``save``
returned."""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.training import (
    checkpoint as jckpt,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    AutoDistribute,
    SyntheticLM,
    adamw,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    Journal,
    as_default,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    CheckpointManager,
    resilience,
    restore_or_init,
    tear_checkpoint,
)

VOCAB, SEQ, BATCH = 256, 16, 2


def _data():
    return SyntheticLM(vocab_size=VOCAB, seq_len=SEQ + 1, batch_size=BATCH)


def _ad():
    return AutoDistribute(GPT2("test", vocab_size=VOCAB, max_seq_len=SEQ),
                          optimizer=adamw(1e-2), loss_fn=next_token_loss,
                          device="cpu")


def _trained(steps=2, seed=0):
    ad = _ad()
    state = ad.init(torch.Generator().manual_seed(seed))
    for i in range(steps):
        state, _ = ad.step(state, _data().batch(i))
    return ad, state


def _snapshot(state):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in resilience.flatten_state(state).items()}


def _assert_bitwise(state, snap):
    got = resilience.flatten_state(state)
    assert got.keys() == snap.keys()
    for k, v in snap.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def test_save_and_restore_are_bitwise(tmp_path):
    ad, state = _trained(3)
    snap = _snapshot(state)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.save(3, state, config={"lr": 1e-2})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["3", "manifest-3.json"]
    assert sorted(os.listdir(tmp_path / "3")) == ["config", "state"]
    assert sorted(os.listdir(tmp_path / "3" / "state")) == [
        ".metadata", "__0_0.distcp"]
    # restore into a state that has moved on: every leaf comes back
    state, _ = ad.step(state, _data().batch(7))
    state.seed = 99
    j = Journal()
    with as_default(j):
        restored = mgr.restore(state)
    _assert_bitwise(restored, snap)
    assert restored.step == 3 and restored.opt_state[0]["count"] == 3
    # written in place: the module computes with the restored weights
    for name, p in ad.model.named_parameters():
        assert p is restored.params[name]
    (span,) = j.named("ckpt.restore")
    assert span["verified"] and span["bytes"] > 0
    assert resilience.verify_directory(str(tmp_path))["steps"][0][
        "verified"]
    mgr.close()


def test_torn_latest_is_quarantined_and_the_chain_falls_back(tmp_path):
    ad, state = _trained(2)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(2, state)
    want = _snapshot(state)
    mgr.wait()
    state, _ = ad.step(state, _data().batch(2))
    state, _ = ad.step(state, _data().batch(3))
    mgr.save(4, state)
    mgr.close()
    assert tear_checkpoint(str(tmp_path), 4) == 3  # .metadata, data, config
    j = Journal()
    with as_default(j):
        ad2 = _ad()
        mgr2 = CheckpointManager(str(tmp_path), device="cpu")
        restored, resumed = restore_or_init(
            ad2, mgr2, torch.Generator().manual_seed(5), _data().batch(0))
    assert resumed and restored.step == 2
    _assert_bitwise(restored, want)
    assert sorted(os.listdir(tmp_path)) == [
        "2", "4.corrupt", "manifest-2.json", "manifest-4.json.corrupt"]
    (ev,) = j.named("ckpt.corrupt")
    assert ev["step"] == 4 and ev["quarantined"] == "4.corrupt"
    assert ev["reason"].startswith("UnpicklingError")  # torn .metadata
    assert mgr2.all_steps() == [2]


@pytest.mark.parametrize("torn", [".metadata", "__0_0.distcp"])
def test_each_torn_file_is_a_restore_error(tmp_path, torn):
    """What DCP raises on a torn file is in RESTORE_ERRORS: the chain
    quarantines the step instead of crashing (a torn ``.distcp`` comes
    as CheckpointException, which is not an Exception)."""
    _, state = _trained(1)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, state)
    mgr.wait()
    path = tmp_path / "1" / "state" / torn
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)
    with pytest.raises(resilience.RESTORE_ERRORS) as err:
        mgr.restore(state)
    assert not isinstance(err.value, resilience.CheckpointCorruptError)
    verdict = resilience.verify_step(str(tmp_path), 1)
    assert not verdict["ok"] and "restore failed" in verdict["problems"][0]


def test_a_flipped_bit_on_disk_fails_verification(tmp_path):
    _, state = _trained(1)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, state)
    mgr.wait()
    keep = _snapshot(state)
    data = tmp_path / "1" / "state" / "__0_0.distcp"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 2] ^= 0x10  # inside some tensor's bytes
    data.write_bytes(bytes(raw))
    with pytest.raises(resilience.CheckpointCorruptError,
                       match="checksum mismatch"):
        mgr.restore(state)
    _assert_bitwise(state, keep)  # untouched by the failed restore


def test_every_step_torn_starts_fresh(tmp_path):
    _, state = _trained(2)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, state)
    mgr.save(2, state)
    mgr.close()
    for step in (1, 2):
        tear_checkpoint(str(tmp_path), step)
    fresh_ad = _ad()
    fresh = _snapshot(fresh_ad.init(torch.Generator().manual_seed(3)))
    ad = _ad()
    mgr2 = CheckpointManager(str(tmp_path), device="cpu")
    state, resumed = restore_or_init(ad, mgr2, torch.Generator()
                                     .manual_seed(3), None)
    assert not resumed and state.step == 0
    _assert_bitwise(state, fresh)
    assert mgr2.latest_step() is None
    assert sorted(os.listdir(tmp_path)) == [
        "1.corrupt", "2.corrupt", "manifest-1.json.corrupt",
        "manifest-2.json.corrupt"]


def _jax_manager_steps(directory, steps, max_to_keep):
    """The JAX package's manager on a small tree: saved flags, kept
    steps, and the config it restores."""
    mgr = jckpt.CheckpointManager(directory, max_to_keep=max_to_keep)
    tree = {"w": jnp.arange(6.0).reshape(2, 3)}
    saved = [mgr.save(s, tree, config={"step": s, "name": "run"})
             for s in steps]
    mgr.wait()
    out = (saved, mgr.all_steps(), mgr.restore_config(steps[-1]),
           mgr.restore_config())
    mgr.close()
    return out


def test_max_to_keep_save_refusals_and_config_match_jax(tmp_path):
    steps = [1, 2, 3, 3, 2, 5]  # a repeated and an older step are refused
    want = _jax_manager_steps(str(tmp_path / "jax"), steps, max_to_keep=2)
    _, state = _trained(0)
    mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=2,
                            device="cpu")
    saved = [mgr.save(s, state, config={"step": s, "name": "run"})
             for s in steps]
    mgr.wait()
    got = (saved, mgr.all_steps(), mgr.restore_config(steps[-1]),
           mgr.restore_config())
    assert got == want == ([True, True, True, False, False, True], [3, 5],
                           {"step": 5, "name": "run"},
                           {"step": 5, "name": "run"})
    assert sorted(n for n in os.listdir(tmp_path / "port")
                  if n.startswith("manifest")) == [
        "manifest-3.json", "manifest-5.json"]
    # a config saved as None restores as {} (JAX: JsonSave({})); a torn
    # one is journaled and reads as None
    mgr.save(6, state)
    assert mgr.restore_config(6) == {}
    mgr.close()
    with open(tmp_path / "port" / "6" / "config", "r+b") as f:
        f.truncate(1)
    j = Journal()
    with as_default(j):
        assert mgr.restore_config(6) is None
    assert j.named("ckpt.restore_config_failed")[0]["step"] == 6
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(6, state, force=True)
    assert CheckpointManager(str(tmp_path / "none"),
                             device="cpu").restore_config() is None


def test_in_place_changes_after_save_do_not_reach_the_checkpoint(tmp_path):
    ad, state = _trained(1)
    want = _snapshot(state)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, state)
    # the very next step writes the same tensors while the writer runs
    with torch.no_grad():
        for t in resilience.flatten_state(state).values():
            if isinstance(t, torch.Tensor):
                t.add_(1)
    state, _ = ad.step(state, _data().batch(1))
    mgr.wait()
    _assert_bitwise(mgr.restore(state), want)
    with open(resilience.manifest_path(str(tmp_path), 1)) as f:
        doc = json.load(f)
    assert doc["leaves"] == resilience.leaf_checksums(want)


def test_restore_refuses_a_state_of_another_shape(tmp_path):
    _, state = _trained(1)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, state)
    mgr.wait()
    other = AutoDistribute(GPT2("test", vocab_size=VOCAB + 1,
                                max_seq_len=SEQ), optimizer=adamw(1e-2),
                           loss_fn=next_token_loss, device="cpu")
    other_state = other.init(torch.Generator().manual_seed(1))
    keep = _snapshot(other_state)
    with pytest.raises(ValueError, match="leaf"):
        mgr.restore(other_state)
    _assert_bitwise(other_state, keep)
    other_state.params.pop("embed")
    with pytest.raises(KeyError, match="unexpected"):
        mgr.restore(other_state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty"), device="cpu").restore(
            state)


def test_restore_under_mixed_precision_refreshes_the_module(tmp_path):
    """Under ``mixed`` the state holds fp32 masters and the module their
    bf16 copy: a resumed run computes with the restored weights, exactly
    their bf16 rounding."""
    def mixed_ad():
        return AutoDistribute(GPT2("test", vocab_size=VOCAB,
                                   max_seq_len=SEQ), optimizer=adamw(1e-2),
                              loss_fn=next_token_loss, device="cpu",
                              precision="mixed")

    ad = mixed_ad()
    state = ad.init(torch.Generator().manual_seed(0))
    for i in range(2):
        state, _ = ad.step(state, _data().batch(i))
    want = _snapshot(state)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(2, state)
    mgr.close()
    ad2 = mixed_ad()
    restored, resumed = restore_or_init(
        ad2, CheckpointManager(str(tmp_path), device="cpu"),
        torch.Generator().manual_seed(9), None)
    assert resumed
    _assert_bitwise(restored, want)
    for name, p in ad2.model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, restored.params[name].to(torch.bfloat16)), name
