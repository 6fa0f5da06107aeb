"""The port's BASELINE examples of this slice on the CPU, against the JAX
package where they compute the same thing:

- ``examples/train_llama_fsdp.py`` at ``model.size=test`` (S 64, B 4)
  for 3 steps: the plan is JAX's (``fsdp``, remat on), its three losses
  are JAX's ``next_token_loss`` before each of three ``optax.adamw``
  steps from the same carried weights on the same batches, and its
  ``flops_per_step`` is JAX's formula (``transformer_step_flops``, times
  8/6 under remat);
- ``examples/train_resnet_cifar.py`` at ``model.arch=thin`` for 3 steps:
  ``dp``, and its losses and running statistics bitwise those of
  ``AutoDistribute`` with ``sgd(0.1, momentum=0.9)`` and
  ``softmax_xent_loss_mutable`` from the Trainer's seed on the same
  batches (the path ``test_torch_port_resnet.py`` holds to JAX).

Tolerance: the Llama losses in fp32 compute on both sides (the
example's bf16 Llama swapped for the fp32 one: bf16's rounding, 1.1e-4
relative, would hide most faults), 1e-5 relative (2e-7 measured on the
CPU: the same fp32 arithmetic in another order); the updates move the
second and third losses by 2.6e-3 and 1.0e-2 from those at the initial
weights (JAX, lr 0 against 3e-4), 35 and 140 times the bound, so the
gradients and the update are held too; the flops exactly (the same
integers).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.models import Llama as JLlama
from torch_automatic_distributed_neural_network_tpu.models import llama_config as jllama_config
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu.training import (
    transformer_step_flops as jflops,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    SyntheticClassification,
    SyntheticLM,
    interop,
    sgd,
    softmax_xent_loss_mutable,
)
from torch_automatic_distributed_neural_network_tpu_torch.examples import (
    train_llama_fsdp,
    train_resnet_cifar,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    Llama,
    ResNet18Thin,
    llama_config,
)

SEQ, BATCH, LR = 64, 4, 3e-4  # LR: the example's default run.lr
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if "step_time_s" in r]


def _jax_adamw_losses(jm, params, batches, lr):
    """JAX's next-token loss of each batch before each ``optax.adamw``
    step from ``params``: what JAX's AutoDistribute on one device logs."""
    loss_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jlosses.next_token_loss(
            p, b, None, lambda q, *a, **k: jm.apply({"params": q}, *a,
                                                    **k))[0]))
    tx = optax.adamw(lr)
    opt, losses = tx.init(params), []
    for b in batches:
        loss, grads = loss_and_grad(params, {"input_ids": b["input_ids"]})
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses


def test_llama_fsdp_example_matches_jax(tmp_path, capsys, monkeypatch):
    """The example's three logged losses against JAX's three adamw steps
    from the same carried weights on the same batches, both computing in
    fp32 (the example's Llama is swapped for the fp32-compute one; bf16
    rounding would hide a wrong model near ln V at random init)."""
    data = SyntheticLM(vocab_size=1024, seq_len=SEQ + 1, batch_size=BATCH)
    batches = [data.batch(i) for i in range(3)]
    jm = JLlama("test", max_seq_len=SEQ, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(batches[0]["input_ids"][:, :-1]))[
            "params"])
    want = _jax_adamw_losses(jm, params, batches, LR)
    fp32 = dict(max_seq_len=SEQ, dtype=torch.float32)
    carried = interop.decoder_from_jax_params(
        params, llama_config("test", **fp32), device="cpu")
    monkeypatch.setattr(train_llama_fsdp, "Llama",
                        lambda size, **kw: Llama(size, **{**kw, **fp32}))
    path = tmp_path / "metrics.jsonl"
    out = train_llama_fsdp.main(
        ["model.size=test", f"model.seq_len={SEQ}", f"run.batch_size={BATCH}",
         "run.steps=3", "run.log_every=1", f"run.metrics_path={path}",
         "run.device=cpu"], data=data,
        init_fn=lambda model, gen: model.load_state_dict(
            carried.state_dict()))
    assert "plan: fsdp" in capsys.readouterr().out
    ad = out["trainer"].ad
    assert (ad.plan.strategy, ad.remat) == ("fsdp", True)
    assert ad.model.cfg.dtype == torch.float32
    records = _records(path)
    assert len(records) == 3 and int(out["state"].step) == 3
    np.testing.assert_allclose([r["loss"] for r in records], want,
                               rtol=LOSS_RTOL, atol=0)
    tokens = BATCH * SEQ
    flops = jflops(jllama_config("test", max_seq_len=SEQ).num_params(),
                   tokens) * 8.0 / 6.0
    assert out["trainer"].metrics.flops_per_step == flops


def test_resnet_cifar_example_trains_with_batchnorm(tmp_path):
    """The example's three logged losses and final running statistics
    are those of ``AutoDistribute`` stepping ResNet18Thin from the
    Trainer's seed with ``sgd(0.1, momentum=0.9)`` and the mutable loss
    on the same batches (the path ``test_torch_port_resnet.py`` holds to
    JAX): the same arithmetic, so bitwise."""
    data = SyntheticClassification(image_shape=(16, 16, 3), num_classes=10,
                                   batch_size=16)
    path = tmp_path / "metrics.jsonl"
    out = train_resnet_cifar.main(
        ["model.arch=thin", "run.batch_size=16", "run.steps=3",
         "run.log_every=1", f"run.metrics_path={path}", "run.device=cpu"],
        data=data)
    ad, state = out["trainer"].ad, out["state"]
    assert ad.plan.strategy == "dp" and int(state.step) == 3
    assert len(state.model_state) == 30
    assert state.opt_state[0]["trace"].keys() == state.params.keys()
    records = _records(path)
    assert len(records) == 3 and records[0]["images_per_sec"] > 0
    ref = AutoDistribute(ResNet18Thin(num_classes=10),
                         optimizer=sgd(0.1, momentum=0.9),
                         loss_fn=softmax_xent_loss_mutable, device="cpu")
    ref_state = ref.init(torch.Generator().manual_seed(0), data.batch(0))
    losses = []
    for i in range(3):
        ref_state, m = ref.step(ref_state, data.batch(i))
        losses.append(float(m["loss"]))
    assert [r["loss"] for r in records] == losses
    for name, t in ref_state.model_state.items():
        assert torch.equal(state.model_state[name], t), name
    assert any(float(t.abs().sum()) > 0 for n, t in state.model_state.items()
               if n.endswith(".mean"))


def test_examples_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((train_llama_fsdp.main, ["model.size=test"]),
                       (train_resnet_cifar.main, ["model.arch=thin"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
