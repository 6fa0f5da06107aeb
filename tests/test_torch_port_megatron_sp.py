"""Megatron-SP in the PyTorch port (``parallel/context.py``: the
residual stream between the blocks carries each tensor rank's slice of
the sequence) against the JAX package's ``tp`` run, whose
``ParallelContext.megatron_sp`` is on by default
(``tests/test_megatron_sp.py``).

GPT-2 ``test`` (fp32, dropout 0), adamw(1e-3), 5 steps of 8 x 33 tokens
on 2 gloo ranks (one spawn of ``tests/torch_port_dist_worker.py``) from
JAX's ``tp`` initial weights on 2 devices: ``tp`` with Megatron-SP on
and off, and ``tp_fsdp`` with it on.  The losses within 2e-5 relative of
JAX's (the same fp32 arithmetic, summed in another order across ranks);
with it on, every step reduce-scatters (the o and MLP-down projections'
exits) and all-gathers more than with it off, with it off it
reduce-scatters nothing; the split layers' norm parameters are the ones
whose gradients are summed over ``tensor``.  In one process: the
context's split degree follows JAX's ``seq_spec_entry`` (tensor on, off,
trivial, under a pipe axis), and a forward outside a step's context
(``ad(state, x)``, decoding) runs the plain tensor-parallel path.
"""

import functools
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
from torch_automatic_distributed_neural_network_tpu.parallel import context as jpctx
from torch_automatic_distributed_neural_network_tpu.topology import (
    build_mesh as jbuild_mesh,
)
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import gpt2_config
from torch_automatic_distributed_neural_network_tpu_torch.parallel import (
    context as tpctx,
)

from torch_port_spawn import spawn

VOCAB, SEQ, BATCH, STEPS = 128, 33, 8, 5
CFG = dict(vocab_size=VOCAB, max_seq_len=64, dtype=torch.float32)
RUNS = [dict(name="tp-sp", strategy="tp", inspect=True),
        dict(name="tp-no-sp", strategy="tp", inspect=True,
             kw=dict(megatron_sp=False)),
        dict(name="tp_fsdp-sp", strategy="tp_fsdp")]


def _batches():
    data = JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ, batch_size=BATCH)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def jax_tp():
    """JAX's ``tp`` on 2 devices: its initial parameters and losses."""
    ad = JAutoDistribute(
        GPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32),
        optimizer=optax.adamw(1e-3), loss_fn=jlosses.next_token_loss,
        strategy="tp", devices=jax.devices()[:2])
    batches = _batches()
    state = ad.init(jax.random.key(0), batches[0])
    params0 = jax.tree.map(np.asarray, state.params)
    losses = []
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
    return params0, losses


@functools.lru_cache(maxsize=None)
def sp_results(tmp_root):
    params0, _ = jax_tp()
    cfg = gpt2_config("test", **CFG)
    job = {"cfg": {f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
           "state_dict": decoder_from_jax_params(params0, cfg,
                                                 device="cpu").state_dict(),
           "batches": _batches(), "runs": RUNS,
           "prompt": torch.from_numpy(
               np.random.RandomState(3).randint(0, VOCAB, (2, 6)))}
    tmp = Path(tmp_root) / "world2"
    tmp.mkdir()
    return spawn(2, job, tmp)["runs"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return sp_results(str(tmp_path_factory.mktemp("megatron_sp")))


@pytest.mark.parametrize("run", RUNS, ids=[r["name"] for r in RUNS])
def test_megatron_sp_losses_match_jax_tp(results, run):
    _, want = jax_tp()
    got = results[run["name"]]
    assert got["degrees"]["tensor"] == 2
    np.testing.assert_allclose(got["losses"], want, rtol=2e-5, atol=0)
    on = run.get("kw", {}).get("megatron_sp", True)
    for step in got["comms"]:
        if on:
            assert step.get("reduce_scatter", 0) >= 1, step
        else:
            assert step.get("reduce_scatter", 0) == 0, step
    norms = {f"layers.{i}.{n}.{p}" for i in range(2)
             for n in ("attn_norm", "mlp_norm") for p in ("scale", "bias")}
    assert set(got["sp_norms"]) == (norms if on else set())


def test_megatron_sp_moves_the_collectives(results):
    """Megatron-SP trades each block exit's all-reduce for a
    reduce-scatter and an all-gather at the next entry (and sums the
    split norms' gradients); the same numbers either way, up to the
    order of the sums (2e-5 relative)."""
    on, off = results["tp-sp"], results["tp-no-sp"]
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=2e-5,
                               atol=0)
    for a, b in zip(on["comms"], off["comms"]):
        assert a["all_gather"] > b.get("all_gather", 0)
        assert a["reduce_scatter"] > b.get("reduce_scatter", 0) == 0
    # decoding and the forward outside a step's context run plain TP
    assert torch.equal(on["generated"], off["generated"])
    np.testing.assert_allclose(on["logits"].numpy(), off["logits"].numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("degrees,sp,want", [
    ({"tensor": 2}, True, 2), ({"tensor": 2}, False, 1),
    ({"data": 2}, True, 1), ({"tensor": 2, "pipe": 2}, True, 1),
    ({"seq": 2, "tensor": 2}, True, 2)],
    ids=["tensor2", "off", "trivial", "pipe", "seq2xtensor2"])
def test_sp_degree_follows_jax_context(devices8, degrees, sp, want):
    """The port's split degree against the JAX context's sequence spec:
    the tensor axis is in it exactly when the port splits over tensor
    (under a pipe axis JAX's stages set no constraint:
    ``enable_constraints=False``)."""
    n = int(np.prod(list(degrees.values())))
    mesh = jbuild_mesh(devices=jax.devices()[:n], **degrees)
    jctx = jpctx.ParallelContext(mesh=mesh, megatron_sp=sp,
                                 enable_constraints="pipe" not in degrees)
    entry = jctx.seq_spec_entry() if jctx.enable_constraints else None
    entry = entry if isinstance(entry, tuple) else (entry,)
    assert ("tensor" in entry) == (want > 1)
    tctx = tpctx.ParallelContext(mesh=degrees, megatron_sp=sp)
    assert tctx.sp_degree == want
    with tpctx.use(tctx):
        marked = torch.nn.Module()
        marked.seq_parallel = True
        assert (tpctx.sequence_parallel(marked) is not None) == (want > 1)
        assert tpctx.sequence_parallel(torch.nn.Module()) is None
    assert tpctx.sequence_parallel(marked) is None  # no context, no split
