"""Expert parallelism in the PyTorch port at degree 1, in this process:
a gloo group of one rank (``file://`` rendezvous in the test's tmp dir,
brought up for this module and torn down after it), as one card runs
the expert strategies.  The multi-rank runs against the JAX package
ride in ``tests/test_torch_port_distributed.py``'s worlds of 2 and 4.

- ``ep``, ``ep_fsdp`` and ``ep_tp`` on MoE ``test`` (fp32, adamw, 4
  steps) equal the unwrapped step (no process group) bitwise, losses
  and parameters, and each applies its layout: the banks ``DTensor``
  objects over ``expert`` (and ``tensor``), FSDP2 under ``ep_fsdp``;
- the exchange runs through the expert group: its launches a step;
- ``moe_ffn`` over the mesh equals the plain ``moe_ffn`` in value and
  gradient, bitwise, and ``moe_ffn_sharded`` equals JAX's on one device
  (1e-5);
- an ``ep`` and an ``ep_tp`` state (banks on a 1-D and a 2-D mesh) save
  and restore bitwise through ``CheckpointManager`` (DCP) and
  ``ShardedCheckpoint``;
- the planner leaves the banks whole under a non-expert strategy at
  degree 1, and a model without banks gets JAX's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_automatic_distributed_neural_network_tpu import build_mesh as jbuild_mesh
from torch_automatic_distributed_neural_network_tpu.parallel import expert as jexpert
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    GPT2,
    MoE,
    moe_next_token_loss,
    next_token_loss,
    planner,
    topology,
)
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import (
    SyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu_torch.models.transformer_core import (
    gathered,
)
from torch_automatic_distributed_neural_network_tpu_torch.parallel import expert
from torch_automatic_distributed_neural_network_tpu_torch.training import adamw

VOCAB, STEPS = 128, 4
BANKS = ("experts_up", "experts_gate", "experts_down")


def _model():
    model = MoE("test", vocab_size=VOCAB, max_seq_len=64,
                dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _batches():
    data = SyntheticLM(vocab_size=VOCAB, seq_len=33, batch_size=4)
    return [data.batch(i) for i in range(STEPS)]


def _train(strategy, steps=STEPS):
    ad = AutoDistribute(_model(), optimizer=adamw(1e-3),
                        loss_fn=moe_next_token_loss, device="cpu",
                        strategy=strategy)
    state = ad.init(None, _batches()[0])
    losses, exchanges = [], []
    for b in _batches()[:steps]:
        before = expert.exchange.launches
        state, m = ad.step(state, b)
        exchanges.append(expert.exchange.launches - before)
        losses.append(float(m["loss"]))
    params = {n: gathered(p).detach().clone() for n, p in state.params.items()}
    return ad, losses, params, exchanges, state


def _full(state):
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        resilience,
    )

    return {k: gathered(resilience.as_tensor(v)).detach().clone()
            for k, v in resilience.flatten_state(state).items()}


@pytest.mark.parametrize("strategy", ["ep", "ep_tp"])
@pytest.mark.parametrize("kind", ["manager", "sharded"])
def test_expert_parallel_state_checkpoints_bitwise(world_of_one, tmp_path,
                                                   strategy, kind):
    """Save after 2 steps, step once more, restore: every leaf (the bank
    ``DTensor`` objects and their Adam moments among them) equals the
    saved state bitwise."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        CheckpointManager,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    ad, *_, state = _train(strategy, steps=2)
    want = _full(state)
    if kind == "manager":
        ck = CheckpointManager(str(tmp_path), device="cpu")
    else:
        ck = ShardedCheckpoint(str(tmp_path))
    ck.save(2, state)
    ck.wait()
    state, _ = ad.step(state, _batches()[2])
    assert not all(torch.equal(a, want[k]) for k, a in _full(state).items())
    state = ck.restore(state)
    ad.adopt_state(state)
    got = _full(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """The unwrapped run first (no group), then a gloo group of one; one
    intra-op thread for these small tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    unwrapped = _train("auto")
    assert unwrapped[0]._exec is None
    topology.initialize_distributed(
        backend="gloo",
        init_method=f"file://{tmp_path_factory.mktemp('pg')}/store",
        world_size=1, rank=0)
    yield unwrapped
    dist.destroy_process_group()
    torch.set_num_threads(threads)


@pytest.mark.parametrize("strategy", ["ep", "ep_fsdp", "ep_tp"])
def test_one_rank_expert_strategy_equals_the_unwrapped_step(world_of_one,
                                                            strategy):
    _, want_losses, want_params, want_ex, _ = world_of_one
    assert want_ex == [0] * STEPS  # no plan: no exchange
    ad, losses, params, exchanges, _ = _train(strategy)
    assert ad.plan.strategy == strategy
    assert set(ad.plan.degrees.values()) == {1}
    assert losses == want_losses
    for name, p in params.items():
        assert torch.equal(p, want_params[name]), name
    from torch.distributed.tensor import DTensor

    model = ad.model
    for layer in model.layers:
        mlp = layer.mlp
        assert mlp.expert_mesh is ad.plan.mesh
        assert mlp.expert_tensor_axis == (
            "tensor" if strategy == "ep_tp" else None)
        for name in BANKS:
            w = getattr(mlp, name)
            assert isinstance(w, DTensor), name
            dims = w.device_mesh.mesh_dim_names
            if strategy == "ep_fsdp":  # FSDP2 over the expert DTensor
                assert dims == ("fsdp", "expert"), dims
            else:
                assert dims == (("expert", "tensor") if strategy == "ep_tp"
                                else ("expert",)), dims
    # layer remat (cfg.remat) recomputes each layer's two exchanges,
    # the plan's remat around the loss (ep_fsdp) once more
    per_layer = 2 * (1 + model.cfg.remat + ad.plan.remat) + 2
    assert exchanges == [per_layer * model.cfg.n_layers] * STEPS


def _ffn_inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(4, 32, 16).astype(np.float32),
            rng.randn(4, 32, 4).astype(np.float32),
            (rng.randn(4, 16, 32) * 0.1).astype(np.float32),
            (rng.randn(4, 16, 32) * 0.1).astype(np.float32),
            (rng.randn(4, 32, 16) * 0.1).astype(np.float32))


def test_moe_ffn_over_the_mesh_equals_plain(world_of_one):
    """The exchange at degree 1 and a tensor split of 1 change nothing:
    output and the gradients of x, the logits and every bank, bitwise;
    4 exchanges (2 forward, 2 backward)."""
    x, logits, up, gate, down = (torch.from_numpy(a) for a in _ffn_inputs())
    mesh = topology.build_mesh()
    outs = []
    for kw in (dict(), dict(mesh=mesh), dict(mesh=mesh,
                                              tensor_axis="tensor")):
        args = [t.clone().requires_grad_() for t in (x, logits, up, gate,
                                                     down)]
        before = expert.exchange.launches
        y, m = expert.moe_ffn(args[0], args[1], args[2], args[4],
                              w_gate=args[3], act=torch.nn.functional.silu,
                              **kw)
        (y.square().sum() + m["aux_loss"]).backward()
        assert expert.exchange.launches - before == (4 if kw else 0)
        outs.append([y.detach()] + [a.grad for a in args])
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)


def test_moe_ffn_sharded_matches_jax_on_one_device(world_of_one):
    x, logits, up, _, down = _ffn_inputs()
    mesh = topology.build_mesh()
    y, m = expert.moe_ffn_sharded(
        *(torch.from_numpy(a) for a in (x, logits, up, down)), mesh=mesh,
        top_k=2)
    jmesh = jbuild_mesh(data=1, devices=jax.devices()[:1])
    jy, jm = jexpert.moe_ffn_sharded(
        *(jnp.asarray(a) for a in (x, logits, up, down)), mesh=jmesh,
        top_k=2)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        expert.moe_ffn_sharded(torch.from_numpy(x), torch.from_numpy(logits),
                               torch.from_numpy(up)[:3],
                               torch.from_numpy(down)[:3],
                               mesh={"expert": 2})


def test_banks_stay_whole_outside_the_expert_strategies():
    """At min_degree 1 (the wrappers' layout on a world of one) the banks
    carry ``expert`` only under an expert strategy; ``tp`` leaves them
    whole, as the JAX plan does with no expert axis."""
    abstract = planner.abstract_params(_model())
    for strategy, want in (("ep", ("expert",)), ("ep_tp", ("expert",)),
                           ("tp", ()), ("dp", ()), ("fsdp", ())):
        specs = planner.param_spec_tree(abstract, {}, strategy, min_degree=1)
        spec = specs["layers.0.mlp.experts_up"]
        got = tuple(a for e in spec if e
                    for a in (e if isinstance(e, tuple) else (e,))
                    if a == "expert")
        assert got == want, (strategy, spec)


def test_a_model_without_banks_gets_the_planner_error():
    ad = AutoDistribute(GPT2("test", vocab_size=VOCAB),
                        loss_fn=next_token_loss, device="cpu", strategy="ep")
    with pytest.raises(ValueError, match="expert banks"):
        ad.build_plan()
