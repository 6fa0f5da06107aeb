"""The port's public API against the JAX package's: ``AutoDistribute``'s
forward pass (``ad(state_or_params, x)``, JAX ``core.py``'s
``__call__``) on the MLP and GPT-2 ``test`` with weights carried from
JAX, the functional alias ``autodistribute``, and the package's
top-level names (``__all__``).

Tolerances: fp32 logits 1e-5 absolute (the same fp32 arithmetic summed
in another order; values O(1)); a forward on weights other than the
module's 1e-6 of the same weights loaded into a model (one arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_automatic_distributed_neural_network_tpu as jtad
import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.models import MLP as JMLP
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch import (
    MLP,
    AutoDistribute,
    autodistribute,
    interop,
    next_token_loss,
    sgd,
    softmax_xent_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import gpt2_config

# JAX's names the port leaves out of its top level: the obs / tune
# subpackages (imported by their own path)
LATER = {"obs", "tune"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy_batch(seed=0, batch=16, dim=8, classes=10):
    """``tests/test_autodistribute.py``'s batch."""
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(batch, dim).astype(np.float32),
            "label": rs.randint(0, classes, size=(batch,))}


def _jax_state(jad, batch):
    return jax.tree.map(np.asarray, jad.init(jax.random.key(0), batch).params)


def test_call_on_the_mlp_matches_jax():
    """``ad(state.params, x)`` on JAX's MLP test model: [16, 10] logits
    (``tests/test_autodistribute.py::test_forward_call``), equal to JAX's;
    other weights compute through ``functional_call`` and leave the
    module's own as they were."""
    batch = _toy_batch()
    jad = jtad.AutoDistribute(JMLP(features=(32, 16, 10)),
                              optimizer=optax.sgd(0.1),
                              loss_fn=jlosses.softmax_xent_loss,
                              devices=jax.devices()[:1])
    params = _jax_state(jad, batch)
    want = np.asarray(jad(params, batch["x"]))
    ad = AutoDistribute(interop.mlp_from_jax_params(params, device="cpu"),
                        optimizer=sgd(0.1), loss_fn=softmax_xent_loss,
                        device="cpu")
    state = ad.init(None)
    for tree in (state, state.params):
        got = ad(tree, batch["x"])
        assert got.shape == (16, 10)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    own = {n: p.clone() for n, p in ad.model.named_parameters()}
    other = {n: p * 0.5 + 0.01 for n, p in own.items()}
    got = ad(other, torch.from_numpy(batch["x"]))
    ref = MLP((32, 16, 10), in_features=8)
    ref.load_state_dict(other)
    np.testing.assert_allclose(got.numpy(), ref(batch["x"]).detach().numpy(),
                               atol=1e-6, rtol=0)
    for n, p in ad.model.named_parameters():
        assert torch.equal(p, own[n]), n


def test_call_on_gpt2_matches_jax():
    """GPT-2 ``test``: the logits of ``ad(params, tokens)`` within 1e-5 of
    JAX's; under ``mixed`` the fp32 masters of the state compute, as
    JAX's ``__call__`` takes the state's stored parameters; ``train=``
    is dropped for a model without a training mode."""
    vocab, seq = 256, 16
    tokens = np.random.RandomState(1).randint(0, vocab, (2, seq + 1))
    jm = JGPT2("test", vocab_size=vocab, max_seq_len=64, dtype=jnp.float32)
    jad = jtad.AutoDistribute(jm, optimizer=optax.adamw(1e-3),
                              loss_fn=jlosses.next_token_loss,
                              devices=jax.devices()[:1])
    params = _jax_state(jad, {"input_ids": tokens})
    want = np.asarray(jad(params, tokens[:, :-1]))
    cfg = gpt2_config("test", vocab_size=vocab, max_seq_len=64,
                      dtype=torch.float32)
    for precision in ("fp32", "mixed"):
        ad = AutoDistribute(
            interop.decoder_from_jax_params(params, cfg, device="cpu"),
            optimizer=tad.adamw(1e-3), loss_fn=next_token_loss,
            precision=precision, device="cpu")
        state = ad.init(None)
        got = ad(state, tokens[:, :-1], train=False)
        assert got.shape == (2, seq, vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_autodistribute_is_the_functional_alias():
    ad = autodistribute(MLP((32, 16, 10), in_features=8), optimizer=sgd(0.1),
                        loss_fn=softmax_xent_loss, device="cpu")
    assert type(ad) is AutoDistribute
    state = ad.init(torch.Generator().manual_seed(0))
    assert ad(state, _toy_batch()["x"]).shape == (16, 10)
    with pytest.raises(RuntimeError, match="init"):
        autodistribute(MLP(), device="cpu")(state, _toy_batch()["x"])


def test_top_level_names_hold_jax_all():
    """Every name of JAX's ``__all__`` imports from the port and is in its
    ``__all__``, but the two subpackages; each is the port's own
    counterpart (the planner's and the topology's)."""
    missing = set(jtad.__all__) - set(tad.__all__)
    assert missing == LATER
    for name in set(jtad.__all__) - LATER:
        assert hasattr(tad, name), name
    from torch_automatic_distributed_neural_network_tpu_torch import (
        MESH_AXES,
        TRANSFORMER_RULES,
        Rule,
        Topology,
        build_mesh,
        detect,
        initialize_distributed,
        make_plan,
        param_spec_tree,
        single_device_mesh,
    )
    from torch_automatic_distributed_neural_network_tpu_torch import planner, topology

    assert (make_plan, param_spec_tree, Rule, TRANSFORMER_RULES) == (
        planner.make_plan, planner.param_spec_tree, planner.Rule,
        planner.TRANSFORMER_RULES)
    assert (MESH_AXES, Topology, build_mesh, detect, initialize_distributed,
            single_device_mesh) == (
        topology.MESH_AXES, topology.Topology, topology.build_mesh,
        topology.detect, topology.initialize_distributed,
        topology.single_device_mesh)
    assert MESH_AXES == jtad.MESH_AXES
    assert all(hasattr(tad, n) for n in tad.__all__)
