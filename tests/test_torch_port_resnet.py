"""ResNet with BatchNorm in the PyTorch port against the JAX package's
``models/resnet.py`` on the same numpy inputs, with the weights and
``batch_stats`` carried by ``interop.resnet_from_jax_params``:
ResNet18Thin in fp32 on 16 x 16 x 3 images, B 16 (the JAX model tests'
``img_data``), whose stage 1 opens with a 3x3/2 convolution of an even
input, so flax's 'SAME' padding (0, 1) shows wherever it is wrong.

Tolerances: the forward's logits and running statistics 1e-5 absolute
(the same fp32 arithmetic summed in another order; values O(1)); one
3x3/2 convolution 1e-5; three ``sgd(0.05, momentum=0.9)`` steps of
``softmax_xent_loss_mutable``: each loss within 2e-5 relative and the
running statistics within 1e-5 after each step (torch's unbiased running
variance would be off by 1/(B H W - 1) of itself, ~4e-3 at the stem);
the same under ``grad_accum=2``, where the two slices thread the
statistics in order; ``eval_step`` 2e-5 relative; remat, eval and the
checkpoint and JAX hand-overs bitwise (they change no arithmetic); under
``mixed`` and ``bf16`` the statistics stay fp32 and within 4e-3 of
JAX's fp32 ones after a step (half of bf16's ulp at 1: the weights are
rounded to bf16; 2.3e-4 measured on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticClassification,
)
from torch_automatic_distributed_neural_network_tpu.models import resnet as jresnet
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    interop,
    sgd,
    softmax_xent_loss_mutable,
)
from torch_automatic_distributed_neural_network_tpu_torch.models.resnet import (
    Conv,
    ResNet18Thin,
    ResNetConfig,
    same_padding,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    CheckpointManager,
    resilience,
)

IMG, B, STEPS, LR = (16, 16, 3), 16, 3, 0.05
CFG = ResNetConfig(stage_sizes=(2, 2), num_classes=10, width=16,
                   small_inputs=True, dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(state):
    """A JAX state with numpy leaves, the rng as its key data."""
    return jax.tree.map(np.asarray, state.replace(
        rng=jax.random.key_data(state.rng)))


@functools.lru_cache(maxsize=None)
def _batches():
    data = SyntheticClassification(image_shape=IMG, num_classes=10,
                                   batch_size=B)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(grad_accum=1):
    """JAX's AutoDistribute on one device: the state before and after
    each of three SGD-momentum steps, the losses, and the wrapper."""
    ad = JAutoDistribute(jresnet.ResNet18Thin(dtype=jnp.float32),
                         optimizer=optax.sgd(LR, momentum=0.9),
                         loss_fn=jlosses.softmax_xent_loss_mutable,
                         devices=jax.devices()[:1], grad_accum=grad_accum)
    state = ad.init(jax.random.key(0), _batches()[0])
    states, losses = [_np(state)], []
    for b in _batches():
        state, m = ad.step(state, b)
        states.append(_np(state))
        losses.append(float(m["loss"]))
    return ad, state, states, losses


def _variables(jstate):
    return {"params": jstate.params, **jstate.model_state}


def _port_ad(jstate, **kw):
    model = interop.resnet_from_jax_params(_variables(jstate), CFG,
                                           device="cpu")
    ad = AutoDistribute(model, optimizer=sgd(LR, momentum=0.9),
                        loss_fn=softmax_xent_loss_mutable, device="cpu", **kw)
    return ad, ad.init(None)


def _stats_of(jstate):
    """JAX's running statistics by the port's buffer names."""
    stats = jstate.model_state["batch_stats"]
    out = {}
    for name in resnet_buffer_names():
        tree = stats
        for key in interop.jax_param_path(name).split("/"):
            tree = tree[key]
        out[name] = np.asarray(tree)
    return out


@functools.lru_cache(maxsize=None)
def resnet_buffer_names():
    with torch.device("meta"):
        return tuple(n for n, _ in ResNet18Thin(dtype=torch.float32)
                     .named_buffers())


def _assert_stats(port_state, jstate, atol=1e-5):
    want = _stats_of(jstate)
    assert sorted(port_state.model_state) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(port_state.model_state[name].numpy(), arr,
                                   atol=atol, rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _perturbed():
    """JAX's initial variables with every BatchNorm scale and bias drawn
    (``bn3``'s zero scale would hide the 3x3/2 convolution from the
    logits) and random running statistics."""
    rs = np.random.RandomState(0)
    jstate = _jax_run()[2][0]

    def draw(path, x):
        key = path[-1].key
        if key == "scale":
            return (1.0 + 0.3 * rs.randn(*x.shape)).astype(np.float32)
        if key in ("bias", "mean"):
            return (0.2 * rs.randn(*x.shape)).astype(np.float32)
        if key == "var":
            return rs.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, _variables(jstate))


def test_forward_matches_jax_in_both_modes():
    variables = _perturbed()
    x = _batches()[0]["x"]
    jm = jresnet.ResNet18Thin(dtype=jnp.float32)
    j_train, j_updates = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    j_eval = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    model = interop.resnet_from_jax_params(variables, CFG, device="cpu")
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        logits, updates = model(torch.from_numpy(x), train=True,
                                mutable=True)
        eval_logits = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_train),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(eval_logits.numpy(), np.asarray(j_eval),
                               atol=1e-5, rtol=0)
    assert logits.dtype == torch.float32
    # the new running statistics come back; the module's stay as they were
    want = {"batch_stats": j_updates["batch_stats"]}
    for name in resnet_buffer_names():
        tree = want["batch_stats"]
        for key in interop.jax_param_path(name).split("/"):
            tree = tree[key]
        np.testing.assert_allclose(updates[name].numpy(), np.asarray(tree),
                                   atol=1e-5, rtol=0, err_msg=name)
        assert torch.equal(dict(model.named_buffers())[name], before[name])


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding_matches_flax(size):
    """One 3x3/2 convolution: flax pads an even input (0, 1) and an odd
    one (1, 1); torch's symmetric ``padding=1`` is wrong on the even one."""
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    conv = fnn.Conv(4, (3, 3), (2, 2), use_bias=False)
    params = conv.init(jax.random.key(1), x)
    want = np.asarray(conv.apply(params, x))
    port = Conv(3, 4, 3, 2)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(
            params["params"]["kernel"]).transpose(3, 2, 0, 1)))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        symmetric = torch.nn.functional.conv2d(xt, port.weight, stride=2,
                                               padding=1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    gap = np.abs(symmetric.permute(0, 2, 3, 1).numpy() - want).max()
    assert (gap > 1e-2) == (size % 2 == 0)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_sgd_momentum_steps_match_jax(grad_accum):
    """Three steps: losses within 2e-5 relative, running statistics within
    1e-5 after each (``grad_accum=2``: JAX's sequential threading)."""
    _, _, jstates, jlosses_ = _jax_run(grad_accum)
    ad, state = _port_ad(jstates[0], grad_accum=grad_accum)
    losses = []
    for i, b in enumerate(_batches()):
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
        _assert_stats(state, jstates[i + 1])
        assert "model_state" not in m and "accuracy" in m
    np.testing.assert_allclose(losses, jlosses_, rtol=2e-5, atol=0)
    # the trace is optax's: the last parameters within one step's noise
    want = interop.resnet_from_jax_params(_variables(jstates[-1]), CFG,
                                          device="cpu").state_dict()
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_remat_moves_the_statistics_once():
    """Activation checkpointing re-runs the forward in the backward; the
    running statistics after two steps are bitwise those without it."""
    jstate = _jax_run()[2][0]
    out = {}
    for remat in (False, True):
        ad, state = _port_ad(jstate, remat=remat)
        assert ad.remat is remat
        for b in _batches()[:2]:
            state, m = ad.step(state, b)
        out[remat] = {n: t.clone() for n, t in state.model_state.items()}
    for name, t in out[False].items():
        assert torch.equal(out[True][name], t), name


@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_model_state_stays_fp32_under_low_precision(precision):
    """The parameters train in bf16 (``bf16``) or as bf16 copies of fp32
    masters (``mixed``); the running statistics stay fp32 buffers, as
    JAX keeps ``batch_stats`` out of the precision cast."""
    ad, state = _port_ad(_jax_run()[2][0], precision=precision)
    state, _ = ad.step(state, _batches()[0])
    assert {t.dtype for t in state.model_state.values()} == {torch.float32}
    assert {p.dtype for p in ad.model.parameters()} == {torch.bfloat16}
    _assert_stats(state, _jax_run()[2][1], atol=4e-3)


def test_eval_step_uses_batch_statistics_and_moves_none():
    jad, jstate, jstates, _ = _jax_run()
    ad, state = _port_ad(jstates[-1])
    before = {n: t.clone() for n, t in state.model_state.items()}
    got = ad.eval_step(state, _batches()[0])
    want = jad.eval_step(jstate, _batches()[0])
    assert set(got) == {"loss", "accuracy"} == set(want)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=2e-5, atol=0)
    for name, t in before.items():
        assert torch.equal(state.model_state[name], t), name


def test_call_matches_jax_with_running_statistics():
    """``ad(state, x, train=False)`` against JAX's, on weights and running
    statistics carried from one set of variables."""
    variables = _perturbed()
    jad = _jax_run()[0]
    x = _batches()[1]["x"]
    model = interop.resnet_from_jax_params(variables, CFG, device="cpu")
    ad = AutoDistribute(model, optimizer=sgd(LR, momentum=0.9),
                        loss_fn=softmax_xent_loss_mutable, device="cpu")
    state = ad.init(None)
    want = np.asarray(jad(variables, x, train=False))
    np.testing.assert_allclose(ad(state, x, train=False).numpy(), want,
                               atol=1e-5, rtol=0)
    # a bare parameter mapping takes the module's running statistics
    np.testing.assert_allclose(ad(state.params, x, train=False).numpy(),
                               want, atol=1e-5, rtol=0)


def test_flops_and_init_follow_jax():
    for kw in ({}, dict(small_inputs=True, num_classes=10),
               dict(stage_sizes=(2, 2), width=16, small_inputs=True,
                    num_classes=10)):
        for hw in ((224, 224), (32, 32), (16, 16)):
            want = jresnet.ResNetConfig(**kw).forward_flops_per_image(hw)
            assert ResNetConfig(**kw).forward_flops_per_image(hw) == want
            assert ResNetConfig(**kw).train_step_flops(hw, 8) == (
                jresnet.ResNetConfig(**kw).train_step_flops(hw, 8))
    assert round(ResNetConfig().forward_flops_per_image((224, 224)) / 1e9,
                 2) == 8.18
    model = ResNet18Thin(dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(0))
    jvars = _variables(_jax_run()[2][0])
    got = model.state_dict()
    for name, t in got.items():
        tree = jvars["batch_stats" if name.endswith(("mean", "var"))
                     else "params"]
        for key in interop.jax_param_path(name).split("/"):
            tree = tree[key]
        assert t.numel() == np.asarray(tree).size, name
        if name.endswith(".scale"):
            fill = 0.0 if name.endswith("bn3.scale") else 1.0
            assert torch.all(t == fill) and np.all(np.asarray(tree) == fill)


def test_checkpoint_and_jax_hand_over_carry_state_and_trace(tmp_path):
    """A JAX state after two steps continues in the port with its
    parameters, running statistics and momentum trace bitwise; the
    port's state saves and restores bitwise, the buffers and the trace
    among its leaves."""
    jstate = _jax_run()[2][2]
    model = ResNet18Thin(dtype=torch.float32)
    ad = AutoDistribute(model, optimizer=sgd(LR, momentum=0.9),
                        loss_fn=softmax_xent_loss_mutable, device="cpu")
    state = interop.train_state_from_jax(ad, jstate, seed=5)
    assert state.step == 2 and state.opt_state[1] == {"count": 2}
    want = interop.resnet_from_jax_params(_variables(jstate), CFG,
                                          device="cpu").state_dict()
    trace = interop.from_jax_params(jstate.opt_state[0].trace, model,
                                    device="cpu").state_dict()
    for name, t in state.params.items():
        assert torch.equal(t, want[name]), name
        assert torch.equal(state.opt_state[0]["trace"][name], trace[name])
    for name, t in state.model_state.items():
        assert torch.equal(t, want[name]), name
        assert t is dict(model.named_buffers())[name]
    state, _ = ad.step(state, _batches()[2])
    snap = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in resilience.flatten_state(state).items()}
    assert any(k.startswith("model_state/") for k in snap)
    assert any(k.startswith("opt_state/0/trace/") for k in snap)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(3, state)
    mgr.wait()
    fresh, fstate = _port_ad(_jax_run()[2][0])
    fstate = mgr.restore(fstate)
    fresh.adopt_state(fstate)
    mgr.close()
    got = resilience.flatten_state(fstate)
    assert got.keys() == snap.keys()
    for k, v in snap.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    for name, t in fstate.model_state.items():
        assert t is dict(fresh.model.named_buffers())[name]
