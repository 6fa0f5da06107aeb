"""The training slice: losses, optimizers, precision policies, synthetic
data and the single-device ``AutoDistribute`` step of the PyTorch port,
against the JAX package on the same numpy inputs and carried weights.

Tolerances (fp32): losses 1e-5 on one forward and 1e-4 over a 5-step
trajectory; optimizer states 1e-6 (the same elementwise arithmetic,
bias corrections and schedules in fp32 on both sides); parameters after
5 training steps 1e-4 (Adam steps are ~lr = 1e-3, so this is 10 % of
one step).
"""

import functools

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
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu.training import optim as joptim
from torch_automatic_distributed_neural_network_tpu.training import precision as jprec
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    SyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    adamw,
    adamw_cosine,
    apply_updates,
    blockwise_next_token_loss,
    clip_by_global_norm,
    decay_mask,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    precision as tprec,
)

VOCAB, SEQ, BATCH = 128, 33, 4


@functools.lru_cache(maxsize=None)
def jax_model_and_params():
    jm = GPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
    return jm, jax.tree.map(np.asarray, variables["params"])


def port_model(params):
    cfg = gpt2_config("test", vocab_size=VOCAB, max_seq_len=64,
                      dtype=torch.float32)
    return decoder_from_jax_params(params, cfg, device="cpu")


def _batch(step=0):
    return JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ,
                        batch_size=BATCH).batch(step)


# -- losses --------------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
def test_next_token_loss_matches_jax(with_mask):
    jm, params = jax_model_and_params()
    batch = _batch()
    if with_mask:
        batch["mask"] = (np.random.RandomState(1).rand(BATCH, SEQ) > 0.3
                         ).astype(np.float32)
    jloss, jaux = jlosses.next_token_loss(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, None,
        lambda p, *a, **k: jm.apply({"params": p}, *a, **k))
    tloss, taux = next_token_loss(
        port_model(params), {k: torch.from_numpy(v) for k, v in batch.items()},
        None)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=1e-5)
    assert float(taux["tokens"]) == float(jaux["tokens"])


def test_blockwise_loss_matches_jax_and_the_dense_loss():
    """Blocks of 8 over 32 positions, a padding mask; the blockwise
    loss's gradients equal the dense loss's."""
    jm, params = jax_model_and_params()
    batch = _batch(1)
    batch["mask"] = (np.random.RandomState(2).rand(BATCH, SEQ) > 0.2
                     ).astype(np.float32)
    jloss, _ = jlosses.blockwise_next_token_loss(8)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, None,
        lambda p, *a, **k: jm.apply({"params": p}, *a, **k))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = port_model(params)
    tloss, aux = blockwise_next_token_loss(8)(model, tbatch, None)
    assert aux == {}
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=1e-5)
    dense, _ = next_token_loss(model, tbatch, None)
    np.testing.assert_allclose(float(tloss), float(dense), atol=1e-5)
    gb = torch.autograd.grad(tloss, list(model.parameters()))
    gd = torch.autograd.grad(dense, list(model.parameters()))
    for a, b in zip(gb, gd):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# -- optimizers ----------------------------------------------------------------

# a nested JAX tree and the port's flat names for the same leaves
_SHAPES = {("embed", "embedding"): (16, 8), ("layers", "attn", "kernel"): (8, 8),
           ("layers", "attn", "bias"): (8,), ("final_norm", "scale"): (8,),
           ("lm_head", "kernel"): (8, 16)}


def _trees(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    flat = {k: (scale * rs.randn(*s)).astype(np.float32)
            for k, s in _SHAPES.items()}
    nested = {}
    for path, v in flat.items():
        node = nested
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return nested, {".".join(k): torch.from_numpy(v.copy())
                    for k, v in flat.items()}


def _run_both(jtx, ttx, steps=4, grad_scale=1.0):
    jparams, tparams = _trees(0)
    jparams = jax.tree.map(jnp.asarray, jparams)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for i in range(steps):
        jg, tg = _trees(10 + i, grad_scale)
        jup, jstate = jtx.update(jax.tree.map(jnp.asarray, jg), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup, tstate = ttx.update(tg, tstate, tparams)
        apply_updates(tparams, tup)
        for path in _SHAPES:
            want = jparams
            for p in path:
                want = want[p]
            np.testing.assert_allclose(tparams[".".join(path)].numpy(),
                                       np.asarray(want), atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {path}")
    return tstate


def test_adamw_defaults_match_optax():
    """optax's defaults: weight decay 1e-4 on every leaf (norm scales and
    biases too), eps 1e-8, bias-corrected moments."""
    _run_both(optax.adamw(1e-3), adamw(1e-3))


def test_adamw_with_decay_mask_matches_optax():
    tstate = _run_both(optax.adamw(1e-2, weight_decay=0.1,
                                   mask=joptim.decay_mask),
                       adamw(1e-2, weight_decay=0.1, mask=decay_mask))
    assert tstate[0]["count"] == 4
    _, tparams = _trees(0)
    assert decay_mask(tparams) == {
        "embed.embedding": True, "layers.attn.kernel": True,
        "layers.attn.bias": False, "final_norm.scale": False,
        "lm_head.kernel": True}


def test_adamw_cosine_matches_optax():
    """Warmup over 3 steps then cosine, global-norm clipping at 1.0
    (grads of norm ~40 make it bite), decay masked."""
    _run_both(joptim.adamw_cosine(1e-2, 10, warmup_steps=3),
              adamw_cosine(1e-2, 10, warmup_steps=3), steps=6,
              grad_scale=3.0)


def test_schedule_is_read_before_the_increment():
    """Step 0 uses lr(0) = 0 during warmup: the parameters do not move."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        warmup_cosine,
    )

    sched = warmup_cosine(1.0, 100, warmup_steps=10)
    jsched = joptim.warmup_cosine(1.0, 100, warmup_steps=10)
    for c in (0, 1, 9, 10, 11, 50, 100, 150):
        np.testing.assert_allclose(sched(c), float(jsched(c)), atol=1e-6)
    _, tparams = _trees(0)
    before = {k: v.clone() for k, v in tparams.items()}
    tx = adamw(sched, weight_decay=0.0)
    up, _ = tx.update(_trees(1)[1], tx.init(tparams), tparams)
    apply_updates(tparams, up)
    for k in tparams:
        assert torch.equal(tparams[k], before[k])


def test_clip_by_global_norm_matches_optax():
    for scale in (0.01, 5.0):  # below and above the threshold
        jg, tg = _trees(3, scale)
        jout, _ = optax.clip_by_global_norm(1.0).update(
            jax.tree.map(jnp.asarray, jg), optax.EmptyState())
        tout, _ = clip_by_global_norm(1.0).update(tg, ())
        for path in _SHAPES:
            want = jout
            for p in path:
                want = want[p]
            np.testing.assert_allclose(tout[".".join(path)].numpy(),
                                       np.asarray(want), atol=1e-6)


# -- precision ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp32", "mixed", "bf16"])
def test_precision_presets_match_jax(name):
    tp, jp = tprec.resolve(name), jprec.resolve(name)
    assert tp.bytes_per_param == jp.bytes_per_param
    for field in ("param_dtype", "compute_dtype", "moment_dtype"):
        assert str(getattr(tp, field)).replace("torch.", "") == str(
            np.dtype(getattr(jp, field)))
    with pytest.raises(ValueError, match="Unknown precision"):
        tprec.resolve("fp8")


def test_wrapped_optimizer_keeps_bf16_moments_and_fp32_math():
    """'mixed': moments stored bf16, update math fp32, on both sides."""
    jtx = jprec.wrap_optimizer(optax.adamw(1e-2), jprec.resolve("mixed"))
    ttx = tprec.wrap_optimizer(adamw(1e-2), tprec.resolve("mixed"))
    tstate = _run_both(jtx, ttx, steps=3)
    adam = tstate[0]
    assert all(t.dtype == torch.bfloat16 for t in adam["mu"].values())
    assert all(t.dtype == torch.bfloat16 for t in adam["nu"].values())


# -- data ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_lm_batches_match_jax(seed):
    ours = SyntheticLM(vocab_size=50257, seq_len=65, batch_size=3, seed=seed)
    theirs = JSyntheticLM(vocab_size=50257, seq_len=65, batch_size=3,
                          seed=seed)
    for step in (0, 1, 5):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        assert a["input_ids"].dtype == b["input_ids"].dtype == np.int32
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


# -- AutoDistribute ---------------------------------------------------------------


def _jax_run(grad_accum, steps, one_batch):
    jm, _ = jax_model_and_params()
    ad = JAutoDistribute(jm, optimizer=optax.adamw(1e-3),
                         loss_fn=jlosses.next_token_loss,
                         devices=jax.devices()[:1], grad_accum=grad_accum)
    state = ad.init(jax.random.key(0), _batch(0))
    params0 = jax.tree.map(np.asarray, state.params)
    losses, tokens = [], []
    for i in range(steps):
        state, m = ad.step(state, _batch(0 if one_batch else i))
        losses.append(float(m["loss"]))
        tokens.append(float(m["tokens"]))
    return params0, jax.tree.map(np.asarray, state.params), losses, tokens


@pytest.mark.parametrize("grad_accum,one_batch", [(1, False), (2, False),
                                                 (1, True)])
def test_autodistribute_trajectory_matches_jax(grad_accum, one_batch):
    """GPT-2 ``test`` (remat on, its default), adamw(1e-3), one device,
    from the same weights: 5 losses and the final parameters.  On one
    batch seen at every step (the on-card smoke test's training phase)
    the loss falls in both packages."""
    params0, params_after, jlosses_, jtokens = _jax_run(grad_accum, 5,
                                                        one_batch)
    ad = AutoDistribute(port_model(params0), optimizer=adamw(1e-3),
                        loss_fn=next_token_loss, device="cpu",
                        grad_accum=grad_accum)
    state = ad.init(None, _batch(0))
    assert ad.remat is False  # the planner's single-device rule
    assert ad.model.cfg.remat
    losses, tokens = [], []
    for i in range(5):
        state, m = ad.step(state, _batch(0 if one_batch else i))
        losses.append(float(m["loss"]))
        tokens.append(float(m["tokens"]))
    assert state.step == 5
    np.testing.assert_allclose(losses, jlosses_, atol=1e-4)
    if one_batch:
        assert losses[-1] < losses[0] and jlosses_[-1] < jlosses_[0]
    assert tokens == jtokens == [BATCH * (SEQ - 1)] * 5
    want = port_model(params_after).state_dict()
    assert want.keys() == state.params.keys()
    for name, p in state.params.items():
        # the key bias has a zero gradient (a row's softmax does not move
        # when every key shifts by the same q . b), so on both sides its
        # gradient is rounding noise that Adam scales up to steps of ~lr:
        # only that bound holds, 5 steps of 1e-3
        atol = 5e-3 if name.endswith("k_proj.bias") else 1e-4
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_autodistribute_precision_storage(precision):
    """'mixed': fp32 masters in the state, the module holds their bf16
    cast, bf16 moments; 'bf16': everything bf16.  Loss still falls."""
    _, params = jax_model_and_params()
    ad = AutoDistribute(port_model(params), optimizer=adamw(1e-2),
                        loss_fn=next_token_loss, device="cpu",
                        precision=precision, remat=True)
    state = ad.init(None)
    want_param = torch.float32 if precision == "mixed" else torch.bfloat16
    assert all(p.dtype == want_param for p in state.params.values())
    assert all(p.dtype == torch.bfloat16 for p in ad.model.parameters())
    losses = []
    for i in range(4):
        state, m = ad.step(state, _batch(0))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for name, p in ad.model.named_parameters():
        assert torch.equal(p, state.params[name].to(torch.bfloat16))
    assert all(t.dtype == torch.bfloat16
               for t in state.opt_state[0]["mu"].values())


def test_autodistribute_refuses_what_is_not_ported():
    _, params = jax_model_and_params()
    model = port_model(params)
    for kw, item in ((dict(strategy="fsdp"), "3"), (dict(mesh=object()), "3"),
                     (dict(devices=["cpu", "cpu"]), "3"),
                     (dict(seq_parallel=2), "5"),
                     (dict(pipeline_stages=2), "5"), (dict(zero1=True), "3"),
                     (dict(export_cache=True), "4")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            AutoDistribute(model, loss_fn=next_token_loss, device="cpu", **kw)
    with pytest.raises(ValueError, match="grad_accum"):
        AutoDistribute(model, device="cpu", grad_accum=0)
    ad = AutoDistribute(model, loss_fn=next_token_loss, device="cpu",
                        grad_accum=3)
    with pytest.raises(ValueError, match="divisible"):
        ad.init(None, _batch(0))
