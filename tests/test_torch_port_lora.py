"""LoRA in the PyTorch port (``training/lora.py``, ``quant.quantize_lora_factor``,
``interop.lora_from_jax``, ``AutoDistribute(init_fn=...)``) against the
JAX package's ``training/lora.py`` on the same weights and factors.

Factors cross with ``interop.lora_from_jax`` (both packages keep the
matrix view, ``a [d_in, r]`` / ``b [r, d_out]``).  Tolerances: merged
weights 1e-6 (one fp32 rank-r product and add on each side); int8
factors: payloads exact, scales 1e-7; a 5-step LoRA trajectory in fp32,
losses 1e-5 and the trained factors 1e-4 absolute (3 % of one Adam step
of ~lr = 3e-3: Adam scales the rounding noise of a near-zero gradient up
to steps of ~lr, 2.4e-5 seen on one element of 2048); the frozen base
bitwise; a checkpoint resume bitwise.
"""

import functools
import types
import warnings

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
from torch_automatic_distributed_neural_network_tpu.inference import quant as jquant
from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu.training import lora as jlora
from torch_automatic_distributed_neural_network_tpu_torch import AutoDistribute
from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    quantize_lora_factor,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    lora_from_jax,
    port_param_name,
    train_state_from_jax,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
    llama_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    adamw,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import lora as tlora

VOCAB, SEQ, BATCH = 128, 33, 4
FAMILIES = {"gpt2": (GPT2, gpt2_config), "llama": (Llama, llama_config)}

# the same recipes in both packages' names
SPECS = {
    "default": (jlora.LoraSpec(rank=4, alpha=8.0),
                tlora.LoraSpec(rank=4, alpha=8.0)),
    "qvup": (jlora.LoraSpec(rank=16, alpha=32.0, targets=(
        jlora.LoraTarget(r"q_proj/kernel", 1, 2),
        jlora.LoraTarget(r"v_proj/kernel", 1, 2),
        jlora.LoraTarget(r"up_proj/kernel", 1, 1))),
        tlora.LoraSpec(rank=16, alpha=32.0, targets=(
            tlora.LoraTarget(r"q_proj\.weight$", 1, 1, True),
            tlora.LoraTarget(r"v_proj\.weight$", 1, 1, True),
            tlora.LoraTarget(r"up_proj\.weight$", 1, 1, True)))),
    "attn_out_mlp": (jlora.LoraSpec(rank=4, targets=(
        jlora.O_LIKE, jlora.MLP_LIKE)),
        tlora.LoraSpec(rank=4, targets=(tlora.O_LIKE, tlora.MLP_LIKE))),
}


@functools.lru_cache(maxsize=None)
def jax_base(family):
    jcls, tcfg = FAMILIES[family]
    jm = jcls("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32)
    params = jm.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = tcfg("test", vocab_size=VOCAB, max_seq_len=64, dtype=torch.float32)
    return jm, params, cfg


def _jax_factors(params, jspec, seed=0):
    """JAX factors with a non-zero b (the merge would be the identity)."""
    lora = jlora.init_lora_params(jax.random.key(seed), params, jspec)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rs.normal(scale=0.3, size=x.shape),
                                    jnp.float32)
        if path[-1].key == "b" else x, lora)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("recipe", sorted(SPECS))
def test_merge_lora_matches_jax(family, recipe):
    _, params, cfg = jax_base(family)
    jspec, tspec = SPECS[recipe]
    jfac = _jax_factors(params, jspec)
    want = decoder_from_jax_params(
        jax.tree.map(np.asarray, jlora.merge_lora(params, jfac, jspec)), cfg,
        device="cpu").state_dict()
    base = decoder_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu").state_dict()
    lora = lora_from_jax(jax.tree.map(np.asarray, jfac), cfg.n_layers)
    got = tlora.merge_lora(base, lora, tspec)
    assert got.keys() == want.keys()
    changed = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        changed += name in lora
        if name not in lora:
            assert got[name] is base[name]  # passes through by identity
    assert changed == len(lora) > 0
    # the adapted module computes with the same merged weights
    model = decoder_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    plain = DecoderLM(cfg)
    plain.load_state_dict(got)
    tlora.apply_lora(model, tspec, lora)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (2, 12)))
    with torch.no_grad():
        np.testing.assert_allclose(model(toks).numpy(), plain(toks).numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("recipe", ["default", "qvup"])
def test_adapter_shapes_and_counts_match_jax(family, recipe):
    _, params, cfg = jax_base(family)
    jspec, tspec = SPECS[recipe]
    want = jlora.adapter_shapes(params, jspec)
    got = tlora.adapter_shapes(DecoderLM(cfg), tspec)
    expect = {}
    for path, (lead, d_in, d_out) in want.items():
        assert path.startswith("layers/") and lead == (cfg.n_layers,)
        for i in range(cfg.n_layers):
            expect[port_param_name(f"layers_{i}/{path[len('layers/'):]}")
                   ] = ((), d_in, d_out)
    assert got == expect
    jn = sum(x.size for x in jax.tree.leaves(
        jlora.init_lora_params(jax.random.key(0), params, jspec)))
    tn = sum(t.numel() for fac in tlora.init_lora_params(
        torch.Generator().manual_seed(0), DecoderLM(cfg), tspec).values()
        for t in fac.values())
    assert tn == jn


def test_plain_string_target_warns_and_no_match_raises():
    spec = tlora.LoraSpec(targets=(r"conv\.weight",))
    with pytest.warns(UserWarning, match="plain string"):
        shapes = tlora.adapter_shapes(
            {"conv.weight": torch.empty(8, 4, 3, 3)}, spec)
    assert shapes == {"conv.weight": ((8, 4), 3, 3)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a 2-D hit is what it means
        assert tlora.adapter_shapes({"conv.weight": torch.empty(8, 4)},
                                    spec) == {"conv.weight": ((), 4, 8)}
    _, _, cfg = jax_base("gpt2")
    with pytest.raises(ValueError, match="matched no"):
        tlora.init_lora_params(None, DecoderLM(cfg),
                               tlora.LoraSpec(targets=(r"nonexistent_proj",)))
    with pytest.raises(NotImplementedError, match="nn.Linear"):
        tlora.apply_lora(DecoderLM(cfg), tlora.LoraSpec(
            targets=(tlora.LoraTarget(r"^embed$", 1, 1, True),)))


@pytest.mark.parametrize("shape", [(48, 8), (3, 8, 40), (2, 16, 8)])
def test_quantize_lora_factor_matches_jax(shape):
    x = np.random.RandomState(len(shape)).normal(size=shape).astype(
        np.float32)
    x[..., 0, :] *= 5.0  # one loud row per output channel
    want = jquant.quantize_lora_factor(jnp.asarray(x))
    got = quantize_lora_factor(torch.from_numpy(x))
    assert got["scale"].shape == tuple(want["scale"].shape) == (
        *shape[:-2], 1, shape[-1])
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=1e-7, atol=0)


# -- training ------------------------------------------------------------------

_, TRAIN_SPEC = SPECS["qvup"]
JTRAIN_SPEC = SPECS["qvup"][0]


def _batch(step):
    return JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ,
                        batch_size=BATCH).batch(step)


def _snapshot(st):
    return types.SimpleNamespace(
        step=np.asarray(st.step), params=jax.tree.map(np.asarray, st.params),
        opt_state=jax.tree.map(np.asarray, st.opt_state))


@functools.lru_cache(maxsize=None)
def jax_lora_run(steps=5):
    """JAX LoRA fine-tune of GPT-2 ``test`` (fp32, one device): the
    states at steps 0 and 2, the losses and the final factors."""
    jm, params, _ = jax_base("gpt2")
    ad = JAutoDistribute(
        jm, optimizer=jlora.lora_optimizer(optax.adamw(3e-3)),
        loss_fn=jlora.lora_loss(jlosses.next_token_loss, JTRAIN_SPEC),
        init_fn=jlora.lora_init_fn(params, JTRAIN_SPEC),
        devices=jax.devices()[:1])
    state = ad.init(jax.random.key(2), _batch(0))
    snaps, losses = {0: _snapshot(state)}, []
    for i in range(steps):
        state, m = ad.step(state, _batch(i))
        losses.append(float(m["loss"]))
        if i == 1:
            snaps[2] = _snapshot(state)
    return snaps, losses, jax.tree.map(np.asarray, state.params["lora"])


def _port_ad():
    _, _, cfg = jax_base("gpt2")
    return AutoDistribute(
        DecoderLM(cfg), optimizer=tlora.lora_optimizer(adamw(3e-3)),
        loss_fn=tlora.lora_loss(next_token_loss, TRAIN_SPEC), device="cpu")


def _elements(tree):
    n = [0]

    def add(x):
        if isinstance(x, torch.Tensor):
            n[0] += x.numel()

    from torch_automatic_distributed_neural_network_tpu_torch.training.optim import (
        tree_map,
    )

    tree_map(add, tree)
    return n[0]


@pytest.mark.parametrize("start", [0, 2])
def test_lora_trajectory_matches_jax(start):
    """From JAX's base and factors (start 0), or from its state after two
    steps with Adam's moments (start 2): the remaining losses within 1e-5
    and the final factors within 1e-4; the base stays bitwise as it was
    and the optimizer state holds the factors' two moments only."""
    snaps, jax_losses, jax_factors = jax_lora_run()
    ad = _port_ad()
    state = train_state_from_jax(ad, snaps[start])
    assert state.step == start
    base0 = {n: t.clone() for n, t in state.params.items()
             if not tlora.is_lora_name(n)}
    n_lora = sum(t.numel() for n, t in state.params.items()
                 if tlora.is_lora_name(n))
    assert _elements(state.opt_state) == 2 * n_lora
    assert set(state.opt_state["base"]) == set()  # set_to_zero: no state
    losses = []
    for i in range(start, 5):
        state, m = ad.step(state, _batch(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_losses[start:], rtol=0, atol=1e-5)
    want = tlora.lora_named(lora_from_jax(jax_factors, 2))
    for name, t in state.params.items():
        if tlora.is_lora_name(name):
            np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-4, err_msg=name)
        else:
            assert torch.equal(t, base0[name]), name
            assert not t.requires_grad and t.grad is None


def test_step_zero_is_the_base_model_and_only_factors_train():
    """b = 0 at init: the adapted model's loss is the base model's
    exactly; ``init_fn`` runs before the plan, so the plan and the
    optimizer see the factors, and under ``mixed`` the frozen base keeps
    its fp32 storage with no master copy."""
    _, params, cfg = jax_base("gpt2")
    base = decoder_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu").state_dict()
    plain = DecoderLM(cfg)
    plain.load_state_dict(base)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(0).items()}
    with torch.no_grad():
        want = float(next_token_loss(plain, batch, None)[0])
    for precision in ("fp32", "mixed"):
        ad = AutoDistribute(
            DecoderLM(cfg), optimizer=tlora.lora_optimizer(adamw(3e-3)),
            loss_fn=tlora.lora_loss(next_token_loss, TRAIN_SPEC),
            init_fn=tlora.lora_init_fn(base, TRAIN_SPEC), device="cpu",
            precision=precision)
        plan = ad.build_plan(torch.Generator().manual_seed(0))
        assert any(tlora.is_lora_name(n) for n in plan.param_specs)
        state = ad.init(None)
        trainable = {n for n, p in ad.model.named_parameters()
                     if p.requires_grad}
        assert trainable and all(tlora.is_lora_name(n) for n in trainable)
        for name, t in state.params.items():
            if not tlora.is_lora_name(name):
                # a frozen weight is the module's own fp32 tensor
                assert t.dtype == torch.float32
                assert t is dict(ad.model.named_parameters())[name]
        if precision == "fp32":
            got = float(ad.eval_step(state, _batch(0))["loss"])
            assert got == pytest.approx(want, rel=1e-6)
        losses = [float(ad.step(state, _batch(0))[1]["loss"])
                  for _ in range(4)]
        assert losses[-1] < losses[0]
        for name, t in base.items():
            assert torch.equal(state.params[name], t), name
    with pytest.raises(ValueError, match="carries no LoRA"):
        tlora.lora_loss(next_token_loss, TRAIN_SPEC)(plain, batch, None)


def test_lora_checkpoint_resume_is_bitwise(tmp_path):
    """4 straight LoRA steps == 2, a ``CheckpointManager`` save, a restore
    into a fresh run, and 2 more: the factors and moments bitwise."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        CheckpointManager,
        restore_or_init,
    )

    snaps, _, _ = jax_lora_run()

    def fresh():
        ad = _port_ad()
        return ad, train_state_from_jax(ad, snaps[0])

    ad, s = fresh()
    for i in range(4):
        s, _ = ad.step(s, _batch(i))
    straight = {n: t.clone() for n, t in s.params.items()}

    ad1, s1 = fresh()
    for i in range(2):
        s1, _ = ad1.step(s1, _batch(i))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), device="cpu")
    ckpt.save(2, s1, force=True)
    ckpt.wait()
    ad2, _ = fresh()  # the factors are on its model; init makes the template
    s2, resumed = restore_or_init(ad2, ckpt, None, None)
    assert resumed and s2.step == 2
    assert any(tlora.is_lora_name(n) for n in s2.params)
    for i in range(2, 4):
        s2, _ = ad2.step(s2, _batch(i))
    ckpt.close()
    for name, t in straight.items():
        assert torch.equal(s2.params[name], t), name


# -- a bare parameter: HEAD_LIKE ---------------------------------------------------


HEAD_SPECS = (jlora.LoraSpec(rank=4, alpha=8.0, targets=(
    jlora.LoraTarget(r"q_proj/kernel", 1, 2), jlora.HEAD_LIKE)),
    tlora.LoraSpec(rank=4, alpha=8.0, targets=(
        tlora.LoraTarget(r"q_proj\.weight$", 1, 1, True), tlora.HEAD_LIKE)))


def test_lora_head_like_matches_jax():
    """LoRA on Llama ``test``'s untied head (a bare ``[d, V]`` parameter,
    JAX's ``[in, out]`` view) beside q_proj: the loss and every factor's
    gradient within 2e-5 of JAX's (fp32: the same products summed in
    another order), the factors named ``lm_head_lora_a/b`` beside the
    head, only they and q's training; the adapted model computes what a
    plain decoder with the merged weights computes (1e-5), and
    ``adapted`` leaves the module as it was."""
    jm, params, cfg = jax_base("llama")
    jspec, tspec = HEAD_SPECS
    lora = _jax_factors(params, jspec)
    batch = _batch(0)

    def jloss(lo):
        return jlora.lora_loss(jlosses.next_token_loss, jspec)(
            {"base": params, "lora": lo}, batch, None,
            lambda p, *a, **k: jm.apply({"params": p}, *a, **k))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(lora)
    want_grads = lora_from_jax(jax.tree.map(np.asarray, want_grads),
                               cfg.n_layers)
    base = decoder_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu")
    tl = lora_from_jax(jax.tree.map(np.asarray, lora), cfg.n_layers)
    assert "lm_head" in tl
    model = decoder_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    tlora.apply_lora(model, tspec, tl)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert {"lm_head_lora_a", "lm_head_lora_b"} <= trainable
    assert all(tlora.is_lora_name(n) for n in trainable)
    assert tlora.factor_site("lm_head_lora_b") == "lm_head"
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss = next_token_loss(model, tb, None)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=0,
                               atol=2e-5)
    named = dict(model.named_parameters())
    for site, fac in want_grads.items():
        for side in ("a", "b"):
            got = named[tlora.factor_prefix(site) + "lora_" + side].grad
            np.testing.assert_allclose(got.numpy(), fac[side].numpy(),
                                       rtol=0, atol=2e-5,
                                       err_msg=f"{site} {side}")
    # the adapted forward is the merged decoder's
    plain = DecoderLM(cfg)
    plain.load_state_dict(tlora.merge_lora(base.state_dict(), tl, tspec))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (2, 12)))
    with torch.no_grad():
        np.testing.assert_allclose(model(toks).numpy(), plain(toks).numpy(),
                                   rtol=0, atol=1e-5)
        with tlora.adapted(base, tl, tspec):
            assert type(base).__name__ == "LoraDecoderLM"
            np.testing.assert_allclose(base(toks).numpy(),
                                       plain(toks).numpy(), rtol=0, atol=1e-5)
    assert type(base) is DecoderLM and "lm_head_lora_a" not in base.__dict__
    assert set(tlora.lora_state(model)) == set(tl)
