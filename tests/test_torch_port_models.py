"""The encoder, seq2seq and MLP families of the PyTorch port (BERT and its
classifier, ViT, the MT Transformer, the MNIST MLP), their losses and
``AutoDistribute`` trajectories, against the JAX package on the same
numpy inputs, with the weights carried by ``interop``.

Tolerances: fp32 logits and features 1e-5 absolute (the same fp32
arithmetic summed in another order through two layers; values O(1));
bf16 a few ulps of the output's scale, ``4 * scale * 2**-8`` (both sides
round the same products to bf16's 8 bits of mantissa); each loss's value
1e-5, and its gradient 1e-5 (3.3e-6 measured on ViT's [CLS] token,
gradients up to ~2); a
5-step ``AutoDistribute`` trajectory (fp32, dropout 0, fresh batches)
1e-5 a step, but ViT's 5e-4 (1.4e-4 measured on the CPU): a few
``patch_proj`` weights have gradients that cancel to ~1e-8, below the
two packages' summation-order noise (~1e-7), so their signs differ and
Adam's first step (``g / (|g| + 1e-8)``) moves them ~lr = 1e-3 apart;
the loss then differs by ~5e-5 relative.  ``make_plan`` on each family at a mesh of one:
the same strategy, degrees and remat, and per parameter the same element
count, exactly (strategies auto, fsdp and tp_fsdp; dp and tp differ
from them at one device only in the name of an axis of degree 1).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu import topology as jtopo
from torch_automatic_distributed_neural_network_tpu.data import synthetic as jsynth
from torch_automatic_distributed_neural_network_tpu.models import bert as jbert
from torch_automatic_distributed_neural_network_tpu.models import mlp as jmlp
from torch_automatic_distributed_neural_network_tpu.models import transformer_mt as jmt
from torch_automatic_distributed_neural_network_tpu.models import vit as jvit
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    interop,
    planner,
    topology,
)
from torch_automatic_distributed_neural_network_tpu_torch.data import synthetic as tsynth
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    bert_config,
    vit_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.models.transformer_mt import (
    Seq2SeqConfig,
)
from torch_automatic_distributed_neural_network_tpu_torch.models.vit import (
    unfold_patches,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    adamw,
    masked_lm_loss,
    mse_loss,
    seq2seq_loss,
    sgd,
    softmax_xent_loss,
)

ATOL = 1e-5
VOCAB = 256
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: a pool of threads a
    process stalls on every op when parallel test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _apply(jm):
    return lambda p, *a, **k: jm.apply({"params": p}, *a, **k)


# -- the families: JAX model, its inputs, the port's copy ---------------------


def _bert(dtype, scan=True):
    jd, td = DTYPES[dtype]
    cfg = dict(vocab_size=VOCAB, max_seq_len=64)
    jm = jbert.Bert("test", dtype=jd, scan_layers=scan, **cfg)
    return jm, lambda p: interop.bert_from_jax_params(
        p, bert_config("test", dtype=td, **cfg), device="cpu")


def _bert_classifier(dtype, scan=True):
    jd, td = DTYPES[dtype]
    jm = jbert.BertClassifier(jbert.bert_config(
        "test", vocab_size=VOCAB, max_seq_len=64, dtype=jd,
        scan_layers=scan), num_classes=3)
    return jm, lambda p: interop.bert_classifier_from_jax_params(
        p, bert_config("test", vocab_size=VOCAB, max_seq_len=64, dtype=td),
        device="cpu")


VIT_KW = dict(image_size=32, patch_size=8, num_classes=10)


def _vit(dtype, scan=True):
    jd, td = DTYPES[dtype]
    jm = jvit.ViT("test", dtype=jd, scan_layers=scan, **VIT_KW)
    return jm, lambda p: interop.vit_from_jax_params(
        p, vit_config("test", dtype=td, **VIT_KW), device="cpu")


def _mt(dtype, scan=True):
    jd, td = DTYPES[dtype]
    jm = jmt.TransformerMT("test", dtype=jd)
    cfg = Seq2SeqConfig(d_model=64, n_layers=2, n_heads=4, d_ff=128,
                        vocab_size=512, max_seq_len=64, dtype=td)
    return jm, lambda p: interop.mt_from_jax_params(p, cfg, device="cpu")


def _mlp(dtype, scan=True):
    return jmlp.MLP(), lambda p: interop.mlp_from_jax_params(p, device="cpu")


def _tokens(seed, B=2, S=24, vocab=VOCAB):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def _images(seed, B=2, size=32):
    return np.random.RandomState(seed).randn(B, size, size, 3).astype(
        np.float32)


FAMILIES = {
    "bert": (_bert, lambda s: (_tokens(s),)),
    "bert_classifier": (_bert_classifier, lambda s: (_tokens(s),)),
    "vit": (_vit, lambda s: (_images(s),)),
    "mt": (_mt, lambda s: (_tokens(s, S=16, vocab=512),
                           _tokens(s + 1, S=12, vocab=512))),
    "mlp": (_mlp, lambda s: (np.random.RandomState(s).rand(
        4, 28, 28, 1).astype(np.float32),)),
}


@functools.lru_cache(maxsize=None)
def family_pair(family, dtype="float32"):
    """A JAX model with random weights (numpy params) and the port's
    copy of it.  One draw of weights a family: a bf16 model computes
    from the fp32 model's (flax keeps its parameters in fp32, so JAX's
    init gives a bf16 model the same weights)."""
    make, inputs = FAMILIES[family]
    jm, port = make(dtype)
    if dtype != "float32":
        params = family_pair(family)[1]
    else:
        variables = jax.jit(jm.init)(jax.random.key(1),
                                     *(jnp.asarray(a) for a in inputs(0)))
        params = jax.tree.map(np.asarray, variables["params"])
    return jm, params, port(params)


def _outputs(family, dtype, seed):
    jm, params, tm = family_pair(family, dtype)
    args = FAMILIES[family][1](seed)
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        *(jnp.asarray(a) for a in args)),
                      dtype=np.float32)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args)).float().numpy()
    return got, want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp32_outputs_match_jax(family):
    got, want = _outputs(family, "float32", 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {"mlp"}))
def test_bf16_outputs_match_jax(family):
    """bf16 compute on both sides (the MLP has no compute dtype: fp32 in
    both packages): within a few bf16 ulps of the output's scale."""
    got, want = _outputs(family, "bfloat16", 4)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=4 * scale * 2 ** -8, rtol=0)


def _bert_inputs(seed, B=2, S=24):
    rs = np.random.RandomState(seed)
    seg = (np.arange(S)[None] >= rs.randint(4, S - 4, (B, 1))).astype(
        np.int32)
    keep = np.ones((B, S), np.int32)
    keep[0, S - 7:] = 0  # row 0 padded at its end
    return _tokens(seed, B, S), seg, keep


@pytest.mark.parametrize("segments,padding", [(True, False), (False, True),
                                              (True, True)])
def test_bert_segments_and_padding_match_jax(segments, padding):
    """Segment (token-type) embeddings and a padding mask (the plain
    attention path with a [B, 1, 1, S] key mask), features and MLM
    logits, fp32."""
    jm, params, tm = family_pair("bert")
    toks, seg, keep = _bert_inputs(5)
    kw = {}
    if segments:
        kw["segment_ids"] = seg
    if padding:
        kw["attn_mask"] = keep
    wants = jax.jit(lambda p, t, kw: [
        jm.apply({"params": p}, t, return_features=feats, **kw)
        for feats in (False, True)])(
            params, jnp.asarray(toks),
            {k: jnp.asarray(v) for k, v in kw.items()})
    for feats, want in zip((False, True), wants):
        with torch.no_grad():
            got = tm(torch.from_numpy(toks), return_features=feats,
                     **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_bert_flash_route_at_s512_matches_jax():
    """``attention_impl="flash"`` at BERT's published length, non-causal
    and unmasked: the port's plain versions of K1-K3 (the CPU) against
    JAX's Pallas kernels in interpret mode, fp32, one row."""
    jm = jbert.Bert("test", vocab_size=VOCAB, max_seq_len=512,
                    dtype=jnp.float32, attention_impl="flash")
    toks = _tokens(6, B=1, S=512)
    params = dict(family_pair("bert")[1])  # its positions drawn to 512
    params["pos_embed"] = (0.02 * np.random.RandomState(9).randn(
        512, params["pos_embed"].shape[1])).astype(np.float32)
    tm = interop.bert_from_jax_params(
        params, bert_config("test", vocab_size=VOCAB, max_seq_len=512,
                            dtype=torch.float32, attention_impl="flash"),
        device="cpu")
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_unfold_patches_keeps_jax_pixel_order():
    images = _images(7, B=2, size=16)
    want = np.asarray(jvit.unfold_patches(jnp.asarray(images), 4))
    got = unfold_patches(torch.from_numpy(images), 4).numpy()
    np.testing.assert_array_equal(got, want)


# -- losses -------------------------------------------------------------------


def _mlm_batch(seed, with_extras):
    batch = jsynth.SyntheticMLM(vocab_size=VOCAB, seq_len=24, batch_size=2,
                                seed=seed).batch(0)
    if with_extras:
        _, seg, keep = _bert_inputs(seed)
        batch.update(segment_ids=seg, attn_mask=keep)
    return batch


def _cls_batch(seed):
    return jsynth.SyntheticClassification(image_shape=(32, 32, 3),
                                          num_classes=10, batch_size=4,
                                          seed=seed).batch(seed)


LOSSES = {
    "masked_lm": (jlosses.masked_lm_loss, masked_lm_loss, "bert",
                  lambda: _mlm_batch(0, False)),
    "masked_lm_segments_padding": (jlosses.masked_lm_loss, masked_lm_loss,
                                   "bert", lambda: _mlm_batch(1, True)),
    "softmax_xent_vit": (jlosses.softmax_xent_loss, softmax_xent_loss, "vit",
                         lambda: _cls_batch(2)),
    "softmax_xent_mlp": (jlosses.softmax_xent_loss, softmax_xent_loss, "mlp",
                         lambda: jsynth.SyntheticClassification(
                             batch_size=8).batch(3)),
    "seq2seq": (jlosses.seq2seq_loss, seq2seq_loss, "mt",
                lambda: jsynth.SyntheticSeq2Seq(vocab_size=512, src_len=16,
                                                tgt_len=13,
                                                batch_size=3).batch(4)),
    "mse": (jlosses.mse_loss, mse_loss, "mlp",
            lambda: {"x": _images(5, B=4, size=28)[..., :1],
                     "y": np.random.RandomState(6).randn(4, 10).astype(
                         np.float32)}),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_and_gradients_match_jax(name):
    """Each loss's value and aux on its batch, and its gradient of every
    parameter (JAX's carried onto the port's names and layouts)."""
    jloss, tloss, family, make_batch = LOSSES[name]
    batch = make_batch()
    if name == "seq2seq":
        batch["tgt"][0, 7:] = 0  # a padded target row
    jm, params, tm = family_pair(family)
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, None, _apply(jm)), has_aux=True))(
            params, _j(batch))
    tl, taux = tloss(tm, _t(batch), None)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL,
                               rtol=0)
    assert taux.keys() == jaux.keys()
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   atol=ATOL, rtol=0)
    want = interop.from_jax_params(jax.tree.map(np.asarray, jgrads), tm,
                                   device="cpu").state_dict()
    names, leaves = zip(*tm.named_parameters())
    for name_, g in zip(names, torch.autograd.grad(tl, leaves)):
        np.testing.assert_allclose(g.numpy(), want[name_].numpy(), atol=ATOL,
                                   rtol=0, err_msg=name_)


# -- AutoDistribute: 5 steps from the same weights ------------------------------


TRAJECTORIES = {
    "bert_mlm": ("bert", jlosses.masked_lm_loss, masked_lm_loss,
                 lambda: (optax.adamw(1e-3), adamw(1e-3)),
                 jsynth.SyntheticMLM(vocab_size=VOCAB, seq_len=24,
                                     batch_size=4), ATOL),
    "vit": ("vit", jlosses.softmax_xent_loss, softmax_xent_loss,
            lambda: (optax.adamw(1e-3), adamw(1e-3)),
            jsynth.SyntheticClassification(image_shape=(32, 32, 3),
                                           num_classes=10, batch_size=4),
            5e-4),
    "mt": ("mt", jlosses.seq2seq_loss, seq2seq_loss,
           lambda: (optax.adam(1e-3), adamw(1e-3, weight_decay=0.0)),
           jsynth.SyntheticSeq2Seq(vocab_size=512, src_len=16, tgt_len=13,
                                   batch_size=4), ATOL),
    "mlp": ("mlp", jlosses.softmax_xent_loss, softmax_xent_loss,
            lambda: (optax.sgd(0.05), sgd(0.05)),
            jsynth.SyntheticClassification(batch_size=16), ATOL),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_autodistribute_trajectory_matches_jax(name):
    """5 steps from the same weights in each package, and the port
    continuing JAX's state after its step 2 for the last 3
    (``interop.train_state_from_jax``: parameters, Adam moments or SGD's
    empty state, the step count): the JAX run's losses."""
    import types

    family, jloss, tloss, optimizers, data, atol = TRAJECTORIES[name]
    jm, _, tm = family_pair(family)
    jtx, ttx = optimizers()
    ad = JAutoDistribute(jm, optimizer=jtx, loss_fn=jloss,
                         devices=jax.devices()[:1])
    state = ad.init(jax.random.key(0), data.batch(0))
    tad = AutoDistribute(
        interop.from_jax_params(jax.tree.map(np.asarray, state.params), tm,
                                device="cpu"),
        optimizer=ttx, loss_fn=tloss, device="cpu")
    tstate = tad.init(None, data.batch(0))
    want, got, snap = [], [], None
    for i in range(5):
        if i == 2:
            snap = types.SimpleNamespace(
                step=np.asarray(state.step),
                params=jax.tree.map(np.asarray, state.params),
                opt_state=jax.tree.map(np.asarray, state.opt_state))
        state, m = ad.step(state, data.batch(i))
        want.append(float(m["loss"]))
        tstate, m = tad.step(tstate, data.batch(i))
        got.append(float(m["loss"]))
    assert tstate.step == 5
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    cad = AutoDistribute(interop.from_jax_params(snap.params, tm,
                                                 device="cpu"),
                         optimizer=optimizers()[1], loss_fn=tloss,
                         device="cpu")
    cstate = interop.train_state_from_jax(cad, snap)
    assert cstate.step == 2
    cont = []
    for i in range(2, 5):
        cstate, m = cad.step(cstate, data.batch(i))
        cont.append(float(m["loss"]))
    np.testing.assert_allclose(cont, want[2:], atol=atol, rtol=0)


# -- the planner at a mesh of one ----------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("strategy", ["auto", "fsdp", "tp_fsdp"])
def test_make_plan_matches_jax_at_one_device(family, strategy):
    make, inputs = FAMILIES[family]
    jm = make("float32", scan=False)[0]
    jabs = jax.eval_shape(jm.init, jax.random.key(1),
                          *(jnp.asarray(a) for a in inputs(0)))["params"]
    tm = family_pair(family)[2]
    jplan = jplanner.make_plan(jabs, strategy=strategy,
                               devices=jax.devices()[:1])
    pabs = planner.abstract_params(tm)
    plan = planner.make_plan(pabs, strategy=strategy,
                             topology=topology.parse_topology("cpu-1"))
    jdeg = jtopo.mesh_degrees(jplan.mesh)
    assert (plan.strategy, plan.remat, plan.zero1) == (
        jplan.strategy, jplan.remat, jplan.zero1)
    assert {a: d for a, d in plan.degrees.items() if d > 1} == {
        a: d for a, d in jdeg.items() if d > 1}
    jflat = dict(jplanner._flatten_with_paths(jabs))
    jspecs = dict(jplanner._flatten_with_paths(jplan.param_specs))
    assert sorted(map(interop.jax_param_path, pabs)) == sorted(jflat)
    assert len(plan.param_specs) == len(jspecs)
    for name, spec in plan.param_specs.items():
        jpath = interop.jax_param_path(name)
        got = planner.leaf_shard_slices(tuple(pabs[name].shape), spec,
                                        plan.degrees)[0]
        want = jplanner.leaf_shard_slices(jflat[jpath].shape, jspecs[jpath],
                                          jdeg)[0]
        assert math.prod(b - a for a, b in got) == math.prod(
            b - a for a, b in want), name
