"""``from_torch`` in the PyTorch port against the JAX package's
``models/torch_bridge.py``, on the cases of the JAX bridge's own tests
(``tests/test_torch_bridge.py``): the MLP, the CNN in eval and train
mode (BatchNorm's running statistics), the hand-written attention LM,
MultiheadAttention's masks (bool and float, positional key padding,
cross-attention, the need-weights output), the encoder stack (norm_first
x batch_first), ``nn.Transformer`` MT, weight sharing, and dropout in
train against eval mode.  Both bridges convert the same torch module.

Tolerances (fp32, one intra-op thread): every forward output and every
parameter gradient within 1e-5 absolute of JAX's (the same arithmetic in
another order; values O(1)) and of the source module's own forward;
running statistics 1e-5; three ``AutoDistribute`` steps of ``adamw(1e-3)``
(the CNN with its ``model_state``, the LM with its mask buffer) against
JAX's ``optax.adamw`` steps from the same weights: each loss within 2e-5
relative.  Names are JAX's variable keys exactly; the carried variables
(``interop.bridge_from_jax_variables``) and the function and method
tables are equal exactly; a refused module raises
``UnsupportedTorchModule`` in both packages.
"""

import copy
import math
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu.models import torch_bridge as jbridge
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    adamw,
    interop,
    next_token_loss_mutable,
    planner,
    softmax_xent_loss_mutable,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    TorchBridge,
    UnsupportedTorchModule,
    from_torch,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import torch_bridge as pbridge

TOL = 1e-5
LOSS_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the modules of the JAX bridge's tests
# ---------------------------------------------------------------------------


def make_mlp():
    torch.manual_seed(0)
    return tnn.Sequential(
        tnn.Flatten(), tnn.Linear(64, 128), tnn.ReLU(), tnn.Linear(128, 64),
        tnn.GELU(), tnn.LayerNorm(64), tnn.Linear(64, 10))


class SmallCNN(tnn.Module):
    """conv/bn/pool/residual add/flatten-by-view, a hand-written forward."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(1)
        self.conv1 = tnn.Conv2d(3, 8, 3, padding=1)
        self.bn1 = tnn.BatchNorm2d(8)
        self.conv2 = tnn.Conv2d(8, 8, 3, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(8)
        self.pool = tnn.MaxPool2d(2)
        self.head = tnn.Linear(8 * 4 * 4, 10)
        with torch.no_grad():  # running statistics away from 0 / 1
            for bn in (self.bn1, self.bn2):
                bn.running_mean.uniform_(-0.3, 0.3)
                bn.running_var.uniform_(0.5, 1.5)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(x))
        x = F.relu(x + y)
        x = self.pool(x)
        x = F.avg_pool2d(x, 2)
        x = x.view(x.size(0), -1)
        return self.head(x)


class TinyAttentionLM(tnn.Module):
    """Embedding, qkv chunk, tril mask buffer + masked_fill, matmul and
    softmax, transpose/view plumbing."""

    def __init__(self, vocab=61, d=32, heads=4, seq=12):
        super().__init__()
        torch.manual_seed(2)
        self.emb = tnn.Embedding(vocab, d)
        self.pos = tnn.Parameter(torch.randn(1, seq, d) * 0.02)
        self.qkv = tnn.Linear(d, 3 * d)
        self.proj = tnn.Linear(d, d)
        self.ln = tnn.LayerNorm(d)
        self.head = tnn.Linear(d, vocab, bias=False)
        self.heads = heads
        self.register_buffer("mask", torch.tril(torch.ones(seq, seq)))

    def forward(self, idx):
        b, t = idx.size(0), idx.size(1)
        x = self.emb(idx) + self.pos[:, :t]
        h = self.ln(x)
        q, k, v = self.qkv(h).chunk(3, dim=-1)
        hd = q.size(-1) // self.heads
        q = q.view(b, t, self.heads, hd).transpose(1, 2)
        k = k.view(b, t, self.heads, hd).transpose(1, 2)
        v = v.view(b, t, self.heads, hd).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-2, -1)) / (hd ** 0.5)
        att = att.masked_fill(self.mask[:t, :t] == 0, float("-inf"))
        att = torch.softmax(att, dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).contiguous().view(b, t, -1)
        x = x + self.proj(out)
        return self.head(x)


class MHAWrap(tnn.Module):
    def __init__(self, dropout=0.0, need_weights=False, average=True):
        super().__init__()
        torch.manual_seed(20)
        self.mha = tnn.MultiheadAttention(32, 4, dropout=dropout,
                                          batch_first=True)
        self.need_weights, self.average = need_weights, average

    def forward(self, q, k, v, m, kpm):
        out = self.mha(q, k, v, attn_mask=m, key_padding_mask=kpm,
                       need_weights=self.need_weights,
                       average_attn_weights=self.average)
        return out if self.need_weights else out[0]


class MHAPositional(tnn.Module):
    """torch's positional order is (q, k, v, key_padding_mask, ...)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(24)
        self.mha = tnn.MultiheadAttention(16, 2, batch_first=True)

    def forward(self, q, kpm):
        return self.mha(q, q, q, kpm)[0]


class EncoderWrap(tnn.Module):
    def __init__(self, norm_first, batch_first):
        super().__init__()
        torch.manual_seed(21)
        self.enc = tnn.TransformerEncoder(
            tnn.TransformerEncoderLayer(
                32, 4, 64, dropout=0.0, batch_first=batch_first,
                norm_first=norm_first, activation="gelu"), num_layers=2)

    def forward(self, x):
        return self.enc(x)


class MT(tnn.Module):
    def __init__(self, vocab=50, d=32, seq=10):
        super().__init__()
        torch.manual_seed(22)
        self.src_emb = tnn.Embedding(vocab, d)
        self.tgt_emb = tnn.Embedding(vocab, d)
        self.tf = tnn.Transformer(d, 4, 2, 2, 64, dropout=0.0,
                                  batch_first=True)
        self.out = tnn.Linear(d, vocab)
        self.register_buffer(
            "tgt_mask", tnn.Transformer.generate_square_subsequent_mask(seq))

    def forward(self, src, tgt):
        t = tgt.size(1)
        y = self.tf(self.src_emb(src), self.tgt_emb(tgt),
                    tgt_mask=self.tgt_mask[:t, :t])
        return self.out(y)


class Shared(tnn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(8)
        self.lin = tnn.Linear(8, 8)

    def forward(self, x):
        return self.lin(F.relu(self.lin(x)))


def _mha_inputs(rs, float_mask=False):
    q = rs.randn(2, 5, 32).astype(np.float32)
    k = rs.randn(2, 9, 32).astype(np.float32)  # cross: Tk != Tq
    v = rs.randn(2, 9, 32).astype(np.float32)
    m = rs.rand(5, 9) > 0.7                   # bool: True = NOT allowed
    if float_mask:
        m = np.where(m, -1e4, rs.randn(5, 9)).astype(np.float32)
    kpm = np.zeros((2, 9), bool)
    kpm[1, 6:] = True
    return [q, k, v, m, kpm]


def _positional_inputs(rs):
    kpm = np.zeros((3, 5), bool)
    kpm[0, 3:] = True
    return [rs.randn(3, 5, 16).astype(np.float32), kpm]


# name -> (module factory, inputs from a RandomState, train mode)
CASES = {
    "mlp": (make_mlp, lambda rs: [rs.randn(4, 8, 8).astype(np.float32)],
            False),
    "cnn_eval": (SmallCNN,
                 lambda rs: [rs.randn(2, 3, 16, 16).astype(np.float32)],
                 False),
    "cnn_train": (SmallCNN,
                  lambda rs: [rs.randn(4, 3, 16, 16).astype(np.float32)],
                  True),
    "attention_lm": (TinyAttentionLM,
                     lambda rs: [rs.randint(0, 61, (3, 12))], False),
    "mha_bool_mask_cross": (MHAWrap, _mha_inputs, False),
    "mha_float_mask": (MHAWrap, lambda rs: _mha_inputs(rs, True), False),
    "mha_weights_per_head": (
        lambda: MHAWrap(need_weights=True, average=False), _mha_inputs,
        False),
    "mha_positional_kpm": (MHAPositional, _positional_inputs, False),
    **{f"encoder_norm_first={nf}_batch_first={bf}": (
        functools.partial(EncoderWrap, nf, bf),
        (lambda bf: lambda rs: [rs.randn(*((2, 7, 32) if bf else (7, 2, 32)))
                                .astype(np.float32)])(bf), False)
       for nf in (False, True) for bf in (True, False)},
    "nn_transformer_mt": (MT, lambda rs: [rs.randint(0, 50, (2, 9)),
                                          rs.randint(0, 50, (2, 7))], False),
    "weight_sharing": (Shared, lambda rs: [rs.randn(3, 8).astype(np.float32)],
                       False),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(torch module, the port's bridge and tensors, JAX's bridge and
    variables, inputs)."""
    factory, inputs, _ = CASES[name]
    net = factory()
    net.train(CASES[name][2])
    model, params = from_torch(net)
    jmodel, variables = jbridge.from_torch(net)
    xs = inputs(np.random.RandomState(sorted(CASES).index(name)))
    return net, model, params, jmodel, variables, xs


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _leaves(out):
    return [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None]


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    """JAX's forward output (with the batch statistics under train) and
    the gradients of its squared-output mean, from one compiled program."""
    _, _, _, jmodel, variables, xs = _case(name)
    train = CASES[name][2]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(p):
        out = jmodel.apply({"params": p, **rest}, *xs, train=train,
                           mutable=["batch_stats"] if train else False)
        return (_first(_first(out)) ** 2).mean(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return out, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_and_torch(name):
    net, model, _, _, _, xs = _case(name)
    train = CASES[name][2]
    targs = [torch.from_numpy(np.asarray(x)) for x in xs]
    # JAX's converted variables may share memory with the module's
    # buffers: the source forward runs on a copy
    want = _jax_results(name)[0]
    source = copy.deepcopy(net)
    with torch.no_grad():
        if train:
            got, updates = model(*targs, train=True, mutable=True)
        else:
            got = model(*targs)
        ref = source(*targs)  # torch's own forward (updates its stats)
    if train:
        want, j_updates = want
        for key, arr in j_updates["batch_stats"].items():
            np.testing.assert_allclose(updates[key].numpy(), np.asarray(arr),
                                       atol=TOL, rtol=0, err_msg=key)
            # torch's own running statistics after its train forward
            scope, stat = key.split("//")
            buf = dict(source.named_buffers())[f"{scope}.running_{stat}"]
            np.testing.assert_allclose(updates[key].numpy(), buf.numpy(),
                                       atol=TOL, rtol=0, err_msg=key)
        # a forward writes none of the bridge's buffers
        for key in j_updates["batch_stats"]:
            assert not torch.equal(updates[key],
                                   dict(model.named_buffers())[key])
    for g, w, r in zip(_leaves(got), _leaves(want), _leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    _, model, _, _, _, xs = _case(name)
    train = CASES[name][2]
    targs = [torch.from_numpy(np.asarray(x)) for x in xs]
    names, params = zip(*model.named_parameters())
    out = model(*targs, train=train, mutable=train)
    loss = (_first(_first(out)) ** 2).mean()
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    jgrads = _jax_results(name)[1]
    assert sorted(grads) == sorted(jgrads)
    for key, g in jgrads.items():
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(g),
                                   atol=TOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_names_layouts_and_carried_variables(name):
    """Parameters and buffers under JAX's variable keys, in JAX's shapes;
    JAX's variables carried into a fresh bridge equal the port's own;
    the planner sees JAX's names and shapes and gives JAX's fsdp specs."""
    _, model, params, _, variables, _ = _case(name)
    jparams = variables["params"]
    assert sorted(dict(model.named_parameters())) == sorted(jparams)
    jbufs = {**variables.get("batch_stats", {}),
             **variables.get("constants", {})}
    assert sorted(dict(model.named_buffers())) == sorted(jbufs)
    assert set(params) == set(jparams) | set(jbufs)
    for key, arr in {**jparams, **jbufs}.items():
        assert tuple(params[key].shape) == tuple(arr.shape), key
        t = params[key].detach().numpy()
        np.testing.assert_array_equal(t, np.asarray(arr, t.dtype))
    carried = interop.bridge_from_jax_variables(
        jax.tree.map(np.asarray, variables), model, device="cpu")
    assert isinstance(carried, TorchBridge)
    for key, t in model.state_dict().items():
        assert torch.equal(carried.state_dict()[key], t), key
    mesh = {"fsdp": 2}
    want = jplanner.param_spec_tree(
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
         for k, v in jparams.items()}, mesh, "fsdp")
    got = planner.param_spec_tree(planner.abstract_params(model), mesh,
                                  "fsdp")
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("name", ["cnn_train", "attention_lm"])
def test_init_weights_is_jax_standalone_init(name):
    """``init_weights`` (what ``AutoDistribute.init`` calls given a
    generator and no ``init_fn``) gives JAX's ``TorchBridge.init``: zero
    parameters and buffers, unit running variances."""
    _, model, _, jmodel, _, xs = _case(name)
    fresh = interop._like(model).init_weights(torch.Generator())
    want = jmodel.init(jax.random.key(0), *map(jnp.asarray, xs))
    flat = {**want["params"], **want.get("batch_stats", {}),
            **want.get("constants", {})}
    got = fresh.state_dict()
    assert sorted(got) == sorted(flat)
    for key, arr in flat.items():
        t = got[key].detach()
        np.testing.assert_array_equal(t.numpy(), np.asarray(arr, t.numpy()
                                                            .dtype), key)


def test_tables_are_jax_tables():
    assert set(pbridge._FUNCTIONS) == set(jbridge._function_table())
    assert set(pbridge._METHODS) == set(jbridge._METHODS)
    assert ({t.__name__ for t in pbridge._leaf_types()}
            == {t.__name__ for t in jbridge._leaf_types()})


def test_need_weights_is_the_softmax_before_dropout():
    """Under train with dropout, MHA's weights are the probabilities
    before dropout (torch's contract; JAX's `_mha_core`), the output is
    dropped."""
    net = MHAWrap(dropout=0.5, need_weights=True).eval()
    model, _ = from_torch(net)
    jmodel, variables = jbridge.from_torch(net)
    xs = _mha_inputs(np.random.RandomState(5))
    targs = [torch.from_numpy(x) for x in xs]
    with torch.no_grad():
        out_t, w_t = model(*targs, train=True,
                           generator=torch.Generator().manual_seed(0))
        out_e, w_e = model(*targs)
    _, jw = jmodel.apply(variables, *map(jnp.asarray, xs))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(jw), atol=TOL, rtol=0)
    assert torch.equal(w_t, w_e)
    assert not torch.allclose(out_t, out_e)


def test_dropout_train_vs_eval():
    torch.manual_seed(7)
    net = tnn.Sequential(tnn.Linear(16, 16), tnn.Dropout(0.5),
                         tnn.Linear(16, 4))
    model, _ = from_torch(net)
    x = torch.ones(8, 16)
    with torch.no_grad():
        e1, e2 = model(x), model(x)
        assert torch.equal(e1, e2)
        # train without a generator: no dropout (deterministic)
        assert torch.equal(model(x, train=True), e1)
        t1 = model(x, train=True, generator=torch.Generator().manual_seed(0))
        t1b = model(x, train=True,
                    generator=torch.Generator().manual_seed(0))
        t2 = model(x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(t1, t1b)
    assert not torch.allclose(t1, t2)
    assert not torch.allclose(t1, e1)
    # the JAX bridge: the same split between the modes
    jmodel, variables = jbridge.from_torch(net)
    je = jmodel.apply(variables, jnp.ones((8, 16)))
    np.testing.assert_allclose(e1.numpy(), np.asarray(je), atol=TOL, rtol=0)


class _Einsum(tnn.Module):
    def forward(self, x):
        return torch.einsum("ij->ji", x)


class _Exp(tnn.Module):
    def forward(self, x):
        return x.exp()


class _Branchy(tnn.Module):
    def forward(self, x):
        if x.sum() > 0:
            return x
        return -x


class _Device(tnn.Module):
    def forward(self, x):
        return x.to(torch.device("cpu"))


class MHAKdim(tnn.Module):
    def __init__(self):
        super().__init__()
        self.mha = tnn.MultiheadAttention(8, 2, kdim=4, vdim=4)

    def forward(self, q, k):
        return self.mha(q, k, k)[0]


# refused when converted
REFUSED = {
    "lstm": lambda: tnn.Sequential(tnn.Linear(4, 4), tnn.LSTM(4, 4)),
    "function": _Einsum,
    "method": _Exp,
    "control_flow": _Branchy,
    "literal": _Device,
    "conv_same_padding": lambda: tnn.Sequential(
        tnn.Conv2d(3, 3, 3, padding="same")),
    "batchnorm_cma": lambda: tnn.Sequential(tnn.BatchNorm2d(3, momentum=None)),
    "pool_ceil_mode": lambda: tnn.Sequential(tnn.MaxPool2d(2, ceil_mode=True)),
    "mha_kdim": lambda: MHAKdim(),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_modules_raise_in_both(name):
    net = REFUSED[name]()
    with pytest.raises(jbridge.UnsupportedTorchModule):
        jbridge.from_torch(net)
    with pytest.raises(UnsupportedTorchModule):
        from_torch(net)


class _DropoutTrue(tnn.Module):
    def forward(self, x):
        return F.dropout(x, 0.5, True)


class _ExpandRank(tnn.Module):
    def forward(self, x):
        return x.expand(2, 3, 4)


@pytest.mark.parametrize("net", [_DropoutTrue, _ExpandRank])
def test_refused_at_run_time_in_both(net):
    x = np.ones((3, 4), np.float32)
    jmodel, variables = jbridge.from_torch(net())
    with pytest.raises(jbridge.UnsupportedTorchModule):
        jmodel.apply(variables, jnp.asarray(x))
    model, _ = from_torch(net())
    with pytest.raises(UnsupportedTorchModule):
        model(torch.from_numpy(x))


def _steps_jax(name, loss, batches):
    _, _, _, jmodel, variables, _ = _case(name)
    ad = JAutoDistribute(jmodel, optimizer=optax.adamw(1e-3), loss_fn=loss,
                         devices=jax.devices()[:1],
                         init_fn=lambda rng, b: variables)
    state = ad.init(jax.random.key(0), batches[0])
    losses, first = [], None
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
        first = first or jax.tree.map(np.asarray, state.model_state)
    return losses, first


def _steps_port(name, loss, batches):
    _, model, params, _, _, _ = _case(name)
    fresh = interop._like(model)  # a new bridge, loaded by init_fn
    ad = AutoDistribute(fresh, optimizer=adamw(1e-3), loss_fn=loss,
                        device="cpu",
                        init_fn=lambda m, g: m.load_state_dict(params))
    state = ad.init(None, batches[0])
    losses, first = [], None
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
        first = first or {n: t.clone() for n, t in state.model_state.items()}
    return losses, first


def test_autodistribute_steps_bridged_cnn_match_jax():
    rs = np.random.RandomState(10)
    batches = [{"x": rs.randn(8, 3, 16, 16).astype(np.float32),
                "label": rs.randint(0, 10, (8,))}] * 3
    want, jstats = _steps_jax("cnn_train", jlosses.softmax_xent_loss_mutable,
                              batches)
    got, stats = _steps_port("cnn_train", softmax_xent_loss_mutable, batches)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert got[-1] < got[0]
    # the running statistics the first step committed (later ones see
    # weights whose gradient cancels behind BatchNorm, e.g. conv1's bias,
    # where Adam's first steps move each package by +-lr on noise)
    for key, arr in jstats["batch_stats"].items():
        np.testing.assert_allclose(stats[key].numpy(), arr, atol=TOL, rtol=0,
                                   err_msg=key)


def test_autodistribute_steps_bridged_lm_match_jax():
    rs = np.random.RandomState(11)
    batches = [{"tokens": rs.randint(0, 61, (4, 13)).astype(np.int32)}
               for _ in range(3)]
    want, _ = _steps_jax("attention_lm", jlosses.next_token_loss_mutable,
                         batches)
    got, stats = _steps_port("attention_lm", next_token_loss_mutable, batches)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    # the mask buffer is model state, untouched by the steps
    assert torch.equal(stats["mask"], torch.tril(torch.ones(12, 12)))


def _mt_batches():
    rs = np.random.RandomState(23)
    return [{"src": rs.randint(0, 50, (8, 9)), "tgt": rs.randint(0, 50, (8, 8))}
            for _ in range(3)]


def _jax_mt_loss(params, model_state, batch, rng, apply_fn):
    """JAX's MT bridge test's loss (``tests/test_torch_bridge.py``)."""
    logits, updates = apply_fn({"params": params, **model_state},
                               batch["src"], batch["tgt"][:, :-1],
                               mutable=list(model_state.keys()))
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, batch["tgt"][:, 1:]).mean(), {"model_state": updates}


@pytest.fixture(scope="module")
def bridge_tp(tmp_path_factory):
    """The bridged ``nn.Transformer`` under ``tp`` on 2 devices in JAX
    and on 2 gloo ranks in the port (one spawn of
    ``tests/torch_port_dist_worker.py``), from the same weights on the
    same 3 batches."""
    from torch_port_spawn import spawn

    _, model, params, jmodel, variables, _ = _case("nn_transformer_mt")
    batches = _mt_batches()
    ad = JAutoDistribute(jmodel, optimizer=optax.adamw(1e-3),
                         loss_fn=_jax_mt_loss, strategy="tp",
                         devices=jax.devices()[:2],
                         init_fn=lambda rng, b: variables)
    state = ad.init(jax.random.key(0), batches[0])
    losses = []
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
    job = {"bridge_tp": {
        "spec": model.spec, "layout": model.layout, "state_dict": params,
        "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batches]}}
    got = spawn(2, job, tmp_path_factory.mktemp("bridge_tp"))["bridge_tp"]
    return (losses, ad.plan, jax.tree.map(np.asarray, state.params)), got


def test_bridged_transformer_tp_matches_jax(bridge_tp):
    """``nn.Transformer`` (d 32, 4 heads, 2 + 2 layers, ffn 64) bridged
    and trained under ``tp`` on 2 ranks: the plan splits every
    projection as JAX's does (the bridge rules), the packed ``in_w``
    [96, 32] is [48, 32] on a rank (its half of the heads of each of q,
    k and v), lin1 [32, 64] is [32, 32] and lin2 [64, 32] is [32, 32];
    the 3 losses within 2e-5 relative of JAX's ``tp`` losses and the
    trained parameters within 1e-4 of JAX's (the key third of ``in_b``
    5e-3: its gradient is rounding noise, which Adam moves by ~lr)."""
    (want, jplan, jparams), got = bridge_tp
    assert got["degrees"]["tensor"] == 2 == math.prod(got["degrees"].values())
    jspecs = {n: tuple(s) for n, s in jplan.param_specs.items()}
    assert got["specs"] == jspecs
    assert sum("tensor" in s for s in jspecs.values()) == 30
    for layer in ("enc.l0", "enc.l1", "dec.l0", "dec.l1"):
        assert got["local"][f"tf//{layer}.sa.in_w"] == (48, 32)
        assert got["local"][f"tf//{layer}.sa.in_b"] == (48,)
        assert got["local"][f"tf//{layer}.sa.out_w"] == (32, 16)
        assert got["local"][f"tf//{layer}.lin1.kernel"] == (32, 32)
        assert got["local"][f"tf//{layer}.lin2.kernel"] == (32, 32)
    assert got["local"]["tf//dec.l0.ca.in_w"] == (48, 32)
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL, atol=0)
    for name, arr in jparams.items():
        atol = np.full(arr.shape, 1e-4)
        if name.endswith("in_b"):
            atol[32:64] = 5e-3
        np.testing.assert_array_less(
            np.abs(got["params"][name].numpy() - arr), atol, err_msg=name)
