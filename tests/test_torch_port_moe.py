"""MoE at expert degree 1 in the PyTorch port: the routing
(``parallel/expert.py``), the expert feed-forward, the MoE LM and its
loss, the planner and a 5-step ``AutoDistribute`` trajectory, against
the JAX package on the same numpy inputs and carried weights.

Tolerances: the routing decisions exactly (``dispatch`` bitwise equal,
and ``combine`` bitwise equal from the same probabilities:
:func:`route_probs` on JAX's softmax); from the logits, ``combine`` 1e-6
(XLA's and torch's fp32 ``exp`` differ by an ulp on ~10 % of the
probabilities); the aux, z and dropped metrics 1e-6, relative for the
z-loss (~7 here: 1e-6 absolute is two of its fp32 ulps); ``moe_ffn``,
the LM's logits, its aux and the loss 1e-5 (fp32 sums in another
order); the trajectory 1e-5 a step.  In bf16 the router's input is the
bf16 norm output, and an ulp of difference there flips a near-tied
expert choice now and then, which changes that token's whole row: the
logits of at least 90 % of the token rows agree within a few bf16 ulps
of their scale (2 of 48 rows differ on the CPU), the aux 1e-2
relative.
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu import topology as jtopo
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticLM as JSyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu.models import MoE as JMoE
from torch_automatic_distributed_neural_network_tpu.models import moe_config as jmoe_config
from torch_automatic_distributed_neural_network_tpu.parallel import expert as jexpert
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    interop,
    planner,
    topology,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import moe_config
from torch_automatic_distributed_neural_network_tpu_torch.parallel import expert
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    adamw,
    blockwise_next_token_loss,
    moe_next_token_loss,
)

VOCAB, SEQ, BATCH = 128, 33, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: a pool of threads a
    process stalls on every op when parallel test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _logits(seed, B=2, S=32, E=4, scale=2.0):
    return (scale * np.random.RandomState(seed).randn(B, S, E)).astype(
        np.float32)


# (B, S, E, top_k, capacity): the preset's capacity, a capacity where
# tokens drop, top-1, and top-3 of 8 at a tight capacity
ROUTES = {"preset": (2, 32, 4, 2, None), "drops": (2, 32, 4, 2, 8),
          "top1": (3, 20, 4, 1, 8), "top3": (2, 24, 8, 3, 8)}


def _route_both(logits, top_k, capacity):
    jc, jd, jm = jax.jit(jexpert.top_k_routing, static_argnums=(1, 2))(
        jnp.asarray(logits), top_k, capacity)
    tc, td, tm = expert.top_k_routing(torch.from_numpy(logits), top_k,
                                      capacity)
    return (np.asarray(jc), np.asarray(jd), {k: float(v) for k, v in
                                              jm.items()},
            tc.numpy(), td.numpy(), {k: float(v) for k, v in tm.items()})


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_top_k_routing_matches_jax(case):
    B, S, E, k, capacity = ROUTES[case]
    if capacity is None:
        capacity = jexpert.expert_capacity(S, E, k, 1.25)
    assert expert.expert_capacity(S, E, k, 1.25) == \
        jexpert.expert_capacity(S, E, k, 1.25)
    logits = _logits(10 + len(case), B, S, E)
    jc, jd, jm, tc, td, tm = _route_both(logits, k, capacity)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, atol=1e-6, rtol=0)
    assert np.array_equal(tc != 0, jc != 0)
    assert tm.keys() == jm.keys()
    for key in jm:
        np.testing.assert_allclose(tm[key], jm[key], atol=1e-6, rtol=1e-6)
    if case == "drops":
        assert jm["dropped_fraction"] > 0.05
    # the same probabilities give the very same combine
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    combine, dispatch, _ = expert.route_probs(torch.from_numpy(probs), k,
                                              capacity)
    np.testing.assert_array_equal(combine.numpy(), jc)
    np.testing.assert_array_equal(dispatch.numpy(), jd)


def test_argmax_tie_takes_the_first_expert_like_jax():
    """Equal maxima: both packages take the lower expert index first
    (``jnp.argmax`` and ``torch.argmax`` return the first maximum), so
    the first choice is expert 0 and the second expert 1."""
    logits = _logits(20, B=1, S=8, E=4)
    logits[0, :, 0] = logits[0, :, 1] = 5.0
    logits[0, 3, 2] = 5.0  # a three-way tie on token 3
    jc, jd, jm, tc, td, tm = _route_both(logits, 2, 8)
    np.testing.assert_array_equal(td, jd)
    assert td[0, :, 0].sum() == 8 and td[0, :, 1].sum() == 8
    assert td[0, 3, 2].sum() == 0
    np.testing.assert_allclose(tc, jc, atol=1e-6, rtol=0)


def _banks(seed, E=4, d=16, f=24, gate=True):
    rs = np.random.RandomState(seed)
    w = lambda *s: (rs.randn(*s) / math.sqrt(s[1])).astype(np.float32)
    return w(E, d, f), w(E, f, d), (w(E, d, f) if gate else None)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("capacity", [None, 8])
def test_moe_ffn_matches_jax(gate, capacity):
    """SwiGLU experts (silu) or plain ones (tanh gelu), at the preset's
    capacity and where tokens drop: the output and the metrics."""
    x = np.random.RandomState(30).randn(2, 32, 16).astype(np.float32)
    logits = _logits(31)
    up, down, g = _banks(32, gate=gate)
    kw = dict(top_k=2, capacity_factor=1.25, capacity=capacity)
    jy, jm = jax.jit(lambda *a: jexpert.moe_ffn(
        *a[:4], w_gate=a[4] if gate else None,
        act=jax.nn.silu if gate else jax.nn.gelu, **kw))(
            jnp.asarray(x), jnp.asarray(logits), jnp.asarray(up),
            jnp.asarray(down), None if g is None else jnp.asarray(g))
    ty, tm = expert.moe_ffn(
        torch.from_numpy(x), torch.from_numpy(logits), torch.from_numpy(up),
        torch.from_numpy(down),
        w_gate=None if g is None else torch.from_numpy(g),
        act=(torch.nn.functional.silu if gate else
             (lambda t: torch.nn.functional.gelu(t, approximate="tanh"))),
        **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=1e-6, rtol=1e-6)


def test_moe_ffn_refuses_an_expert_axis():
    x = torch.zeros(1, 8, 16)
    up, down, _ = (torch.from_numpy(a) if a is not None else None
                   for a in _banks(33, gate=False))
    with pytest.raises(NotImplementedError, match="item 6"):
        expert.moe_ffn(x, torch.zeros(1, 8, 4), up, down,
                       mesh={"expert": 2, "data": 1})


# -- the MoE LM ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def moe_pair(dtype="float32"):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(vocab_size=VOCAB, max_seq_len=64)
    jm = JMoE("test", dtype=jd, **kw)
    if dtype != "float32":  # bf16 compute from the fp32 model's weights
        params = moe_pair()[1]
    else:
        variables = jax.jit(jm.init)(jax.random.key(4),
                                     jnp.zeros((1, 8), jnp.int32))
        params = jax.tree.map(np.asarray, variables["params"])
    tm = interop.moe_from_jax_params(params, moe_config("test", dtype=td, **kw),
                                     device="cpu")
    return jm, params, tm


def _tokens(seed, B=2, S=24):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, S)).astype(
        np.int32)


def test_moe_config_counts_match_jax():
    for size in ("test", "nano", "small", "mixtral_tiny"):
        ours, theirs = moe_config(size), jmoe_config(size)
        assert ours.num_params() == theirs.num_params()
        assert ours.active_params() == theirs.active_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lm_logits_and_aux_match_jax(dtype):
    jm, params, tm = moe_pair(dtype)
    toks = _tokens(40)
    jl, jaux = jax.jit(jm.apply)({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        tl, taux = tm(torch.from_numpy(toks))
    jl = np.asarray(jl, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)
    else:
        scale = float(np.abs(jl).max())
        row_err = np.abs(tl.numpy() - jl).max(-1)  # [B, S]
        assert (row_err <= 4 * scale * 2 ** -8).mean() >= 0.9, row_err
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-2)
    # features with the aux, the blockwise loss's path
    with torch.no_grad():
        feats, faux = tm(torch.from_numpy(toks), return_features=True)
    assert feats.shape == (2, 24, 128) and float(faux) == float(taux)


def _batch(step=0):
    return JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ,
                        batch_size=BATCH).batch(step)


def test_moe_losses_match_jax():
    """``moe_next_token_loss`` (value, xent, router loss) and the
    blockwise loss with the router losses added, against JAX's."""
    jm, params, tm = moe_pair()
    batch = _batch(1)
    apply = lambda p, *a, **k: jm.apply({"params": p}, *a, **k)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for jloss, tloss in ((jlosses.moe_next_token_loss, moe_next_token_loss),
                         (jlosses.blockwise_next_token_loss(8),
                          blockwise_next_token_loss(8))):
        jl, jaux = jax.jit(lambda p, b: jloss(p, b, None, apply))(params, jb)
        with torch.no_grad():
            tl, taux = tloss(tm, tb, None)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
        assert taux.keys() == jaux.keys() == {"xent", "router_loss"}
        for key in jaux:
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                       atol=1e-5)


def test_routing_metrics_stay_on_the_layers():
    jm, params, tm = moe_pair()
    with torch.no_grad():
        tm(torch.from_numpy(_tokens(41)))
    for layer in tm.layers:
        m = layer.mlp.metrics
        assert set(m) == {"aux_loss", "z_loss", "dropped_fraction"}
        assert 0.0 <= float(m["dropped_fraction"]) < 1.0


def test_moe_autodistribute_trajectory_matches_jax():
    """MoE ``test`` (RMSNorm, rope, 4 SwiGLU experts top-2), fp32,
    adamw(1e-3), fresh batches: 5 losses within 1e-5, and the last 3
    again from JAX's state after its step 2
    (``interop.train_state_from_jax``)."""
    jm = moe_pair()[0]
    ad = JAutoDistribute(jm, optimizer=optax.adamw(1e-3),
                         loss_fn=jlosses.moe_next_token_loss,
                         devices=jax.devices()[:1])
    state = ad.init(jax.random.key(0), _batch(0))
    tad = AutoDistribute(
        interop.moe_from_jax_params(
            jax.tree.map(np.asarray, state.params),
            moe_config("test", vocab_size=VOCAB, max_seq_len=64,
                       dtype=torch.float32), device="cpu"),
        optimizer=adamw(1e-3), loss_fn=moe_next_token_loss, device="cpu")
    tstate = tad.init(None, _batch(0))
    want, got, snap = [], [], None
    for i in range(5):
        if i == 2:
            snap = types.SimpleNamespace(
                step=np.asarray(state.step),
                params=jax.tree.map(np.asarray, state.params),
                opt_state=jax.tree.map(np.asarray, state.opt_state))
        state, m = ad.step(state, _batch(i))
        tstate, tm = tad.step(tstate, _batch(i))
        want.append((float(m["loss"]), float(m["router_loss"])))
        got.append((float(tm["loss"]), float(tm["router_loss"])))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the port continuing JAX's state after its step 2
    cad = AutoDistribute(interop.from_jax_params(snap.params, tad.model,
                                                 device="cpu"),
                         optimizer=adamw(1e-3), loss_fn=moe_next_token_loss,
                         device="cpu")
    cstate = interop.train_state_from_jax(cad, snap)
    cont = []
    for i in range(2, 5):
        cstate, m = cad.step(cstate, _batch(i))
        cont.append((float(m["loss"]), float(m["router_loss"])))
    np.testing.assert_allclose(cont, want[2:], atol=1e-5, rtol=0)


@pytest.mark.parametrize("strategy", ["auto", "fsdp", "tp_fsdp"])
def test_make_plan_on_moe_matches_jax_at_one_device(strategy):
    """At ep 1: the same strategy, remat and per-parameter sizes; the
    expert count both planners detect."""
    tm = moe_pair()[2]
    jabs = jax.eval_shape(
        JMoE("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32,
             scan_layers=False).init,
        jax.random.key(4), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jabs)
    jplan = jplanner.make_plan(jabs, strategy=strategy,
                               devices=jax.devices()[:1])
    pabs = planner.abstract_params(tm)
    assert planner.detect_expert_count(pabs) == \
        jplanner.detect_expert_count(jabs) == 4
    plan = planner.make_plan(pabs, strategy=strategy,
                             topology=topology.parse_topology("cpu-1"),
                             heads=(4, 4))
    jdeg = jtopo.mesh_degrees(jplan.mesh)
    assert (plan.strategy, plan.remat) == (jplan.strategy, jplan.remat)
    assert {a: d for a, d in plan.degrees.items() if d > 1} == {
        a: d for a, d in jdeg.items() if d > 1}
    jflat = dict(jplanner._flatten_with_paths(params))
    jspecs = dict(jplanner._flatten_with_paths(jplan.param_specs))
    assert sorted(map(interop.jax_param_path, pabs)) == sorted(jflat)
    for name, spec in plan.param_specs.items():
        jpath = interop.jax_param_path(name)
        got = planner.leaf_shard_slices(tuple(pabs[name].shape), spec,
                                        plan.degrees)[0]
        want = jplanner.leaf_shard_slices(jflat[jpath].shape, jspecs[jpath],
                                          jdeg)[0]
        assert math.prod(b - a for a, b in got) == math.prod(
            b - a for a, b in want), name


def test_moe_decoding_is_refused():
    """MoE decoding stays a later slice: ``generate`` and the serving
    engine raise naming it."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference import (
        decode,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
        ServeEngine,
    )

    tm = moe_pair()[2]
    with pytest.raises(NotImplementedError, match="item 6"):
        decode.generate(tm, torch.zeros(1, 4, dtype=torch.long),
                        max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        ServeEngine(tm, device="cpu")
