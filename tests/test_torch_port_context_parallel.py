"""The PyTorch port's context parallelism (ring and Ulysses attention
over a ``seq`` axis) against the JAX package's: 2 and 4 gloo ranks on
the CPU beside JAX on as many of its CPU devices, from the same weights
(drawn by JAX, carried over) on the same batches.

Each world spawns its ranks once (``torch_port_dist_worker.py``, the
``cp`` and ``cp_ops`` sections of its job):

- ``ring_attention`` and ``ulysses_attention`` over a seq axis of the
  whole world, causal and not, ring with GQA (8 query heads, 2 kv
  heads): each rank's slice of the output and of the q, k, v gradients
  of ``sum(o * w)`` against JAX's dense ``xla_attention`` on the whole
  sequence and its ``jax.grad`` (2e-5, JAX's bound for the outputs,
  ``tests/test_long_context.py``); the differentiable ring step and
  gather of slices, exactly; and the dispatcher's refusals under the
  axis (a mask, a window, flash);
- GPT-2 ``test`` (vocab 512, S 64, batch 8, fp32) under ``seq`` 2 on 2
  ranks with ``ring``, ``ulysses`` and ``auto`` (with ``eval_step``,
  ``ad(state, x)`` and ``generate``), and with a padding mask that
  leaves the two sequence slices unequal token counts; ``seq`` 2 x
  ``fsdp`` 2 on 4 ranks; adamw(1e-3), 3 steps.  The losses within 5e-4
  relative of JAX's (JAX's own bound for context parallelism against one
  device) and, as they come out much closer, within 2e-5; the final
  parameters within 3e-4 (the key biases 5e-3): the ring's online
  softmax sums in another order than JAX's dense one, and an Adam step
  on a weight whose gradient is rounding noise moves it by up to the
  learning rate, 1e-3; the token counts the step reports are the global
  batch's;
- EP x CP: MoE ``test`` (4 SwiGLU experts, top-2, fp32) under ``ep``
  with ``seq_parallel=2`` on 4 ranks (expert 2 x seq 2, JAX's layout):
  each MoE layer routes whole rows gathered over ``seq``, so the losses
  hold to JAX's within 5e-4 (its bound, ``tests/test_moe.py``) and the
  parameters within 3e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_distributed import _spawn

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticLM as JSyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.models import MoE as JMoE
from torch_automatic_distributed_neural_network_tpu.ops.attention import (
    xla_attention as jxla_attention,
)
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
    generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    moe_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
    moe_config,
)

VOCAB, SEQ, BATCH, STEPS = 512, 65, 8, 3
PROMPT = np.random.RandomState(3).randint(0, VOCAB, (2, 6))

RUNS = {
    2: [dict(name="ring", kw=dict(seq_parallel=2, seq_impl="ring")),
        dict(name="ulysses", kw=dict(seq_parallel=2, seq_impl="ulysses")),
        dict(name="auto", kw=dict(seq_parallel=2), inspect=True),
        dict(name="masked_ring", kw=dict(seq_parallel=2, seq_impl="ring"),
             masked=True)],
    4: [dict(name="seq_x_fsdp", kw=dict(seq_parallel=2, strategy="fsdp"))],
}


def _mask():
    """Padding at the end of rows: the first half of the sequence keeps
    more tokens than the second."""
    mask = np.ones((BATCH, SEQ), np.int32)
    for row, keep in enumerate((65, 60, 40, 33, 20, 65, 50, 10)):
        mask[row, keep:] = 0
    return mask


def _batches(masked=False):
    data = JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ, batch_size=BATCH)
    out = [data.batch(i) for i in range(STEPS)]
    if masked:
        out = [{**b, "mask": _mask()} for b in out]
    return out


def _jax_run(world, run):
    kw = dict(run["kw"])
    strategy = kw.pop("strategy", "dp")
    ad = JAutoDistribute(
        JGPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32),
        optimizer=optax.adamw(1e-3), loss_fn=jlosses.next_token_loss,
        strategy=strategy, devices=jax.devices()[:world], **kw)
    batches = _batches(run.get("masked", False))
    state = ad.init(jax.random.key(0), batches[0])
    params0 = jax.tree.map(np.asarray, state.params)
    losses, tokens = [], []
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
        tokens.append(float(m["tokens"]))
    out = {"params0": params0, "losses": losses, "tokens": tokens,
           "plan": ad.plan, "params": jax.tree.map(np.asarray, state.params)}
    if run.get("inspect"):
        out["eval_loss"] = float(ad.eval_step(state, batches[0])["loss"])
    return out


MOE_CFG = dict(vocab_size=VOCAB, max_seq_len=64)
MOE_RUN = dict(name="ep_x_cp", strategy="ep", kw=dict(seq_parallel=2))


def _jax_moe_run(world):
    ad = JAutoDistribute(JMoE("test", dtype=jnp.float32, **MOE_CFG),
                         optimizer=optax.adamw(1e-3),
                         loss_fn=jlosses.moe_next_token_loss, strategy="ep",
                         seq_parallel=2, devices=jax.devices()[:world])
    batches = _batches()
    state = ad.init(jax.random.key(0), batches[0])
    params0 = jax.tree.map(np.asarray, state.params)
    losses = []
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
    return {"params0": params0, "losses": losses, "plan": ad.plan,
            "params": jax.tree.map(np.asarray, state.params)}


def _qkv(b=2, s=64, h=4, d=16, kvh=None, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda hh: (rng.randn(b, s, hh, d) * 0.3).astype(np.float32)
    return mk(h), mk(kvh or h), mk(kvh or h), rng.randn(b, s, h, d).astype(
        np.float32)


def _op_cases():
    out = []
    for name, impl, causal, heads in (
            ("ring_causal", "ring", True, (4, None)),
            ("ring_full", "ring", False, (4, None)),
            ("ring_gqa", "ring", True, (8, 2)),
            ("ulysses_causal", "ulysses", True, (8, None)),
            ("ulysses_full", "ulysses", False, (8, None))):
        q, k, v, w = _qkv(h=heads[0], kvh=heads[1])
        out.append(dict(name=name, impl=impl, causal=causal, q=q, k=k, v=v,
                        w=w))
    return out


@functools.lru_cache(maxsize=None)
def _results(world, tmp_root):
    from pathlib import Path

    jax_runs = {run["name"]: _jax_run(world, run) for run in RUNS[world]}
    params0 = next(iter(jax_runs.values()))["params0"]
    for r in jax_runs.values():  # JAX draws the same weights on any mesh
        jax.tree.map(np.testing.assert_array_equal, r["params0"], params0)
    cfg = _cfg()
    runs = [dict(run, batches=_batches(run.get("masked", False)))
            for run in RUNS[world]]
    job = {"only_lm": True, "cp_ops": {"ops": _op_cases()},
           "cp": {"cfg": {f: getattr(cfg, f)
                          for f in cfg.__dataclass_fields__},
                  "state_dicts": {"base": decoder_from_jax_params(
                      params0, cfg, device="cpu").state_dict()},
                  "batches": _batches(), "runs": runs,
                  "prompt": torch.from_numpy(PROMPT)}}
    if world == 4:
        jax_runs["moe"] = _jax_moe_run(world)
        mcfg = moe_config("test", dtype=torch.float32, **MOE_CFG)
        job["moe"] = {
            "cfg": {f: getattr(mcfg, f) for f in mcfg.__dataclass_fields__},
            "state_dict": moe_from_jax_params(
                jax_runs["moe"]["params0"], mcfg, device="cpu").state_dict(),
            "batches": _batches(), "runs": [MOE_RUN]}
    tmp = Path(tmp_root) / f"world{world}"
    tmp.mkdir()
    return jax_runs, _spawn(world, job, tmp)


def _cfg():
    return gpt2_config("test", vocab_size=VOCAB, max_seq_len=64,
                       dtype=torch.float32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cp"))
    return lambda world: _results(world, root)


OPS = [(w, c["name"]) for w in (2, 4) for c in _op_cases()]


@pytest.mark.parametrize("world,name", OPS, ids=[f"{w}x-{n}" for w, n in OPS])
def test_ring_and_ulysses_match_dense(results, world, name):
    """Each rank's output slice and its q, k, v gradients, gathered, equal
    JAX's dense attention and its gradients within 2e-5."""
    _, port = results(world)
    case = next(c for c in _op_cases() if c["name"] == name)
    q, k, v, w = (jnp.asarray(case[x]) for x in ("q", "k", "v", "w"))

    def loss(q, k, v):
        return jnp.sum(jxla_attention(q, k, v, causal=case["causal"]) * w)

    want = [jxla_attention(q, k, v, causal=case["causal"]),
            *jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    got = port["cp_ops"][name]
    for label, g, wnt in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=2e-5,
                                   atol=2e-5, err_msg=label)


@pytest.mark.parametrize("world", [2, 4])
def test_differentiable_moves_over_the_seq_axis(results, world):
    """``collectives.ppermute_ring`` (JAX's ``ppermute`` one step round
    the ring): rank i gets rank i-1's value and sends its gradient back
    the other way; ``gather_slices``: every rank gets the slices in rank
    order, and a slice's gradient sums every rank's (JAX's AD of
    ``all_gather``).  Exact."""
    _, port = results(world)
    xs = [torch.arange(6.0).reshape(1, 3, 2) + 10 * r for r in range(world)]
    for r, (y, g) in enumerate(port["cp_ops"]["moves"]["ppermute_ring"]):
        assert torch.equal(y, xs[(r - 1) % world])
        # rank r's value feeds rank r+1's sum, weighted r + 2
        assert torch.equal(g, torch.full_like(g, (r + 1) % world + 1))
    total = sum(range(1, world + 1))
    for y, g in port["cp_ops"]["moves"]["gather_slices"]:
        assert torch.equal(y, torch.cat(xs, dim=1))
        assert torch.equal(g, torch.full_like(g, total))


@pytest.mark.parametrize("world", [2, 4])
def test_attention_refusals_under_a_seq_axis(results, world):
    """Under a seq axis above 1: ring refuses a mask, Ulysses a window,
    and flash the sharded sequence, as in JAX."""
    _, port = results(world)
    got = port["cp_ops"]["refusals"]
    assert "explicit masks" in got["mask"]
    assert "sliding-window" in got["window"]
    assert "cannot span a sharded sequence" in got["flash"]


CASES = [(w, run["name"]) for w in sorted(RUNS) for run in RUNS[w]]


@pytest.mark.parametrize("world,name", CASES,
                         ids=[f"{w}x-{n}" for w, n in CASES])
def test_context_parallel_step_matches_jax(results, world, name):
    """Each run against JAX's on as many devices: the plan (degrees with
    ``seq``), the losses, the global token counts, the final parameters;
    the inspected run's eval loss, forward and tokens."""
    jax_runs, port = results(world)
    run = next(r for r in RUNS[world] if r["name"] == name)
    want, got = jax_runs[name], port["cp"][name]
    plan = want["plan"]
    jdeg = dict(zip(plan.mesh.axis_names, plan.mesh.devices.shape))
    assert got["degrees"] == jdeg and jdeg["seq"] == 2
    assert got["strategy"] == plan.strategy
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=5e-4)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    assert got["tokens"] == want["tokens"]
    if run.get("masked"):
        assert got["tokens"][0] == _mask()[:, 1:].sum()
    cfg = _cfg()
    expect = decoder_from_jax_params(want["params"], cfg,
                                     device="cpu").state_dict()
    assert expect.keys() == got["params"].keys()
    for pname, p in got["params"].items():
        atol = 5e-3 if pname.endswith("k_proj.bias") else 3e-4
        np.testing.assert_allclose(p.numpy(), expect[pname].numpy(),
                                   atol=atol, rtol=0, err_msg=pname)
    if "eval_loss" in want:
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=2e-5, atol=0)
        model = DecoderLM(cfg)
        model.load_state_dict(got["params"])
        prompt = torch.from_numpy(PROMPT)
        with torch.no_grad():
            np.testing.assert_allclose(got["logits"].numpy(),
                                       model(prompt).numpy(), atol=1e-5,
                                       rtol=0)
        np.testing.assert_array_equal(
            got["generated"].numpy(),
            generate(model, prompt, max_new_tokens=4,
                     cache_dtype=torch.float32).numpy())


def test_auto_picks_ulysses_and_ring_traffic(results):
    """``seq_impl='auto'`` at 4 heads over seq 2 and S 64 takes Ulysses
    (all-to-all bytes, no ring bytes), ``ring`` rotates K/V (ring bytes,
    no all-to-all)."""
    _, port = results(2)
    auto, ring = port["cp"]["auto"]["traffic"], port["cp"]["ring"]["traffic"]
    assert auto["all_to_all"] > 0 and auto["ring"] == 0
    assert ring["ring"] > 0 and ring["all_to_all"] == 0


def test_expert_parallel_with_context_parallel_matches_jax(results):
    """MoE ``test`` under ``ep`` with ``seq_parallel=2`` on 4 ranks
    against JAX's plan on 4 devices: expert 2 x seq 2, the losses within
    5e-4 relative (JAX's EP x CP bound) and the parameters within 3e-4."""
    jax_runs, port = results(4)
    want, got = jax_runs["moe"], port["moe"]["ep_x_cp"]
    plan = want["plan"]
    jdeg = dict(zip(plan.mesh.axis_names, plan.mesh.devices.shape))
    assert got["degrees"] == jdeg
    assert (jdeg["expert"], jdeg["seq"]) == (2, 2)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=5e-4)
    cfg = moe_config("test", dtype=torch.float32, **MOE_CFG)
    expect = moe_from_jax_params(want["params"], cfg,
                                 device="cpu").state_dict()
    for pname, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), expect[pname].numpy(),
                                   atol=3e-4, rtol=0, err_msg=pname)


def test_seq_parallel_must_divide_the_devices():
    """``seq_parallel=3`` on 4 devices (JAX
    ``tests/test_long_context.py::test_seq_parallel_must_divide``: 3 on
    8): the planner's ValueError, before any strategy is chosen; 2 takes
    its axis out of the devices first."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        planner,
        topology,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.planner import (
        abstract_params,
    )

    pabs = abstract_params(DecoderLM(_cfg()).to("meta"))
    topo = topology.parse_topology("cpu-4")
    with pytest.raises(ValueError, match="seq-parallel degree 3 does not "
                       "divide 4 devices"):
        planner.make_plan(pabs, topology=topo, seq=3)
    plan = planner.make_plan(pabs, topology=topo, seq=2)
    assert (plan.degrees["seq"], plan.degrees["data"]) == (2, 2)
