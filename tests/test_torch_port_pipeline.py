"""The PyTorch port's pipeline parallelism against the JAX package's: 2
and 4 gloo ranks on the CPU beside JAX on as many of its CPU devices,
from the same weights (drawn by JAX, carried over) on the same batches.

Each world spawns its ranks once (``torch_port_dist_worker.py``, the
``pipeline`` section of its job) and runs every run in turn:

- 2 ranks, pipe 2, microbatches 4: the schedules ``cond`` (also
  ``eval_step``, ``ad(state, x)``, ``generate`` and a
  ``ShardedCheckpoint`` and a ``CheckpointManager`` (DCP) round trip,
  each restored on the same layout and on one process), ``dense``, ``1f1b`` with ``clip_by_global_norm`` in the
  optimizer, and ``interleaved`` / ``interleaved_1f1b`` with V 2 on a
  4-layer GPT-2; Llama ``test`` (RMSNorm, RoPE, GQA, untied head) under
  ``1f1b``; and, in the port alone, every schedule with dropout 0.1 on
  the 4-layer model;
- 4 ranks: pipe 2 x data 2 (``dp``), pipe 2 x tensor 2 (``tp``,
  microbatches 2: JAX's ``pipe_x_tp``) and pipe 2 x fsdp 2 (``fsdp``,
  microbatches 2, under ``1f1b``).

GPT-2 ``test`` (2 layers, d 128, 4 heads; 4 layers where V is 2), vocab
512, S 64, batch 8, fp32, dropout 0, adamw(1e-3), 3 steps.  Tolerances,
``tests/test_torch_port_distributed.py``'s: the losses within 2e-5
relative of JAX's, the final parameters within 1e-4 (the key biases
5e-3: their gradient is rounding noise); the eval loss 2e-5 relative;
``ad(state, x)`` within 1e-5 of one process's forward with the gathered
weights; the tied embedding's first-step gradient bitwise equal on every
pipe rank and within 1e-5 of one process's (which takes it both from the
embedding and from the head); checkpoints bitwise; with dropout every
schedule's losses within 1e-6 relative of ``cond``'s (JAX's own bound,
``tests/test_pipeline.py``: the masks are drawn per microbatch and
layer, so only the order of the gradient sums differs).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_distributed import _spawn

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticLM as JSyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.models import Llama as JLlama
from torch_automatic_distributed_neural_network_tpu.parallel import pipeline as jpipeline
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu_torch import (
    AutoDistribute,
    next_token_loss,
    planner,
    topology,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
    generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    GPT2,
    MoE,
    gpt2_config,
    llama_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.models.transformer_core import (
    run_layers,
)
from torch_automatic_distributed_neural_network_tpu_torch.parallel import (
    pipeline,
)
from torch_automatic_distributed_neural_network_tpu_torch.planner import (
    abstract_params,
)

VOCAB, SEQ, BATCH, STEPS, CLIP = 512, 65, 8, 3, 0.1
PROMPT = np.random.RandomState(3).randint(0, VOCAB, (2, 6))


def _pipe(schedule="cond", m=4, v=1, **kw):
    return {"pipeline_stages": 2, "microbatches": m,
            "pipeline_schedule": schedule, "pipeline_virtual": v, **kw}


RUNS = {
    2: [dict(name="cond", kw=_pipe(), inspect=True, reshard=True),
        dict(name="dense", kw=_pipe("dense")),
        dict(name="1f1b", kw=_pipe("1f1b"), clip=CLIP),
        dict(name="interleaved", kw=_pipe("interleaved", v=2),
             weights="deep", cfg=dict(n_layers=4)),
        dict(name="interleaved_1f1b", kw=_pipe("interleaved_1f1b", v=2),
             weights="deep", cfg=dict(n_layers=4)),
        dict(name="llama_1f1b", kw=_pipe("1f1b"), weights="llama",
             model="llama", inspect=True)],
    4: [dict(name="pipe_x_data", kw=_pipe(strategy="dp")),
        dict(name="pipe_x_tp", kw=_pipe(m=2, strategy="tp")),
        dict(name="pipe_x_fsdp", kw=_pipe("1f1b", m=2, strategy="fsdp"))],
}
# the port alone: dropout on, every schedule against cond
DROPOUT = [dict(name=f"dropout_{s}", kw=_pipe(s, v=v), weights="deep",
                cfg=dict(n_layers=4, dropout_rate=0.1))
           for s, v in (("cond", 1), ("dense", 1), ("1f1b", 1),
                        ("interleaved", 2), ("interleaved_1f1b", 2))]


def _batches():
    data = JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ, batch_size=BATCH)
    return [data.batch(i) for i in range(STEPS)]


def _jax_model(run):
    kw = dict(vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32)
    if run.get("model") == "llama":
        return JLlama("test", **kw)
    return JGPT2("test", **kw, **{k: v for k, v in run.get("cfg", {}).items()
                                  if k == "n_layers"})


def _port_cfg(run):
    kw = dict(vocab_size=VOCAB, max_seq_len=64, dtype=torch.float32)
    if run.get("model") == "llama":
        return llama_config("test", **kw)
    return gpt2_config("test", **kw, **run.get("cfg", {}))


def _jax_run(world, run):
    opt = optax.adamw(1e-3)
    if run.get("clip"):
        opt = optax.chain(optax.clip_by_global_norm(run["clip"]), opt)
    kw = dict(run["kw"])
    strategy = kw.pop("strategy", "dp")
    ad = JAutoDistribute(_jax_model(run), optimizer=opt,
                         loss_fn=jlosses.next_token_loss, strategy=strategy,
                         devices=jax.devices()[:world], **kw)
    batches = _batches()
    state = ad.init(jax.random.key(0), batches[0])
    params0 = jax.tree.map(np.asarray, state.params)
    losses = []
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
    out = {"params0": params0, "losses": losses, "plan": ad.plan,
           "params": jax.tree.map(np.asarray, state.params)}
    if run.get("inspect"):
        out["eval_loss"] = float(ad.eval_step(state, batches[0])["loss"])
    return out


@functools.lru_cache(maxsize=None)
def _results(world, tmp_root):
    from pathlib import Path

    jax_runs = {run["name"]: _jax_run(world, run) for run in RUNS[world]}
    weights = {}
    for run in RUNS[world]:
        key = run.get("weights", "base")
        sd = decoder_from_jax_params(jax_runs[run["name"]]["params0"],
                                     _port_cfg(run), device="cpu").state_dict()
        if key in weights:  # JAX draws the same weights on any mesh
            for n, t in sd.items():
                assert torch.equal(t, weights[key][n]), n
        weights[key] = sd
    base = _port_cfg({})
    runs = RUNS[world] + (DROPOUT if world == 2 else [])
    for run in runs:  # the Llama run's config rides with the run
        if run.get("model") == "llama":
            run["cfg"] = {f: getattr(_port_cfg(run), f)
                          for f in base.__dataclass_fields__}
    job = {"only_lm": True, "refusals": world == 2,
           "pipeline": {"cfg": {f: getattr(base, f)
                                for f in base.__dataclass_fields__},
                        "state_dicts": weights, "batches": _batches(),
                        "runs": runs, "prompt": torch.from_numpy(PROMPT)}}
    tmp = Path(tmp_root) / f"world{world}"
    tmp.mkdir()
    return jax_runs, _spawn(world, job, tmp)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipe"))
    return lambda world: _results(world, root)


CASES = [(w, run["name"]) for w in sorted(RUNS) for run in RUNS[w]]


@pytest.mark.parametrize("world,name", CASES,
                         ids=[f"{w}x-{n}" for w, n in CASES])
def test_pipeline_step_matches_jax(results, world, name):
    """Each run against JAX's on as many devices: the plan (strategy,
    degrees with ``pipe``, no loss-level remat), the losses, the final
    parameters; each rank holds its stage's layers and no other; the
    tied embedding's gradient equal on every pipe rank; the inspected
    runs' eval loss, forward and tokens; the checkpoint round trips."""
    jax_runs, port = results(world)
    run = next(r for r in RUNS[world] if r["name"] == name)
    want, got = jax_runs[name], port["pipeline"][name]
    plan = want["plan"]
    jdeg = dict(zip(plan.mesh.axis_names, plan.mesh.devices.shape))
    assert got["degrees"] == jdeg and jdeg["pipe"] == 2
    assert (got["strategy"], got["remat"]) == (plan.strategy, plan.remat)
    assert got["remat"] is False
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5,
                               atol=0)
    cfg = _port_cfg(run)
    expect = decoder_from_jax_params(want["params"], cfg,
                                     device="cpu").state_dict()
    assert expect.keys() == got["params"].keys()
    for pname, p in got["params"].items():
        atol = 5e-3 if pname.endswith("k_proj.bias") else 1e-4
        np.testing.assert_allclose(p.numpy(), expect[pname].numpy(),
                                   atol=atol, rtol=0, err_msg=pname)
    # each rank holds its own stage's layers, and every replicated leaf
    v = run["kw"]["pipeline_virtual"] if "interleaved" in name else 1
    names = sorted(got["params"])
    for rank, seen in enumerate(got["ranks"]):
        stage = rank // (world // 2)
        mine = {i for ids in pipeline.chunk_layers(stage, cfg.n_layers, 2, v)
                for i in ids}
        assert seen["held"] == [n for n in names if not n.startswith(
            "layers.") or int(n.split(".")[1]) in mine], rank
        assert got["stages"][f"layers.{min(mine)}.mlp_norm.scale"] == stage
    # the same rows on the other stage: the same gradient (a tensor
    # shard of it under tp; FSDP reduce-scatters it out of sight)
    grads = [r["embed_grad"] for r in got["ranks"]]
    half = world // 2
    if run["kw"].get("strategy") != "fsdp":
        for r in range(half):
            assert torch.equal(grads[r], grads[r + half]), r
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
    if run.get("reshard"):
        assert got["same_layout"] is True
        assert got["dcp_same_layout"] is True
        assert got["resharded"] == {"sharded": True, "dcp": True}


def test_tied_embedding_gradient_takes_both_paths(results):
    """GPT-2's tied ``wte`` under ``cond`` on 2 ranks: its first-step
    gradient on either pipe rank is one process's, which sums a part from
    the embedding lookup (the trunk input's cotangent, broadcast from the
    first stage) and a part from the head; both parts are large."""
    jax_runs, port = results(2)
    got = port["pipeline"]["cond"]["ranks"][0]["embed_grad"]
    cfg = _port_cfg({})
    model = decoder_from_jax_params(jax_runs["cond"]["params0"], cfg,
                                    device="cpu")
    tokens = torch.from_numpy(np.asarray(_batches()[0]["input_ids"]))
    seen = {}

    def trunk(x, positions, generator, mask):
        seen["x"] = x
        x.retain_grad()
        return run_layers(model.layers, cfg, x, positions,
                          [None] * cfg.n_layers, mask)[0]

    loss, _ = next_token_loss(
        lambda t, generator=None: model(t, generator=generator, trunk=trunk),
        {"input_ids": tokens}, None)
    loss.backward()
    full = model.embed.grad
    lookup = torch.zeros_like(full).index_add_(
        0, tokens[:, :-1].reshape(-1),
        seen["x"].grad.reshape(-1, cfg.d_model))
    head = full - lookup
    for part in (lookup, head):
        assert part.norm() > 0.1 * full.norm()
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5, rtol=0)


def test_every_schedule_equals_cond_with_dropout(results):
    """Dropout 0.1 on the 4-layer GPT-2: the masks are drawn per
    (microbatch, global layer) from the step's generator, so every
    schedule trains as ``cond`` does (1e-6 relative, JAX's bound)."""
    _, port = results(2)
    cond = port["pipeline"]["dropout_cond"]["losses"]
    plain = _results_plain_losses()
    assert not np.allclose(cond, plain, rtol=1e-4)  # dropout is on
    for run in DROPOUT[1:]:
        np.testing.assert_allclose(port["pipeline"][run["name"]]["losses"],
                                   cond, rtol=1e-6, err_msg=run["name"])


@functools.lru_cache(maxsize=None)
def _results_plain_losses():
    """The 4-layer model's losses without dropout (JAX's interleaved
    run: the same weights and batches)."""
    return tuple(_jax_run(2, RUNS[2][3])["losses"])


def test_pipeline_refusals_on_two_ranks(results):
    """JAX's refusals, made by ``AutoDistribute`` under a 2-rank group:
    a stateful model, the blockwise loss, microbatches not dividing the
    per-device batch, a virtual stage count with a plain schedule, an
    interleaved schedule whose microbatches the stages do not divide,
    layers not divisible by stages x virtual, and pipe beside seq or an
    expert strategy."""
    _, port = results(2)
    got = port["refusals"]
    assert "stateful models" in got["stateful"]
    assert "blockwise_next_token_loss" in got["blockwise"]
    assert "not divisible by microbatches=3" in got["microbatches"]
    assert "only applies" in got["virtual"]
    assert "microbatches % stages" in got["interleaved_m"]
    assert "not divisible by 2 stages x 2 virtual" in got["layers"]
    assert "cannot be combined with seq_parallel" in got["seq"]
    assert "not supported" in got["ep"]


def test_schedule_algebra_matches_jax():
    """The bubble fraction, and the stage that owns each layer: JAX's
    [V, S, C] view of the stacked layers sharded on S (plain schedules:
    its [L] stack sharded on pipe) against ``stage_of_layer`` and
    ``chunk_layers``; the schedule checks raise JAX's errors."""
    for s, m in ((2, 4), (4, 2), (2, 8)):
        assert pipeline.bubble_fraction(s, m) == jpipeline.bubble_fraction(
            s, m)
    for L, S, V in ((4, 2, 1), (4, 2, 2), (8, 2, 2), (8, 4, 2), (12, 2, 2)):
        owner = np.arange(L).reshape(V, S, L // (S * V))
        for i in range(L):
            v, s, j = np.argwhere(owner == i)[0]
            assert pipeline.stage_of_layer(i, L, S, V) == s
            assert i in pipeline.chunk_layers(s, L, S, V)[v]
    for args, match in (((2, 2, 4, "bogus", 1), "unknown pipeline schedule"),
                        ((2, 2, 4, "interleaved", 1), "virtual >= 2"),
                        ((2, 2, 4, "cond", 2), "only applies"),
                        ((8, 2, 2, "interleaved", 3), "not divisible"),
                        ((8, 4, 2, "interleaved", 2), "microbatches % stages")):
        with pytest.raises(ValueError, match=match):
            pipeline.check_schedule(*args)


def test_planner_pipe_axis_matches_jax():
    """``make_plan`` with ``pipe``: the degrees JAX's planner picks (pipe
    taken out of the devices first), the layers' tensor specs kept on
    their trailing dims under pipe x tensor (JAX's stacked spec minus
    its leading ``pipe``), each layer's stage, the pipe traffic reported
    as model-dependent, and JAX's composition refusals."""
    topo = topology.parse_topology("cpu-4")
    cfg = gpt2_config("test", vocab_size=VOCAB, max_seq_len=64)
    pabs = abstract_params(DecoderLM(cfg).to("meta"))
    jmodel = JGPT2("test", vocab_size=VOCAB, max_seq_len=64)
    jabs = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    for strategy in ("dp", "tp", "fsdp"):
        plan = planner.make_plan(pabs, strategy=strategy, topology=topo,
                                 pipe=2)
        jplan = jplanner.make_plan(jabs, strategy=strategy, pipe=2,
                                   devices=jax.devices()[:4])
        jdeg = dict(zip(jplan.mesh.axis_names, jplan.mesh.devices.shape))
        assert plan.degrees == jdeg, strategy
        assert plan.stages == {n: int(n.split(".")[1]) for n in pabs
                               if n.startswith("layers.")}
        est = planner.expected_collective_bytes(plan, pabs)
        assert "pipe_stage_p2p" in est["model_dependent"]
        if strategy == "tp":
            jspec = jplan.param_specs["layers"]["attn"]["q_proj"]["kernel"]
            assert tuple(jspec)[0] == "pipe"
            assert plan.param_specs["layers.0.attn.q_proj.weight"] == (
                planner.P("tensor"))
    plan = planner.make_plan(pabs, topology=topo, pipe=2, pipe_virtual=1,
                             mesh={"pipe": 2, "data": 2})
    assert plan.stages["layers.1.attn.q_proj.weight"] == 1
    with pytest.raises(ValueError, match="seq-parallel \\+ pipeline"):
        planner.make_plan(pabs, topology=topo, pipe=2, seq=2)
    with pytest.raises(ValueError, match="does not divide"):
        planner.make_plan(pabs, topology=topo, pipe=3)
    with pytest.raises(ValueError, match="not supported"):
        planner.make_plan(abstract_params(MoE("test", vocab_size=256)),
                          strategy="ep", topology=topo, pipe=2)
    with pytest.raises(ValueError, match="not divisible by 4 stages"):
        planner.make_plan(pabs, topology=topo, pipe=4)


def test_autodistribute_argument_checks():
    """The arguments JAX checks before any plan: ``seq_impl``, and
    ``seq_parallel`` beside ``pipeline_stages``."""
    model = GPT2("test", vocab_size=VOCAB)
    with pytest.raises(ValueError, match="seq_impl"):
        AutoDistribute(model, loss_fn=next_token_loss, device="cpu",
                       seq_impl="bogus")
    with pytest.raises(ValueError, match="cannot be combined"):
        AutoDistribute(model, loss_fn=next_token_loss, device="cpu",
                       seq_parallel=2, pipeline_stages=2)
    assert math.isclose(pipeline.bubble_fraction(2, 4), 0.2)
