"""The PyTorch port's planner applied with ``torch.distributed``: 2 and 4
gloo ranks on the CPU against the JAX package on as many of its CPU
devices, from the same weights on the same batches.

Each world size (1, 2 and 4) spawns its ranks once (``torch_port_dist_worker.py``,
``file://`` rendezvous in the test's own directory, a timeout on every
process) and runs every strategy in turn in that one group:

- 2 ranks: ``dp`` (DDP), ``fsdp`` (FSDP2), ``tp`` (``parallelize_module``)
  with ``clip_by_global_norm`` in the optimizer, ``dp`` + ZeRO-1 with
  and without the clip, ``fsdp`` with ``grad_accum=2``, and LoRA
  fine-tuning (q/v/o/up factors of rank 4 on the frozen base,
  ``lora_optimizer``) under ``dp``, ``fsdp``, ``tp_fsdp`` (JAX's plan
  on two devices: every axis of degree 1) and ``tp`` (tensor 2: a
  column-split layer's ``b`` and a row-split layer's ``a`` split with
  their weight): the base stays bitwise as it was and the factors train
  as JAX's do; and ResNet18Thin with BatchNorm under ``dp`` and ``fsdp``
  (``sgd(0.05, momentum=0.9)``, ``softmax_xent_loss_mutable``, 3 steps
  of 16 images of 16 x 16), whose statistics are the global batch's;
  the fsdp state's ``ShardedCheckpoint`` restores into ``dp`` bitwise;
- 4 ranks: ``fsdp``, ``tp_fsdp`` on 2 x 2 with the clip, and the
  hybrid meshes, a data axis beside the others: HSDP on data 2 x fsdp 2,
  DP x TP on data 2 x tensor 2, and ZeRO-1 beside tensor 2 (the JAX
  package on 4 devices with the same degrees); ``strategy="tuned"``,
  whose strategy, degrees and ZeRO-1 equal JAX's ``make_plan(strategy=
  "tuned")`` on 4 devices (no liveness profile, as the port) and whose
  losses JAX's under that plan (the tuning cache in the test's
  directory); then the sharded
  checkpoint's resharding chain, dp/4 -> fsdp/2 -> dp + ZeRO-1/4 -> one
  process, bitwise at every hop (parameters and Adam moments), and the
  divergence check under HSDP tripping on one perturbed data replica;
- 1 rank: ``dp``, ``fsdp``, ``tp`` and ``tp_fsdp``, each wrapper applied
  at degree 1, as on one card;
- expert parallelism, MoE ``test`` (4 SwiGLU experts, top-2, fp32)
  against JAX's GSPMD plan on as many devices: ``ep`` on 2 ranks
  (expert 2; with the clip too) and on 4 (expert 4), ``ep_fsdp`` on
  expert 2 x fsdp 2 and ``ep_tp`` on expert 2 x tensor 2 (the layout
  JAX's planner picks); each bank's placements name the spec's axes,
  the exchange runs 4 times a layer a step (2 forward, 2 backward; 6
  under ep_fsdp's remat); ``ep`` on 2 ranks also checks ``eval_step``,
  ``ad(state, x)``, the routed ``generate`` and a ``ShardedCheckpoint``
  restored on one process bitwise; and ``moe_ffn_sharded`` on both
  worlds against ``moe_ffn`` and JAX's ``moe_ffn_sharded`` (1e-5).

GPT-2 ``test`` in fp32 (dropout 0: each rank would draw its own masks),
adamw(1e-3), 5 steps on fresh batches.  Tolerances: the 5 losses within
2e-5 relative of JAX's (the same fp32 arithmetic, summed in another
order across ranks), the final parameters within 1e-4 absolute (10 % of
one Adam step of ~lr), the key biases within 5e-3 (their gradient is
rounding noise, as in ``test_torch_port_train.py``); the clip threshold
0.1 sits below the gradient norm, so every step is clipped.  Three runs
also check the trained state's ``eval_step`` (2e-5 relative of JAX's),
``generate`` (the tokens of a plain decode with the same weights) and
``ad(state, x)`` (1e-5 of one process's forward with the gathered
weights), and every run its journal's ``plan`` events.  ResNet: the
losses within 2e-4 relative and the running statistics within 1e-3
relative / 1e-5 absolute of JAX's (JAX's own bounds for 8 devices
against 1, ``tests/test_models.py``), ``ad(state, x)`` on both ranks
within 1e-5 of one process's forward with the gathered weights and
statistics, in either mode.  The
collectives are held to ``jax.lax`` inside ``shard_map`` on the same
local values, exactly.
"""

import functools
import math
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu import topology as jtopo
from torch_automatic_distributed_neural_network_tpu import tune as jtune
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticLM as JSyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticClassification as JSyntheticClassification,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2
from torch_automatic_distributed_neural_network_tpu.models import MoE as JMoE
from torch_automatic_distributed_neural_network_tpu.parallel import expert as jexpert
from torch_automatic_distributed_neural_network_tpu.models import resnet as jresnet
from torch_automatic_distributed_neural_network_tpu.topology import (
    build_mesh as jbuild_mesh,
)
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu.training import lora as jlora
from torch_automatic_distributed_neural_network_tpu.utils.jax_compat import shard_map
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    jax_param_path,
    lora_from_jax,
    moe_from_jax_params,
    resnet_from_jax_params,
    train_state_from_jax,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
    generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
    moe_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.parallel import (
    expert as texpert,
)
from torch_automatic_distributed_neural_network_tpu_torch.models.resnet import (
    ResNet,
    ResNetConfig,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    lora as tlora,
)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_port_dist_worker.py"
VOCAB, SEQ, BATCH, STEPS, CLIP = 128, 33, 8, 5, 0.1
PROMPT = np.random.RandomState(3).randint(0, VOCAB, (2, 6))
CFG = dict(vocab_size=VOCAB, max_seq_len=64, dtype=torch.float32)

RUNS = {
    # a world of one, as on one card: each strategy's wrappers on axes of
    # degree 1 (the layout the plan's rules give there)
    1: [dict(name="dp", strategy="dp"), dict(name="fsdp", strategy="fsdp"),
        dict(name="tp", strategy="tp"),
        dict(name="tp_fsdp", strategy="tp_fsdp")],
    2: [dict(name="dp", strategy="dp"),
        dict(name="fsdp", strategy="fsdp", inspect=True),
        dict(name="tp_clip", strategy="tp", clip=CLIP, inspect=True),
        dict(name="zero1", strategy="dp", zero1=True),
        dict(name="zero1_clip", strategy="dp", zero1=True, clip=CLIP),
        dict(name="fsdp_accum2", strategy="fsdp", grad_accum=2),
        dict(name="lora_dp", strategy="dp", lora=True),
        dict(name="lora_fsdp", strategy="fsdp", lora=True),
        dict(name="lora_tp_fsdp", strategy="tp_fsdp", lora=True),
        dict(name="lora_tp", strategy="tp", lora=True)],
    4: [dict(name="fsdp", strategy="fsdp"),
        dict(name="tp_fsdp_clip", strategy="tp_fsdp", clip=CLIP,
             inspect=True),
        dict(name="data2xfsdp2", strategy="auto", mesh={"data": 2, "fsdp": 2}),
        dict(name="data2xtensor2", strategy="auto",
             mesh={"data": 2, "tensor": 2}),
        dict(name="zero1+tensor2", strategy="auto", zero1=True,
             mesh={"data": 2, "tensor": 2}),
        # the cost-model search: JAX's tuned plan without a liveness
        # profile (the port has none), its choice checked in the test
        dict(name="tuned", strategy="tuned")],
}


MOE_RUNS = {
    2: [dict(name="ep", strategy="ep", inspect=True, reshard=True),
        dict(name="ep_clip", strategy="ep", clip=CLIP)],
    4: [dict(name="ep", strategy="ep"),
        dict(name="ep_fsdp", strategy="ep_fsdp",
             mesh={"expert": 2, "fsdp": 2}),
        dict(name="ep_tp", strategy="ep_tp")],
}
MOE_CFG = dict(vocab_size=VOCAB, max_seq_len=64)


@functools.lru_cache(maxsize=None)
def _jax_moe_model():
    return JMoE("test", dtype=jnp.float32, **MOE_CFG)


def _jax_moe_run(world, run):
    opt = optax.adamw(1e-3)
    if run.get("clip"):
        opt = optax.chain(optax.clip_by_global_norm(run["clip"]), opt)
    mesh = (jbuild_mesh(**run["mesh"], devices=jax.devices()[:world])
            if run.get("mesh") else None)
    ad = JAutoDistribute(_jax_moe_model(), optimizer=opt,
                         loss_fn=jlosses.moe_next_token_loss,
                         strategy=run["strategy"],
                         devices=None if mesh else jax.devices()[:world],
                         mesh=mesh)
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
        # the state trained under ep, gathered, and one more step's loss
        out["state"] = types.SimpleNamespace(
            step=np.asarray(state.step), params=out["params"],
            opt_state=jax.tree.map(np.asarray, state.opt_state))
        out["next_loss"] = float(ad.step(state, batches[0])[1]["loss"])
    return out


def _moe_ffn_inputs():
    """JAX's ``test_moe_ffn_sharded_matches_dense`` inputs: 8 rows of 32
    tokens, d 16, 4 experts of f 32."""
    rng = np.random.RandomState(1)
    return {"x": rng.randn(8, 32, 16).astype(np.float32),
            "logits": rng.randn(8, 32, 4).astype(np.float32),
            "w_up": (rng.randn(4, 16, 32) * 0.1).astype(np.float32),
            "w_down": (rng.randn(4, 32, 16) * 0.1).astype(np.float32)}


def _moe_job(world):
    runs = {run["name"]: _jax_moe_run(world, run) for run in MOE_RUNS[world]}
    params0 = next(iter(runs.values()))["params0"]
    for r in runs.values():  # JAX draws the same weights on any mesh
        jax.tree.map(np.testing.assert_array_equal, r["params0"], params0)
    cfg = moe_config("test", dtype=torch.float32, **MOE_CFG)
    job = {"cfg": {f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
           "state_dict": moe_from_jax_params(params0, cfg,
                                             device="cpu").state_dict(),
           "batches": _batches(), "runs": MOE_RUNS[world],
           "prompt": torch.from_numpy(PROMPT)}
    return runs, job


RESNET_CFG = ResNetConfig(stage_sizes=(2, 2), num_classes=10, width=16,
                          small_inputs=True, dtype=torch.float32)
RESNET_RUNS = [dict(name="dp", strategy="dp"),
               dict(name="fsdp", strategy="fsdp", reshard=True)]
RESNET_LR = 0.05


def _images():
    data = JSyntheticClassification(image_shape=(16, 16, 3), num_classes=10,
                                    batch_size=16)
    return [data.batch(i) for i in range(3)]


def _jax_resnet(world, strategy):
    ad = JAutoDistribute(jresnet.ResNet18Thin(dtype=jnp.float32),
                         optimizer=optax.sgd(RESNET_LR, momentum=0.9),
                         loss_fn=jlosses.softmax_xent_loss_mutable,
                         strategy=strategy, devices=jax.devices()[:world])
    batches = _images()
    state = ad.init(jax.random.key(0), batches[0])
    variables0 = jax.tree.map(np.asarray, {"params": state.params,
                                           **state.model_state})
    losses = []
    for b in batches:
        state, m = ad.step(state, b)
        losses.append(float(m["loss"]))
    return {"variables0": variables0, "losses": losses, "plan": ad.plan,
            "batch_stats": jax.tree.map(np.asarray,
                                        state.model_state["batch_stats"])}


def _resnet_job(world):
    runs = {run["name"]: _jax_resnet(world, run["strategy"])
            for run in RESNET_RUNS}
    variables0 = runs["dp"]["variables0"]
    model = resnet_from_jax_params(variables0, RESNET_CFG, device="cpu")
    job = {"cfg": {f: getattr(RESNET_CFG, f)
                   for f in RESNET_CFG.__dataclass_fields__},
           "state_dict": model.state_dict(), "batches": _images(),
           "x": _images()[0]["x"], "lr": RESNET_LR, "runs": RESNET_RUNS}
    return runs, job


# LoRA on every kind of projection: q/v column-split, o row-split, up
# column-split (the MLP view)
JLORA_SPEC = jlora.LoraSpec(rank=4, alpha=8.0, targets=(
    jlora.LoraTarget(r"q_proj/kernel", 1, 2),
    jlora.LoraTarget(r"v_proj/kernel", 1, 2), jlora.O_LIKE,
    jlora.LoraTarget(r"up_proj/kernel", 1, 1)))
LORA_SPEC = tlora.LoraSpec(rank=4, alpha=8.0, targets=(
    tlora.LoraTarget(r"(q_proj|v_proj)\.weight$", 1, 1, True), tlora.O_LIKE,
    tlora.LoraTarget(r"up_proj\.weight$", 1, 1, True)))


def _batches():
    data = JSyntheticLM(vocab_size=VOCAB, seq_len=SEQ, batch_size=BATCH)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_model():
    return GPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32)


def _jax_tuned_plan(world, batch):
    """JAX's ``make_plan(strategy="tuned")`` on ``world`` CPU devices with
    the policy ``AutoDistribute`` builds (the batch's items, one
    accumulation choice, fp32's state factor) and no liveness profile,
    the cache off."""
    model = _jax_model()
    jabs = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.asarray(batch["input_ids"])))["params"]
    return jplanner.make_plan(
        jabs, strategy="tuned", devices=jax.devices()[:world],
        tune_policy=jtune.TunePolicy(
            batch_items=jtune.estimate_batch_items(batch), grad_accums=(1,),
            state_factor=4.0, act_profile=None, use_cache=False))


def _jax_run(world, run, base=None):
    if run["strategy"] == "tuned":
        # trained under the tuned plan: its strategy on its mesh
        plan = _jax_tuned_plan(world, _batches()[0])
        out = _jax_run(world, {**run, "strategy": plan.strategy,
                               "mesh": jtopo.mesh_degrees(plan.mesh),
                               "zero1": plan.zero1}, base)
        out["tuned_plan"] = plan
        return out
    opt = optax.adamw(1e-3)
    if run.get("clip"):
        opt = optax.chain(optax.clip_by_global_norm(run["clip"]), opt)
    loss, init_fn = jlosses.next_token_loss, None
    if run.get("lora"):
        opt = jlora.lora_optimizer(opt)
        loss = jlora.lora_loss(loss, JLORA_SPEC)
        init_fn = jlora.lora_init_fn(base, JLORA_SPEC)
    mesh = (jbuild_mesh(**run["mesh"], devices=jax.devices()[:world])
            if run.get("mesh") else None)
    ad = JAutoDistribute(_jax_model(), optimizer=opt, loss_fn=loss,
                         init_fn=init_fn, strategy=run["strategy"],
                         devices=None if mesh else jax.devices()[:world],
                         mesh=mesh, zero1=run.get("zero1", False),
                         grad_accum=run.get("grad_accum", 1))
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


def _spawn(world, job, tmp_path):
    """Every rank of one gloo world; rank 0's results."""
    job_path, out_path = tmp_path / "job.pt", tmp_path / "out.pt"
    torch.save(job, job_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "TADNN_TUNE_CACHE": str(tmp_path / "tune_cache.jsonl")}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(rank), str(world),
         str(tmp_path / "pg"), str(job_path), str(out_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]
    errors = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {rank} of {world} timed out (a hung collective)")
        if proc.returncode:
            errors.append(f"rank {rank}: rc {proc.returncode}\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return torch.load(out_path, weights_only=False)


def _port_params(params, cfg):
    """A JAX run's parameters by the port's names: a LoRA run's base and
    factors (``lora_named``) together."""
    if set(params) == {"base", "lora"}:
        return {**_port_params(params["base"], cfg), **tlora.lora_named(
            lora_from_jax(params["lora"], cfg.n_layers))}
    return decoder_from_jax_params(params, cfg, device="cpu").state_dict()


@functools.lru_cache(maxsize=None)
def _results(world, tmp_root):
    plain = [run for run in RUNS[world] if not run.get("lora")]
    jax_runs = {run["name"]: _jax_run(world, run) for run in plain}
    params0 = next(iter(jax_runs.values()))["params0"]
    for r in jax_runs.values():  # JAX draws the same weights on any mesh
        jax.tree.map(np.testing.assert_array_equal, r["params0"], params0)
    cfg = gpt2_config("test", **CFG)
    job = {"cfg": {f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
           "state_dict": decoder_from_jax_params(
               params0, cfg, device="cpu").state_dict(),
           "batches": _batches(), "runs": RUNS[world],
           "prompt": torch.from_numpy(PROMPT), "lora_spec": LORA_SPEC,
           "reshard": world == 4}
    if world == 2:
        jax_runs["resnet"], job["resnet"] = _resnet_job(world)
    if world in MOE_RUNS:
        jax_runs["moe"], job["moe"] = _moe_job(world)
        job["moe_ffn"] = _moe_ffn_inputs()
    for run in RUNS[world]:
        if run.get("lora"):
            r = jax_runs[run["name"]] = _jax_run(world, run, base=params0)
            # the same base and the same initial factors on any mesh
            jax.tree.map(np.testing.assert_array_equal,
                         r["params0"]["base"], params0)
            lora0 = lora_from_jax(r["params0"]["lora"], cfg.n_layers)
            for name, fac in job.setdefault("lora", lora0).items():
                for side in ("a", "b"):
                    assert torch.equal(fac[side], lora0[name][side])
    tmp = Path(tmp_root) / f"world{world}"
    tmp.mkdir()
    return jax_runs, _spawn(world, job, tmp)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    return lambda world: _results(world, root)


CASES = [(w, run["name"]) for w in sorted(RUNS) for run in RUNS[w]]


@pytest.mark.parametrize("world,name", CASES, ids=[f"{w}x-{n}" for w, n in CASES])
def test_sharded_step_matches_jax(results, world, name):
    jax_runs, port = results(world)
    want, got = jax_runs[name], port["runs"][name]
    plan = want["plan"]
    assert got["strategy"] == plan.strategy
    assert got["zero1"] == plan.zero1
    assert got["remat"] == plan.remat
    jdeg = dict(zip(plan.mesh.axis_names, plan.mesh.devices.shape))
    assert got["degrees"] == jdeg
    if "tuned_plan" in want:
        tuned = want["tuned_plan"]
        assert (got["strategy"], got["degrees"], got["zero1"]) == (
            tuned.strategy, jtopo.mesh_degrees(tuned.mesh), tuned.zero1)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5,
                               atol=0)
    assert got["tokens"] == [BATCH * (SEQ - 1)] * STEPS
    cfg = gpt2_config("test", **CFG)
    expect = _port_params(want["params"], cfg)
    assert expect.keys() == got["params"].keys()
    lora = "lora" in name
    for pname, p in got["params"].items():
        if lora and not tlora.is_lora_name(pname):
            # the frozen base, bitwise as it was
            np.testing.assert_array_equal(p.numpy(), expect[pname].numpy(),
                                          err_msg=pname)
            continue
        atol = 5e-3 if pname.endswith("k_proj.bias") else 1e-4
        np.testing.assert_allclose(p.numpy(), expect[pname].numpy(),
                                   atol=atol, rtol=0, err_msg=pname)
    (event,) = got["events"]["plan"]
    assert (event["strategy"], event["mesh"], event["zero1"]) == (
        plan.strategy, jdeg, plan.zero1)
    (est,) = got["events"]["comms.estimate"]
    assert est["mesh"] == jdeg
    assert len(got["events"]["plan.zero1"]) == int(plan.zero1)
    if "eval_loss" in want:
        # eval on the global batch; generate gathers the full weights on
        # each rank and decodes there: the tokens of a plain decode with
        # the same (gathered) weights
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=2e-5, atol=0)
        model = DecoderLM(cfg)
        model.load_state_dict(got["params"])
        np.testing.assert_array_equal(
            got["generated"].numpy(),
            generate(model, torch.from_numpy(PROMPT), max_new_tokens=4))
        # the forward on every rank: one process's with the same weights
        with torch.no_grad():
            want_logits = model(torch.from_numpy(PROMPT))
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want_logits.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", [run["name"] for run in RESNET_RUNS])
def test_resnet_batchnorm_matches_jax_on_two_ranks(results, name):
    """ResNet18Thin on 2 gloo ranks against JAX on 2 devices: global-batch
    statistics, so the losses and running statistics are JAX's; the
    forward on every rank is one process's; the fsdp state reshards."""
    jax_runs, port = results(2)
    want, got = jax_runs["resnet"][name], port["resnet"][name]
    plan = want["plan"]
    assert (got["strategy"], got["remat"]) == (plan.strategy, plan.remat)
    assert got["degrees"] == dict(zip(plan.mesh.axis_names,
                                      plan.mesh.devices.shape))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4,
                               atol=0)
    assert len(got["model_state"]) == 30
    for bname, t in got["model_state"].items():
        tree = want["batch_stats"]
        for key in jax_param_path(bname).split("/"):
            tree = tree[key]
        np.testing.assert_allclose(t.numpy(), tree, rtol=1e-3, atol=1e-5,
                                   err_msg=bname)
    model = ResNet(RESNET_CFG)
    model.load_state_dict({**got["params"], **got["model_state"]})
    x = torch.from_numpy(_images()[0]["x"])
    with torch.no_grad():
        for train, key in ((False, "call"), (True, "call_train"),
                           (False, "call_gathered")):
            np.testing.assert_allclose(got[key].numpy(),
                                       model(x, train=train).numpy(),
                                       atol=1e-5, rtol=0, err_msg=key)
    if name == "fsdp":
        assert got["resharded"] is True


def test_plans_shard_the_parameters(results):
    """The wrappers hold the shards the plan names: FSDP on 4 ranks keeps
    a quarter of each sharded weight; TP x FSDP on 2 x 2 a quarter of a
    projection, a quarter of the k bias (its head dim over tensor, then
    fsdp, where the JAX layout puts fsdp on the heads) and half of the
    MLP's up bias (a 1-D leaf whose one dim TP took: FSDP leaves it
    alone, unpadded); ZeRO-1 leaves the parameters whole."""
    _, port2 = results(2)
    _, port4 = results(4)
    h = 128
    fsdp = port4["runs"]["fsdp"]["local_shapes"]
    assert fsdp["layers.0.mlp.up_proj.weight"] == (4 * h // 4, h)
    assert fsdp["embed"] == (VOCAB // 4, h)
    tpf = port4["runs"]["tp_fsdp_clip"]["local_shapes"]
    assert tpf["layers.0.attn.q_proj.weight"] == (h // 2, h // 2)
    assert tpf["layers.0.attn.o_proj.weight"] == (h // 2, h // 2)
    assert tpf["layers.0.attn.k_proj.bias"] == (h // 4,)
    assert tpf["layers.0.mlp.up_proj.bias"] == (4 * h // 2,)
    assert port2["runs"]["zero1"]["local_shapes"]["embed"] == (VOCAB, h)
    lora_tp = port2["runs"]["lora_tp"]["local_shapes"]
    assert lora_tp["layers.0.attn.q_proj.lora_a"] == (h, 4)
    assert lora_tp["layers.0.attn.q_proj.lora_b"] == (4, h // 2)
    assert lora_tp["layers.0.attn.o_proj.lora_a"] == (h // 2, 4)
    assert lora_tp["layers.0.attn.o_proj.lora_b"] == (4, h)
    assert lora_tp["layers.0.mlp.up_proj.lora_b"] == (4, 4 * h // 2)
    assert port2["runs"]["tp_clip"]["local_shapes"][
        "layers.0.mlp.down_proj.weight"] == (h, 4 * h // 2)
    topo = port4["topology"]
    assert (topo.num_devices, topo.platform, topo.device_kind) == (
        4, "cpu", "cpu")
    # the flash entry points refuse a DTensor operand (even on the CPU,
    # where a plain tensor takes the plain version)
    for msg in port2["flash_refusals"]:
        assert msg is not None and "DTensor" in msg


def _jax_collectives(world, x_of_rank):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    xs = jnp.concatenate([x_of_rank(r) for r in range(world)])
    ops = {
        "allreduce": lambda x: jax.lax.psum(x, "data"),
        "allmean": lambda x: jax.lax.pmean(x, "data"),
        "allgather": lambda x: jax.lax.all_gather(x, "data", axis=1,
                                                  tiled=True),
        "allgather_stacked": lambda x: jax.lax.all_gather(x, "data"),
        "reduce_scatter": lambda x: jax.lax.psum_scatter(
            x, "data", scatter_dimension=0, tiled=True),
        "broadcast": lambda x: jax.lax.all_gather(x, "data")[world - 1],
        "all_to_all": lambda x: jax.lax.all_to_all(
            x, "data", split_axis=0, concat_axis=1, tiled=True),
        "ppermute_ring": lambda x: jax.lax.ppermute(
            x, "data", [(i, (i + 1) % world) for i in range(world)]),
    }
    out = {}
    for name, op in ops.items():
        fn = shard_map(lambda x: op(x)[None], mesh=mesh, in_specs=JP("data"),
                       out_specs=JP("data"))
        out[name] = np.asarray(fn(xs))
    return out


@pytest.mark.parametrize("world", sorted(RUNS))
def test_collectives_match_jax(results, world):
    _, port = results(world)

    def x_of_rank(r):
        x = np.arange(world * 6, dtype=np.float32).reshape(world * 2, 3)
        return jnp.asarray(x + 100.0 * r)

    want = _jax_collectives(world, x_of_rank)
    for rank, got in enumerate(port["collectives"]):
        assert got["axis_index"] == rank
        for name, arr in want.items():
            np.testing.assert_array_equal(got[name].numpy(), arr[rank],
                                          err_msg=f"{name} rank {rank}")


def test_sharded_checkpoint_reshards_bitwise(results):
    """A ``ShardedCheckpoint`` step written under dp on 4 ranks restores
    under fsdp on 2, is written again and restores under dp + ZeRO-1 on
    4, and again on one process: parameters and Adam moments bitwise
    equal to the first state at every hop (JAX's dp/8 -> fsdp/4 ->
    dp+zero1/8 chain, ``tests/test_launch.py``)."""
    _, port = results(4)
    assert port["reshard"] == {"fsdp/2": True, "dp+zero1/4": True,
                               "one process": True}


def test_divergence_check_trips_under_hsdp(results):
    """data 2 x fsdp 2: a healthy state passes (each replica sums its
    fsdp shards, reduced over the shard group), one replica's perturbed
    shard trips the check."""
    _, port = results(4)
    got = port["hsdp_divergence"]
    assert got["healthy"] is None
    assert "Parameter divergence across hosts at step 1" in got["perturbed"]


MOE_CASES = [(w, run["name"]) for w in sorted(MOE_RUNS) for run in MOE_RUNS[w]]


@pytest.mark.parametrize("world,name", MOE_CASES,
                         ids=[f"{w}x-{n}" for w, n in MOE_CASES])
def test_expert_parallel_step_matches_jax(results, world, name):
    """MoE ``test`` under an expert strategy on ``world`` gloo ranks
    against JAX's plan on as many devices: the plan, the 5 losses within
    2e-5 relative, the final parameters within 1e-4; each bank a
    ``DTensor`` over the axes of JAX's spec (``expert``, and ``tensor``
    under ep_tp), of the local shape they give; the exchange's launches
    a step; the inspected run's eval loss (2e-5), forward (1e-5 of one
    process's with the gathered weights), routed tokens (a plain routed
    decode's) and checkpoint (restored on one process, bitwise)."""
    jax_runs, port = results(world)
    want, got = jax_runs["moe"][name], port["moe"][name]
    plan = want["plan"]
    jdeg = dict(zip(plan.mesh.axis_names, plan.mesh.devices.shape))
    assert (got["strategy"], got["remat"]) == (plan.strategy, plan.remat)
    assert got["degrees"] == jdeg
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5,
                               atol=0)
    cfg = moe_config("test", dtype=torch.float32, **MOE_CFG)
    expect = moe_from_jax_params(want["params"], cfg,
                                 device="cpu").state_dict()
    assert expect.keys() == got["params"].keys()
    for pname, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), expect[pname].numpy(),
                                   atol=1e-4, rtol=0, err_msg=pname)
    jspecs = dict(jplanner._flatten_with_paths(plan.param_specs))
    banks = [n for n in got["params"] if "experts_" in n]
    assert len(banks) == 3 * cfg.n_layers
    for bname in banks:
        # JAX scans the layers: its bank spec has the layer dim first
        jpath = re.sub(r"layers_\d+", "layers", jax_param_path(bname))
        spec = tuple(jspecs[jpath])[1:]
        axes = {a for e in spec if e
                for a in (e if isinstance(e, tuple) else (e,))}
        assert "expert" in axes
        assert ("tensor" in axes) == (name == "ep_tp")
        placed = {axis: dim for axis, dim in got["placements"][bname]
                  if dim is not None}
        assert placed == {a: d for d, e in enumerate(spec) if e
                          for a in (e if isinstance(e, tuple) else (e,))}, (
            bname, placed, spec)
        full = expect[bname].shape
        shape = tuple(
            n // math.prod(jdeg[a] for a in (
                e if isinstance(e, tuple) else (e,))) if e else n
            for n, e in zip(full, tuple(spec) + (None,) * len(full)))
        assert got["local_shapes"][bname] == shape, bname
    # 2 exchanges a layer forward and their inverses backward; each
    # recompute runs the forward's again: the layer's own remat
    # (``cfg.remat``, JAX's default) and the plan's around the loss
    per_layer = 2 * (1 + cfg.remat + got["remat"]) + 2
    assert got["exchanges"] == [per_layer * cfg.n_layers] * len(got["losses"])
    if "eval_loss" in want:
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=2e-5, atol=0)
    if "logits" in got:
        model = moe_from_jax_params(want["params"], cfg, device="cpu")
        model.load_state_dict(got["params"])
        with torch.no_grad():
            want_logits = model(torch.from_numpy(PROMPT))[0]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want_logits.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(
            got["generated"].numpy(),
            generate(model, torch.from_numpy(PROMPT), max_new_tokens=4,
                     cache_dtype=torch.float32, moe_decode="routed"))
    if MOE_RUNS[world][[r["name"] for r in MOE_RUNS[world]].index(
            name)].get("reshard"):
        assert got["resharded"] is True


@pytest.mark.parametrize("world", sorted(MOE_RUNS))
def test_moe_ffn_sharded_matches_moe_ffn(results, world):
    """``moe_ffn_sharded`` on 2 ranks (expert 2) and 4 (data 2 x expert
    2) against the unsharded ``moe_ffn`` and JAX's ``moe_ffn_sharded``
    on as many devices (JAX's ``test_moe_ffn_sharded_matches_dense``):
    the output within 1e-5, the aux loss within 1e-5 relative."""
    _, port = results(world)
    got = port["moe_ffn_sharded"]
    mf = _moe_ffn_inputs()
    with torch.no_grad():
        dense_y, dense_m = texpert.moe_ffn(
            *(torch.from_numpy(mf[k]) for k in ("x", "logits", "w_up",
                                                "w_down")), top_k=2)
    np.testing.assert_allclose(got["y"].numpy(), dense_y.numpy(), rtol=1e-5,
                               atol=1e-5)
    degrees = {"expert": 2} if world == 2 else {"data": 2, "expert": 2}
    jmesh = jbuild_mesh(**degrees, devices=jax.devices()[:world])
    jy, jm = jax.jit(lambda *a: jexpert.moe_ffn_sharded(
        *a, mesh=jmesh, top_k=2))(*(jnp.asarray(mf[k]) for k in (
            "x", "logits", "w_up", "w_down")))
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for key in ("aux_loss", "z_loss", "dropped_fraction"):
        np.testing.assert_allclose(got[key], float(dense_m[key]), rtol=1e-5)
        np.testing.assert_allclose(got[key], float(jm[key]), rtol=1e-5)


def test_train_state_from_jax_trained_under_ep(results):
    """A JAX MoE state trained under ``ep`` on 2 devices, carried to the
    port by ``interop.train_state_from_jax`` (the gathered tree is the
    unsharded one): one more step on one process gives JAX's next loss
    within 2e-5 relative."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        moe_next_token_loss,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        adamw,
    )

    jax_runs, _ = results(2)
    want = jax_runs["moe"]["ep"]
    cfg = moe_config("test", dtype=torch.float32, **MOE_CFG)
    ad = AutoDistribute(moe_from_jax_params(want["params"], cfg,
                                            device="cpu"),
                        optimizer=adamw(1e-3), loss_fn=moe_next_token_loss,
                        device="cpu")
    state = train_state_from_jax(ad, want["state"])
    assert state.step == STEPS
    state, m = ad.step(state, _batches()[0])
    np.testing.assert_allclose(float(m["loss"]), want["next_loss"],
                               rtol=2e-5, atol=0)
