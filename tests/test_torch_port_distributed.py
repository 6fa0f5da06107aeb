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
  as JAX's do;
- 4 ranks: ``fsdp``, and ``tp_fsdp`` on 2 x 2 with the clip;
- 1 rank: ``dp``, ``fsdp``, ``tp`` and ``tp_fsdp``, each wrapper applied
  at degree 1, as on one card.

GPT-2 ``test`` in fp32 (dropout 0: each rank would draw its own masks),
adamw(1e-3), 5 steps on fresh batches.  Tolerances: the 5 losses within
2e-5 relative of JAX's (the same fp32 arithmetic, summed in another
order across ranks), the final parameters within 1e-4 absolute (10 % of
one Adam step of ~lr), the key biases within 5e-3 (their gradient is
rounding noise, as in ``test_torch_port_train.py``); the clip threshold
0.1 sits below the gradient norm, so every step is clipped.  Three runs
also check the trained state's ``eval_step`` (2e-5 relative of JAX's)
and ``generate`` (the tokens of a plain decode with the same weights),
and every run its journal's ``plan`` events.  The
collectives are held to ``jax.lax`` inside ``shard_map`` on the same
local values, exactly.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from torch_automatic_distributed_neural_network_tpu import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
    SyntheticLM as JSyntheticLM,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2
from torch_automatic_distributed_neural_network_tpu.training import losses as jlosses
from torch_automatic_distributed_neural_network_tpu.training import lora as jlora
from torch_automatic_distributed_neural_network_tpu.utils.jax_compat import shard_map
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    lora_from_jax,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
    generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
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
             inspect=True)],
}


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


def _jax_run(world, run, base=None):
    opt = optax.adamw(1e-3)
    if run.get("clip"):
        opt = optax.chain(optax.clip_by_global_norm(run["clip"]), opt)
    loss, init_fn = jlosses.next_token_loss, None
    if run.get("lora"):
        opt = jlora.lora_optimizer(opt)
        loss = jlora.lora_loss(loss, JLORA_SPEC)
        init_fn = jlora.lora_init_fn(base, JLORA_SPEC)
    ad = JAutoDistribute(_jax_model(), optimizer=opt, loss_fn=loss,
                         init_fn=init_fn, strategy=run["strategy"],
                         devices=jax.devices()[:world],
                         zero1=run.get("zero1", False),
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
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
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
           "prompt": torch.from_numpy(PROMPT), "lora_spec": LORA_SPEC}
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
