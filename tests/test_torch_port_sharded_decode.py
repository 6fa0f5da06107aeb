"""Sharded decoding: ``AutoDistribute.generate`` and ``generate(mesh=)``
on the plan's wrapped model, 2 and 4 gloo ranks on the CPU (one spawn of
``tests/torch_port_dist_worker.py`` per world size), against the JAX
package's unsharded ``generate`` on the same weights
(``tests/test_generate.py``'s sharded cases: JAX pins its sharded decode
to its unsharded one).

- GPT-2 ``test`` (fp32) under ``tp_fsdp`` (tensor 2 on 2 ranks; fsdp 2 x
  tensor 2 on 4): the weights stay sharded (a layer's q projection holds
  its tensor rank's rows, further split over fsdp), each rank decodes its
  rows and kv heads;
- MoE ``test`` (4 SwiGLU experts, top-2, capacity factor 8, fp32) under
  ``ep`` (expert 2, expert 4): routed decode exchanging the dispatched
  slots over the expert group, and the dense combine reading the banks
  whole; each rank holds E / ep experts.

- GPT-2 ``test`` under ``tp_fsdp`` with LoRA factors on q, v and o
  (rank 4, JAX's ``random_adapter`` at scale 0.2), against JAX's
  ``generate`` on the merged weights: the adapted modules merge the
  factors shard by shard in their forward;
- a ``mixed`` state (fp32 masters apart from the module's bf16 copies),
  plain and with the LoRA factors, on 4 ranks (fsdp 2 x tensor 2):
  ``AutoDistribute.generate`` decodes the fp32 masters, as JAX's
  ``generate`` decodes ``state.params``, through a copy that the plan
  wraps empty and each rank fills with its own shards.

- ``generate(quant="int8")`` under ``tp_fsdp`` on 2 and 4 ranks, against
  JAX's ``generate`` on its ``quantize_for_decode`` weights: each rank
  quantizes its own shards (a row-split weight's channel maxima taken
  over ``tensor``, so every rank uses the scale of the whole weight), and
  the bytes of parameters a rank holds while it decodes (its trained
  shards and the int8 copy's) stay under the whole model's.

B 8 x prompt 8, 5 new tokens, greedy, fp32 cache.  Tokens must be equal
(no tolerance), on every rank, both ways of calling (``generate(mesh=)``
on the module's own weights: under ``mixed`` its bf16 copies, which
are held only to decode on every rank alike).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference.decode import (
    generate as jgenerate,
)
from torch_automatic_distributed_neural_network_tpu.inference.quant import (
    quantize_for_decode as jquantize,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve.adapters import (
    random_adapter,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2
from torch_automatic_distributed_neural_network_tpu.models import MoE as JMoE
from torch_automatic_distributed_neural_network_tpu.training import lora as jlora
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
    lora_from_jax,
    moe_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
    moe_config,
)

from torch_automatic_distributed_neural_network_tpu_torch.training import lora as tlora

from torch_port_spawn import spawn

VOCAB, B, P, NEW = 128, 8, 8, 5
PROMPT = np.random.RandomState(7).randint(0, VOCAB, (B, P)).astype(np.int32)
JSPEC = jlora.LoraSpec(rank=4, targets=(
    jlora.LoraTarget(r"q_proj/kernel", 1, 2),
    jlora.LoraTarget(r"v_proj/kernel", 1, 2), jlora.O_LIKE))
TSPEC = tlora.LoraSpec(rank=4, targets=(
    tlora.LoraTarget(r"q_proj\.weight$", 1, 1, True),
    tlora.LoraTarget(r"v_proj\.weight$", 1, 1, True), tlora.O_LIKE))
RUNS = [dict(name="tp_fsdp", model="gpt2", strategy="tp_fsdp"),
        dict(name="ep-routed", model="moe", strategy="ep",
             moe_decode="routed"),
        dict(name="ep-dense", model="moe", strategy="ep",
             moe_decode="dense")]
EXTRA = {2: [dict(name="tp_fsdp-lora", model="gpt2", strategy="tp_fsdp",
                  lora=True),
             dict(name="tp_fsdp-int8", model="gpt2", strategy="tp_fsdp",
                  quant="int8")],
         4: [dict(name="tp_fsdp-mixed", model="gpt2", strategy="tp_fsdp",
                  precision="mixed"),
             dict(name="tp_fsdp-lora-mixed", model="gpt2",
                  strategy="tp_fsdp", lora=True, precision="mixed"),
             dict(name="tp_fsdp-int8", model="gpt2", strategy="tp_fsdp",
                  quant="int8")]}


@functools.lru_cache(maxsize=None)
def jax_side(model):
    """(port config, port state dict, JAX's unsharded tokens per decode
    mode) of one model."""
    if model == "gpt2":
        jm = GPT2("test", vocab_size=VOCAB, max_seq_len=64,
                  dtype=jnp.float32, remat=False)
        cfg = gpt2_config("test", vocab_size=VOCAB, max_seq_len=64,
                          dtype=torch.float32)
        load = decoder_from_jax_params
    else:
        jm = JMoE("test", vocab_size=VOCAB, max_seq_len=64,
                  dtype=jnp.float32, remat=False, capacity_factor=8.0)
        cfg = moe_config("test", vocab_size=VOCAB, max_seq_len=64,
                         dtype=torch.float32, capacity_factor=8.0)
        load = moe_from_jax_params
    variables = jm.init(jax.random.key(4), jnp.asarray(PROMPT))
    want = {mode: np.asarray(jgenerate(
        jm, variables, jnp.asarray(PROMPT), max_new_tokens=NEW,
        cache_dtype=jnp.float32, moe_decode=mode))
        for mode in (("dense", "routed") if model == "moe" else ("dense",))}
    if model == "gpt2":
        want["int8"] = np.asarray(jgenerate(
            jm, {"params": jquantize(variables["params"])},
            jnp.asarray(PROMPT), max_new_tokens=NEW,
            cache_dtype=jnp.float32))
        merged = jlora.merge_lora(variables["params"], jax_lora(), JSPEC)
        want["lora"] = np.asarray(jgenerate(
            jm, {"params": merged}, jnp.asarray(PROMPT), max_new_tokens=NEW,
            cache_dtype=jnp.float32))
    sd = load(jax.tree.map(np.asarray, variables["params"]), cfg,
              device="cpu").state_dict()
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}, sd, want


@functools.lru_cache(maxsize=None)
def jax_lora():
    """A tenant with visible deltas on GPT-2 ``test``'s q, v and o."""
    jm = GPT2("test", vocab_size=VOCAB, max_seq_len=64, dtype=jnp.float32,
              remat=False)
    params = jm.init(jax.random.key(4), jnp.asarray(PROMPT))["params"]
    return random_adapter(params, JSPEC, seed=3, scale=0.2)


@functools.lru_cache(maxsize=None)
def decode_results(world, tmp_root):
    cfg, _, _ = jax_side("gpt2")
    job = {"decode": {
        "runs": RUNS + EXTRA[world], "max_new": NEW, "lora_spec": TSPEC,
        "lora": lora_from_jax(jax.tree.map(np.asarray, jax_lora()),
                              cfg["n_layers"])}}
    for model in ("gpt2", "moe"):
        cfg, sd, _ = jax_side(model)
        job["decode"][model] = {"cfg": cfg, "state_dict": sd,
                                "prompt": torch.from_numpy(PROMPT).long()}
    tmp = Path(tmp_root) / f"world{world}"
    tmp.mkdir()
    return spawn(world, job, tmp)["decode"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_decode"))
    return lambda world: decode_results(world, root)


CASES = [(w, run) for w in (2, 4) for run in RUNS + EXTRA[w]]


@pytest.mark.parametrize("world,run", CASES,
                         ids=[f"{w}x-{r['name']}" for w, r in CASES])
def test_sharded_generate_matches_jax(results, world, run):
    _, _, want = jax_side(run["model"])
    want = want["lora" if run.get("lora") else run.get(
        "quant", run.get("moe_decode", "dense"))]
    if run.get("lora"):
        assert not np.array_equal(want, jax_side("gpt2")[2]["dense"])
    ranks = results(world)[run["name"]]
    assert len(ranks) == world
    for rank, rec in enumerate(ranks):
        assert rec["strategy"] == run["strategy"]
        np.testing.assert_array_equal(rec["generated"].numpy(), want,
                                      err_msg=f"rank {rank}")
        if run.get("quant"):
            # nothing gathered whole: the trained shards and the int8
            # decode model's (the shards' payloads and scales, the norms
            # and biases) stay under the whole model's bytes
            assert rec["direct"] is None
            assert rec["held_bytes"] < rec["whole_bytes"], rec
        elif run.get("precision") == "mixed":
            # the module computes with bf16 copies: every rank alike
            np.testing.assert_array_equal(
                rec["direct"].numpy(), ranks[0]["direct"].numpy(),
                err_msg=f"rank {rank} generate(mesh=)")
        else:
            np.testing.assert_array_equal(
                rec["direct"].numpy(), want,
                err_msg=f"rank {rank} generate(mesh=)")
        deg = rec["degrees"]
        local = rec["local_shapes"]
        if run["model"] == "gpt2":
            assert deg["tensor"] == 2 and deg["fsdp"] == world // 2
            # q_proj [4 heads x 32, 128]: the rank's heads (dim 0), then
            # its fsdp shard; never whole
            shape = local["layers.0.attn.q_proj.weight"]
            assert shape[0] == 128 // 2
            assert np.prod(shape) == 128 * 128 // world
            # generate's model holds the same shards: the module, or the
            # copy of the fp32 masters
            mixed = run.get("precision") == "mixed"
            int8 = run.get("quant") == "int8"
            assert rec["decodes_on_module"] is not (mixed or int8)
            assert rec["decode_q"] == (tuple(shape), torch.int8 if int8
                                       else torch.float32)
        else:
            assert deg["expert"] == world
            assert local["layers.0.mlp.experts_up"][0] == 4 // world
