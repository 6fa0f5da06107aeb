"""Serving engine: the PyTorch port's ``ServeEngine`` (on the CPU) emits
the JAX package's ``ServeEngine`` greedy tokens, token for token, on the
same weights and prompts.

Geometry of ``tests/test_paged_attention.py``: ``n_slots=2, max_len=64,
block_size=8``.  Covered: GPT-2 ``test`` and Llama ``test``; the port's
paged and dense decode attention; chunked (with a padded final chunk)
and single-shot prefill; int8 KV; optimistic admission with forced
preemption.  The JAX reference runs its dense decode path (its paged
kernel is pinned to it by the JAX package's own tests) except in the
first case, which also runs the JAX paged kernel in interpret mode.
The JAX engine is built without ``export_cache``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    ServeEngine as JaxEngine,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu.obs import schema
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    ServeEngine,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    gpt2_config,
    llama_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops.paged_attention import (
    kernel_takes,
)

VOCAB = 128
FAMILIES = {"gpt2": (GPT2, gpt2_config), "llama": (Llama, llama_config)}


@functools.lru_cache(maxsize=None)
def model_pair(family, max_len=64):
    """A JAX decoder with random weights and the port's copy of it
    (cached: neither side is changed by serving)."""
    jcls, tcfg = FAMILIES[family]
    jm = jcls("test", vocab_size=VOCAB, max_seq_len=max_len,
              dtype=jnp.float32, remat=False)
    variables = jm.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))
    tm = decoder_from_jax_params(
        jax.tree.map(np.asarray, variables["params"]),
        tcfg("test", vocab_size=VOCAB, max_seq_len=max_len,
             dtype=torch.float32), device="cpu")
    return jm, variables, tm


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(1, VOCAB, size=(n,))]
            for n in lengths]


def run_jax(jm, variables, prompts, *, max_new, eos_id, **kw):
    eng = JaxEngine(jm, variables, **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new, eos_id=eos_id)
            for p in prompts]
    eng.run()
    return [r.out_tokens for r in reqs], eng


def run_port(tm, prompts, *, max_new, eos_id, journal=None, **kw):
    eng = ServeEngine(tm, device="cpu", journal=journal, **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new, eos_id=eos_id)
            for p in prompts]
    eng.run()
    eng.scheduler.check_invariants()
    assert eng.pool.allocator.n_live == 0
    return [r.out_tokens for r in reqs], eng


GEOM = dict(n_slots=2, max_len=64, block_size=8)


@pytest.mark.parametrize("family,kw,jax_impls", [
    ("gpt2", dict(), ("dense", "paged")),
    ("gpt2", dict(prefill_chunk=None), ("dense",)),
    ("gpt2", dict(quant_kv=True, prefill_chunk=8), ("dense",)),
    ("llama", dict(prefill_chunk=8), ("dense",)),
    ("llama", dict(quant_kv=True), ("dense",)),
    ("llama", dict(quant_kv=True, prefill_chunk=None), ("dense",)),
], ids=["gpt2-chunk32", "gpt2-single-shot", "gpt2-int8-chunk8",
        "llama-chunk8", "llama-int8-chunk32", "llama-int8-single-shot"])
def test_engine_tokens_match_jax(family, kw, jax_impls):
    jm, variables, tm = model_pair(family)
    # 5, 11 and 13 tokens: with chunk 8 the last chunk is padded
    prompts = _prompts(3, (5, 11, 13))
    want = None
    for impl in jax_impls:
        got, _ = run_jax(jm, variables, prompts, max_new=6, eos_id=0,
                         attention_impl=impl, **GEOM, **kw)
        assert want is None or got == want
        want = got
    for impl in ("paged", "dense"):
        got, eng = run_port(tm, prompts, max_new=6, eos_id=0,
                            attention_impl=impl, **GEOM, **kw)
        assert got == want, (impl, got, want)
        assert eng.prefill_chunk == (kw.get("prefill_chunk", 32))


def test_engine_preemption_matches_jax():
    """Optimistic admission over an undersized pool: the same requests
    are preempted and recomputed, and every token still matches."""
    jm, variables, tm = model_pair("gpt2", max_len=32)
    prompts = _prompts(5, (12, 12, 12, 12))
    kw = dict(n_slots=4, max_len=32, block_size=8, num_blocks=10,
              admission="optimistic")
    want, jeng = run_jax(jm, variables, prompts, max_new=12, eos_id=None,
                         attention_impl="dense", **kw)
    jnl = Journal(None, host0_only=False)
    got, eng = run_port(tm, prompts, max_new=12, eos_id=None,
                        attention_impl="paged", journal=jnl, **kw)
    assert eng.scheduler.n_preemptions > 0, "pool never contended"
    assert eng.scheduler.n_preemptions == jeng.scheduler.n_preemptions
    assert got == want
    preempts = [r for r in jnl.records if r["name"] == "serve.preempt"]
    assert len(preempts) == eng.scheduler.n_preemptions


def test_journal_records_follow_the_jax_event_schema():
    """serve.* records stay readable by the JAX package's tadnn report:
    every record the port writes validates against its schema registry."""
    _, _, tm = model_pair("gpt2")
    jnl = Journal(None, host0_only=False, meta={"tool": "serve"})
    prompts = _prompts(6, (5, 9, 3))
    run_port(tm, prompts, max_new=4, eos_id=None, journal=jnl, **GEOM)
    names = {r["name"] for r in jnl.records}
    assert {"serve.engine", "serve.prefill_chunk", "serve.step",
            "serve.request_done"} <= names
    for rec in jnl.records:
        assert schema.validate_record(rec) == [], rec
    done = [r for r in jnl.records if r["name"] == "serve.request_done"]
    assert len(done) == 3 and all(r["n_new"] == 4 for r in done)


def test_engine_checks_and_later_slices():
    _, _, tm = model_pair("gpt2")
    eng = ServeEngine(tm, device="cpu", n_slots=2, max_len=64,
                      block_size=8, prefill_chunk=48)
    assert eng.prefill_chunk == 16  # gcd(48, 64)
    with pytest.raises(ValueError, match="attention_impl"):
        ServeEngine(tm, device="cpu", attention_impl="fused?")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1] * 60, max_new_tokens=8)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="learned positions"):
        ServeEngine(tm, device="cpu", max_len=128)
    # the export cache is ported (tests/test_torch_port_export.py): off
    # with export_cache=False, nothing recorded
    assert ServeEngine(tm, device="cpu", max_len=64,
                       export_cache=False).export_info == []
    # disaggregated and tensor-parallel serving are ported
    # (tests/test_torch_port_serve_tp.py); a mesh with another axis above
    # 1 is refused
    assert ServeEngine(tm, device="cpu", max_len=64,
                       disaggregate=True).disaggregate
    with pytest.raises(ValueError, match="other than 'tensor'"):
        ServeEngine(tm, device="cpu", max_len=64,
                    mesh={"data": 2, "tensor": 1})
    # LoRA serving is ported (tests/test_torch_port_adapters.py): an
    # engine without a spec refuses a named adapter as the JAX engine does
    with pytest.raises(ValueError, match="without lora_spec"):
        eng.submit([1, 2], max_new_tokens=2, adapter="tenant0")


def test_stochastic_serving_is_reproducible_under_its_generator():
    from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
        SampleConfig,
    )

    _, _, tm = model_pair("llama")
    prompts = _prompts(7, (6, 4))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        got, _ = run_port(tm, prompts, max_new=5, eos_id=None,
                          sample=SampleConfig(temperature=1.0, top_k=20),
                          generator=gen, **GEOM)
        outs.append(got)
    assert outs[0] == outs[1]


def test_cli_serve_smoke_on_cpu(capsys):
    from torch_automatic_distributed_neural_network_tpu_torch.cli import main

    assert main(["serve", "--smoke", "--device", "cpu"]) == 0
    import json

    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_requests"] == 8 and summary["device"] == "cpu"
    assert summary["prefix_cache"] is False and summary["speculative"] == 0
    assert main(["serve", "--smoke", "--device", "cpu", "--prefix-cache",
                 "--shared-prefix", "8", "--speculative", "3"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_requests"] == 8 and summary["speculative"] == 3
    assert summary["prefix_hit_requests"] > 0
    assert summary["spec_accept_rate"] is not None
    assert summary["decode_routes"]["paged"] == 0
    assert main(["serve", "--smoke", "--device", "cpu",
                 "--disaggregate"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["disaggregate"] is True and summary["n_requests"] == 8
    assert summary["kv_ships"] == 8 and summary["shipped_bytes"] > 0
    # --serve-tp N takes N processes (torchrun); one process is refused
    assert main(["serve", "--smoke", "--device", "cpu",
                 "--serve-tp", "2"]) == 2


def test_head_dim_96_decoder_serves_by_the_paged_path():
    """Head dim 96, which the paged kernel has an instance for: the
    engine, built with its defaults, keeps ``paged`` (every decode step
    on the kernel's wrapper, the plain version here), journals it, and
    serves the JAX engine's tokens.  A head dim with no instance is
    refused by ``kernel_takes``, on which the engine raises on a CUDA
    device rather than serve by plain code there."""
    jm = GPT2("test", vocab_size=VOCAB, max_seq_len=64, d_model=192,
              n_heads=2, dtype=jnp.float32, remat=False)
    variables = jm.init(jax.random.key(2), jnp.zeros((1, 4), jnp.int32))
    tm = decoder_from_jax_params(
        jax.tree.map(np.asarray, variables["params"]),
        gpt2_config("test", vocab_size=VOCAB, max_seq_len=64, d_model=192,
                    n_heads=2, dtype=torch.float32), device="cpu")
    assert tm.cfg.head_dim == 96
    prompts = _prompts(9, (5, 12))
    want, _ = run_jax(jm, variables, prompts, max_new=6, eos_id=None,
                      attention_impl="dense", **GEOM)
    jnl = Journal(None, host0_only=False)
    got, eng = run_port(tm, prompts, max_new=6, eos_id=None, journal=jnl,
                        **GEOM)
    assert eng.attention_impl == "paged"
    assert eng.decode_routes["paged"] > 0 and eng.decode_routes["dense"] == 0
    rec, = [r for r in jnl.records if r["name"] == "serve.engine"]
    assert rec["attention_impl"] == "paged"
    assert got == want
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        assert kernel_takes(96, torch.bfloat16, dt)
        assert not kernel_takes(80, torch.bfloat16, dt)
    assert not kernel_takes(64, torch.float16, torch.bfloat16)
