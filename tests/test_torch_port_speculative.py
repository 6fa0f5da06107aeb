"""Speculative decoding: the PyTorch port's ``inference/speculative.py``
and the engine's ``speculative=k`` verify steps against the JAX
package's, on the same weights and seeded prompts.

- ``ngram_propose`` / ``accept_length``: equal to JAX's over
  hypothesis-drawn histories (host code, exact).
- ``speculative_generate``: token ids equal to JAX's and to the port's own
  greedy ``generate``, with a self-draft (every proposal accepted) and an
  unrelated random draft (rollbacks), fp32 caches (exact).
- ``ServeEngine(speculative=3)``: tokens and the drafted / accepted
  counts equal to the JAX engine's, and the tokens equal to
  ``speculative=0``; every verify step takes the dense route (exact).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_automatic_distributed_neural_network_tpu.inference import (
    speculative as jspec,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    ServeEngine as JaxEngine,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2, Llama
from torch_automatic_distributed_neural_network_tpu_torch.inference import (
    speculative as tspec,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
    generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    ServeEngine,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    decoder_from_jax_params,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
    llama_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
)

VOCAB = 128
FAMILIES = {"gpt2": (GPT2, gpt2_config), "llama": (Llama, llama_config)}


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 6), max_size=30), st.integers(0, 6),
       st.integers(1, 4))
def test_ngram_propose_matches_jax(history, k, max_n):
    assert tspec.ngram_propose(history, k, max_n=max_n) == \
        jspec.ngram_propose(history, k, max_n=max_n)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 3), max_size=8),
       st.lists(st.integers(0, 3), max_size=8))
def test_accept_length_matches_jax(drafts, targets):
    assert tspec.accept_length(drafts, targets) == \
        jspec.accept_length(drafts, targets)


@functools.lru_cache(maxsize=None)
def model_pair(family, n_layers=2, seed=1):
    jcls, tcfg = FAMILIES[family]
    kw = dict(vocab_size=VOCAB, max_seq_len=64, n_layers=n_layers)
    jm = jcls("test", dtype=jnp.float32, remat=False, **kw)
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))
    tm = decoder_from_jax_params(
        jax.tree.map(np.asarray, variables["params"]),
        tcfg("test", dtype=torch.float32, **kw), device="cpu")
    return jm, variables, tm


def _prompt(seed=0, P=10):
    return np.random.RandomState(seed).randint(0, VOCAB, (1, P)).astype(
        np.int32)


@pytest.mark.parametrize("family,draft,k", [
    ("gpt2", "self", 3), ("llama", "unrelated", 4)])
def test_speculative_generate_matches_jax_and_greedy(family, draft, k):
    jm, jv, tm = model_pair(family)
    jd, jdv, td = (model_pair(family) if draft == "self"
                   else model_pair(family, n_layers=1, seed=99))
    prompt = _prompt()
    want = np.asarray(jspec.speculative_generate(
        jm, jv, jd, jdv, jnp.asarray(prompt), max_new_tokens=17, k=k,
        cache_dtype=jnp.float32))
    got = tspec.speculative_generate(tm, td, torch.from_numpy(prompt),
                                     max_new_tokens=17, k=k,
                                     cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = generate(tm, torch.from_numpy(prompt), max_new_tokens=17,
                      cache_dtype=torch.float32)
    assert torch.equal(got, greedy)


def test_speculative_generate_checks():
    _, _, tm = model_pair("gpt2")
    p = torch.from_numpy(_prompt())
    with pytest.raises(NotImplementedError, match="batch 1"):
        tspec.speculative_generate(tm, tm, p.repeat(2, 1), max_new_tokens=2)
    with pytest.raises(ValueError, match="k must be"):
        tspec.speculative_generate(tm, tm, p, max_new_tokens=2, k=0)
    with pytest.raises(ValueError, match="headroom"):
        tspec.speculative_generate(tm, tm, p, max_new_tokens=50, k=4)
    other = DecoderLM(gpt2_config("test", vocab_size=VOCAB * 2))
    with pytest.raises(ValueError, match="vocabularies differ"):
        tspec.speculative_generate(tm, other, p, max_new_tokens=2)
    assert torch.equal(tspec.speculative_generate(
        tm, tm, p, max_new_tokens=0), p.to(torch.int32))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_engine_speculative_matches_jax(family):
    """``speculative=3``: tokens and accept counts equal to the JAX engine
    with the same options, tokens equal to ``speculative=0``, and every
    decode step a dense verify step (T = 4)."""
    jm, variables, tm = model_pair(family)
    rs = np.random.RandomState(8)
    # repetitive prompts, so prompt lookup has something to find
    prompts = [[int(t) for t in np.tile(rs.randint(1, VOCAB, 4), 4)[:n]]
               for n in (13, 9, 16)]
    geom = dict(n_slots=2, max_len=64, block_size=8, prefill_chunk=8)
    jeng = JaxEngine(jm, variables, attention_impl="dense", speculative=3,
                     **geom)
    jreqs = [jeng.submit(p, max_new_tokens=12, eos_id=0) for p in prompts]
    jeng.run()
    jnl = Journal(None, host0_only=False)
    eng = ServeEngine(tm, device="cpu", speculative=3, journal=jnl, **geom)
    reqs = [eng.submit(p, max_new_tokens=12, eos_id=0) for p in prompts]
    eng.run()
    eng.scheduler.check_invariants()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert (eng.spec_drafted, eng.spec_accepted) == (
        jeng.spec_drafted, jeng.spec_accepted)
    assert eng.spec_accepted > 0
    spec = [r for r in jnl.records if r["name"] == "serve.speculate"]
    assert sum(r["accepted"] for r in spec) == eng.spec_accepted
    assert eng.decode_routes == {"paged": 0, "dense": len(spec)}
    plain = ServeEngine(tm, device="cpu", **geom)
    preqs = [plain.submit(p, max_new_tokens=12, eos_id=0) for p in prompts]
    plain.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in preqs]
    assert plain.decode_routes["dense"] == 0


def test_engine_speculative_checks():
    from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
        SampleConfig,
    )

    _, _, tm = model_pair("gpt2")
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(tm, device="cpu", max_len=64, speculative=2,
                    sample=SampleConfig(temperature=1.0))
    with pytest.raises(ValueError, match=">= 0"):
        ServeEngine(tm, device="cpu", max_len=64, speculative=-1)
    eng = ServeEngine(tm, device="cpu", max_len=64, speculative=4)
    with pytest.raises(ValueError, match="lookahead"):
        eng.submit([1] * 50, max_new_tokens=12)
