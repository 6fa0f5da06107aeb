"""On-card tests of the PyTorch port's CUDA kernels (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip elsewhere.  They
import neither jax nor the JAX package, and the repository's
``conftest.py`` imports jax, so on the card they run without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The paged-attention kernel is held against its plain version
(``paged_attention_reference``) on the same inputs, over the sweep of
``test_torch_port_paged_attention.py``, and with its context split over
more blocks than there are attended pages (ctx 0, short contexts,
windows that empty whole splits), bitwise equal from one launch to the
next and across many launches of changing shapes (its merge counters
reset); the engine's paged decode path against its dense one, token for
token.  The flash-attention kernels (K1 forward, K2 dk/dv, K3 dq) are
held against their plain versions at two geometries; the bf16 K1-K3 on
the tensor cores also at hd 32, 64 and 128 over ragged lengths, causal
and windowed, bitwise equal from one launch to the next, with their tile
products checked against ``torch.matmul``; each wrapper refuses what its
kernel does not take, and one training step of GPT-2 ``test`` through
the kernels agrees with the same step through ``xla`` attention.  The
checkpoint layer round-trips a train state of CUDA tensors bitwise, and
holds the state as it was at ``save`` while the next steps write the
same tensors.
"""

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    quantize_kv,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops import (
    flash_attention as fa,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops import (
    paged_attention as pa,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode; its "
                    "plain version is tested on the CPU)")
    return torch.device("cuda")


def _pool(rs, *, S, MB, bs, kvH, hd, NB, ctx_lens, pool_dtype, device):
    k = torch.from_numpy(rs.randn(NB, bs, kvH, hd).astype(np.float32))
    v = torch.from_numpy(rs.randn(NB, bs, kvH, hd).astype(np.float32))
    k, v = k.to(device), v.to(device)
    if pool_dtype == torch.int8:
        k, v = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(pool_dtype), v.to(pool_dtype)
    tables = np.zeros((S, MB), np.int32)
    nxt = 1
    for s, ctx in enumerate(ctx_lens):
        n = ctx // bs + 1
        tables[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return (k, v, torch.from_numpy(tables).to(device),
            torch.tensor(ctx_lens, dtype=torch.int32, device=device))


@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("pool_dtype",
                         [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [None, 5])
def test_kernel_matches_plain_version(cuda, block_size, pool_dtype, window):
    """GQA 8q/4kv, ragged ctx, a null-table slot; fp32 q: atol 1e-5."""
    rs = np.random.RandomState(0)
    S, Hq, kvH, hd = 5, 8, 4, 32
    ctx_lens = [0, 5, 17, 41, 0]
    k, v, tables, ctx = _pool(
        rs, S=S, MB=48 // block_size, bs=block_size, kvH=kvH, hd=hd, NB=32,
        ctx_lens=ctx_lens, pool_dtype=pool_dtype, device=cuda)
    tables[4] = 0  # inactive slot: all-null table
    q = torch.from_numpy(rs.randn(S, Hq, hd).astype(np.float32)).to(cuda)
    before = paged_attention.launches
    got = paged_attention(q, k, v, tables, ctx, window=window)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_reference(q, k, v, tables, ctx, window=window)
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err < 1e-5, err


@pytest.mark.parametrize("hd", [64, 128])
def test_kernel_bf16_query(cuda, hd):
    """bf16 q (and output) against the plain version: atol 2e-2."""
    rs = np.random.RandomState(1)
    S, Hq, kvH, bs = 4, 16, 4, 16
    k, v, tables, ctx = _pool(
        rs, S=S, MB=8, bs=bs, kvH=kvH, hd=hd, NB=40,
        ctx_lens=[3, 40, 77, 127], pool_dtype=torch.bfloat16, device=cuda)
    q = torch.from_numpy(rs.randn(S, Hq, hd).astype(np.float32))
    q = q.to(cuda, torch.bfloat16)
    got = paged_attention(q, k, v, tables, ctx)
    want = paged_attention_reference(q, k, v, tables, ctx)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [None, 4, 20])
@pytest.mark.parametrize("splits", [None, 2, 7, 16])
def test_kernel_split_context(cuda, pool_dtype, window, splits):
    """More splits than attended pages: ctx 0, contexts inside one chunk,
    windows that leave whole splits empty; fp32 q, atol 1e-5.  Two
    launches are bitwise equal (the splits merge in a fixed order), and a
    slot with no attended key (ctx -1) gives zeros."""
    rs = np.random.RandomState(4)
    S, Hq, kvH, hd, bs = 6, 8, 4, 32, 8
    ctx_lens = [0, 5, 7, 8, 30, 47]
    k, v, tables, ctx = _pool(
        rs, S=S, MB=6, bs=bs, kvH=kvH, hd=hd, NB=40, ctx_lens=ctx_lens,
        pool_dtype=pool_dtype, device=cuda)
    q = torch.from_numpy(rs.randn(S, Hq, hd).astype(np.float32)).to(cuda)
    got = pa._paged_attention_cuda(q, k, v, tables, ctx, window=window,
                                   splits=splits)
    again = pa._paged_attention_cuda(q, k, v, tables, ctx, window=window,
                                     splits=splits)
    want = paged_attention_reference(q, k, v, tables, ctx, window=window)
    model = pa.paged_attention_split_reference(
        q.cpu(), *(x.cpu() if torch.is_tensor(x) else
                   {n: t.cpu() for n, t in x.items()} for x in (k, v)),
        tables.cpu(), ctx.cpu(), window=window, n_split=splits or 1)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) < 1e-5
    assert float((got.cpu() - model).abs().max()) < 1e-5
    ctx[2] = -1
    empty = pa._paged_attention_cuda(q, k, v, tables, ctx, window=window,
                                     splits=splits)
    assert not empty[2].any() and bool(torch.isfinite(empty).all())


def test_kernel_many_launches_reset_the_merge_counters(cuda):
    """Launches of changing shapes and split counts, one after another
    (the counters of the in-launch merge must come back to zero each
    time): every launch matches its plain version."""
    rs = np.random.RandomState(5)
    for i in range(24):
        S = 1 + i % 5
        kvH, G, bs = (4, 2, 8) if i % 2 else (2, 4, 16)
        ctx_lens = [int(c) for c in rs.randint(0, 6 * bs, size=S)]
        k, v, tables, ctx = _pool(
            rs, S=S, MB=6, bs=bs, kvH=kvH, hd=64, NB=1 + 6 * S,
            ctx_lens=ctx_lens, pool_dtype=torch.bfloat16, device=cuda)
        q = torch.from_numpy(rs.randn(S, kvH * G, 64).astype(np.float32))
        q = q.to(cuda)
        got = pa._paged_attention_cuda(q, k, v, tables, ctx, window=None,
                                       splits=None if i % 3 else 1 + i % 7)
        want = paged_attention_reference(q, k, v, tables, ctx)
        assert float((got - want).abs().max()) < 1e-5, i
    assert not pa._counters[got.device].any()


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 4, 32, device=cuda, dtype=torch.float16)
    k = torch.zeros(4, 8, 2, 32, device=cuda)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    ctx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        paged_attention(q, k, k, tables, ctx)
    with pytest.raises(TypeError):
        paged_attention(q.float(), k, k, tables.long(), ctx)


def test_engine_paged_matches_dense_on_card(cuda):
    from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
        ServeEngine,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.models import GPT2

    with torch.device(cuda):
        model = GPT2("test", vocab_size=128, max_seq_len=64,
                     dtype=torch.float32)
    model.init_weights(torch.Generator(device=cuda).manual_seed(1))
    rs = np.random.RandomState(3)
    prompts = [[int(t) for t in rs.randint(1, 128, size=(n,))]
               for n in (5, 11, 9)]
    outs = {}
    for impl in ("paged", "dense"):
        for quant_kv in (False, True):
            before = paged_attention.launches
            eng = ServeEngine(model, n_slots=2, max_len=64, block_size=8,
                              attention_impl=impl, quant_kv=quant_kv,
                              device=cuda)
            reqs = [eng.submit(p, max_new_tokens=6, eos_id=None)
                    for p in prompts]
            eng.run()
            launched = paged_attention.launches - before
            assert (launched > 0) == (impl == "paged")
            outs[impl, quant_kv] = [r.out_tokens for r in reqs]
    assert outs["paged", False] == outs["dense", False]
    assert outs["paged", True] == outs["dense", True]


# -- flash attention (K1-K3) ----------------------------------------------------

# fp32: the same products summed in another order; bf16: outputs rounded
# to bf16 on both sides, one ulp at |x| in [2, 4)
_FLASH_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_operands(rs, B, S, H, hd, dtype, device):
    return [torch.from_numpy(rs.randn(B, S, H, hd).astype(np.float32))
            .to(device, dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [
    dict(B=2, S=200, H=4, hd=64, causal=True, window=37),  # ragged, banded
    dict(B=1, S=130, H=2, hd=128, causal=False, window=None)])
def test_flash_kernels_match_plain_versions(cuda, dtype, geom):
    g = dict(geom)
    causal, window = g.pop("causal"), g.pop("window")
    q, k, v, do = _flash_operands(np.random.RandomState(7), **g, dtype=dtype,
                                  device=cuda)
    kw = dict(causal=causal, window=window)
    before = [w.launches for w in (fa.flash_forward, fa.flash_dkv,
                                   fa.flash_dq)]
    o, lse = fa.flash_forward(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal, window)
    delta = fa._delta(o_ref, do)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, **kw)
    want = (o_ref, lse_ref,
            *fa.flash_dkv_reference(q, k, v, do, lse_ref, delta, causal,
                                    window),
            fa.flash_dq_reference(q, k, v, do, lse_ref, delta, causal,
                                  window))
    torch.cuda.synchronize()
    assert [w.launches for w in (fa.flash_forward, fa.flash_dkv,
                                 fa.flash_dq)] == [n + 1 for n in before]
    for got, ref in zip((o, lse, dk, dv, dq), want):
        assert got.dtype == ref.dtype and bool(torch.isfinite(got).all())
        err = float((got.float() - ref.float()).abs().max())
        assert err <= _FLASH_BOUND[dtype], err


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_sm90_tile_products_match_matmul(cuda, hd):
    """One 64-row tile through the bf16 kernels' TMA loads, wgmma
    descriptors and register fragments (rows 64.. of a 100-row sequence:
    the end is zero-filled) against ``torch.matmul``: relative 1e-5."""
    rs = np.random.RandomState(hd)
    q, k, v, _ = _flash_operands(rs, 2, 100, 3, hd, torch.bfloat16, cuda)
    s, o = fa.sm90_tile_check(q, k, v, s0=64, h=2, b=1)

    def tile(x):
        t = torch.zeros(64, hd, device=cuda)
        t[:36] = x[1, 64:, 2].float()
        return t

    s_ref = tile(q) @ tile(k).T
    o_ref = s.to(torch.bfloat16).float() @ tile(v)
    for got, ref in ((s, s_ref), (o, o_ref)):
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert err <= 1e-5, err


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 64, 65, 129, 1000])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 256)])
def test_flash_bf16_tensor_core_kernels_match_plain_versions(cuda, hd, S,
                                                             causal, window):
    """bf16 K1 (o, lse), K2 (dk, dv) and K3 (dq) on the tensor cores
    against their plain versions: atol 2e-2, one bf16 ulp at |x| in
    [2, 4); and dv equal to its plain version in all but 2 % of its
    elements, which K2 meets only by keeping p in fp32 for dv += p^T . do
    (one bf16 rounding of p moves ~40 % of them:
    test_torch_port_flash_bf16.py)."""
    q, k, v, do = _flash_operands(np.random.RandomState(S + hd), 2, S, 3, hd,
                                  torch.bfloat16, cuda)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_forward(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal, window)
    delta = fa._delta(o_ref, do)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, **kw)
    want = (o_ref, lse_ref, *fa.flash_dkv_reference(q, k, v, do, lse_ref,
                                                    delta, causal, window),
            fa.flash_dq_reference(q, k, v, do, lse_ref, delta, causal,
                                  window))
    torch.cuda.synchronize()
    for got, ref in zip((o, lse, dk, dv, dq), want):
        assert got.dtype == ref.dtype and bool(torch.isfinite(got).all())
        assert float((got.float() - ref.float()).abs().max()) <= 2e-2
    assert float((dv != want[3]).float().mean()) <= 0.02


def test_flash_bf16_tensor_core_kernels_are_deterministic(cuda):
    """Two launches on the same inputs give bitwise-equal outputs."""
    q, k, v, do = _flash_operands(np.random.RandomState(9), 2, 300, 4, 64,
                                  torch.bfloat16, cuda)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_forward(q, k, v, causal=True)
        delta = fa._delta(o, do)
        runs.append((o, lse, *fa.flash_dkv(q, k, v, do, lse, delta,
                                           causal=True),
                     fa.flash_dq(q, k, v, do, lse, delta, causal=True)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rs = np.random.RandomState(8)
    q, k, v, do = _flash_operands(rs, 1, 64, 2, 64, torch.float32, cuda)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(TypeError):  # fp16 is not taken
        fa.flash_forward(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(q[..., :48].contiguous(), k[..., :48].contiguous(),
                         v[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2))
    with pytest.raises(ValueError, match="lse / delta"):
        fa.flash_dkv(q, k, v, do, lse[..., :32], lse)
    with pytest.raises(NotImplementedError, match="seq_q == seq_k"):
        fa.flash_dq(q, k[:, :32].contiguous(), v[:, :32].contiguous(), do,
                    lse, lse, causal=True)


def test_training_step_flash_matches_xla_on_card(cuda):
    """GPT-2 ``test`` (bf16 compute, remat "dots"), one ``AutoDistribute``
    step on one batch: flash against xla attention.  Loss within 1e-2 and
    the gradient norm within 2e-2 relative (bf16 compute; the xla path
    rounds its scores to bf16, the kernels keep them fp32)."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2,
        AutoDistribute,
        SyntheticLM,
        adamw,
        next_token_loss,
    )

    batch = SyntheticLM(vocab_size=128, seq_len=129, batch_size=4).batch(0)
    out = {}
    for impl in ("flash", "xla"):
        ad = AutoDistribute(GPT2("test", vocab_size=128, max_seq_len=128,
                                 attention_impl=impl),
                            optimizer=adamw(1e-3), loss_fn=next_token_loss,
                            device=cuda)
        state = ad.init(torch.Generator(device=cuda).manual_seed(3))
        before = fa.flash_dkv.launches
        _, _, grads = ad._value_and_grad(ad._to_device(batch), None)
        assert (fa.flash_dkv.launches > before) == (impl == "flash")
        norm = float(torch.sqrt(sum((g.float() ** 2).sum()
                                    for g in grads.values())))
        state, metrics = ad.step(state, batch)
        out[impl] = (float(metrics["loss"]), norm)
    (lf, nf), (lx, nx) = out["flash"], out["xla"]
    assert abs(lf - lx) <= 1e-2
    assert abs(nf - nx) / nx <= 2e-2


def _cuda_train_state(cuda, steps):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2,
        AutoDistribute,
        SyntheticLM,
        adamw,
        next_token_loss,
    )

    data = SyntheticLM(vocab_size=128, seq_len=33, batch_size=2)
    ad = AutoDistribute(GPT2("test", vocab_size=128, max_seq_len=32),
                        optimizer=adamw(1e-3), loss_fn=next_token_loss,
                        device=cuda)
    state = ad.init(torch.Generator(device=cuda).manual_seed(0))
    for i in range(steps):
        state, _ = ad.step(state, data.batch(i))
    return ad, state, data


def _leaf_copies(state):
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        resilience,
    )

    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in resilience.flatten_state(state).items()}


def test_checkpoint_round_trip_of_cuda_tensors(cuda, tmp_path):
    """A train state on the card saves (through pinned host memory) and
    restores into CUDA tensors bitwise, verified against its manifest."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        CheckpointManager,
        resilience,
    )

    ad, state, data = _cuda_train_state(cuda, 2)
    want = _leaf_copies(state)
    mgr = CheckpointManager(str(tmp_path), device=cuda)
    mgr.save(2, state)
    mgr.wait()
    state, _ = ad.step(state, data.batch(5))
    restored = mgr.restore(state)
    got = resilience.flatten_state(restored)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].device.type == "cuda" and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert resilience.verify_directory(str(tmp_path))["steps"][0]["verified"]
    mgr.close()


def test_checkpoint_snapshot_survives_in_place_steps_on_card(cuda, tmp_path):
    """The steps right after ``save`` returns write the same CUDA tensors
    while the writer thread runs; the checkpoint holds the state as it
    was at ``save``."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        CheckpointManager,
    )

    ad, state, data = _cuda_train_state(cuda, 1)
    want = _leaf_copies(state)
    mgr = CheckpointManager(str(tmp_path), device=cuda)
    mgr.save(1, state)
    for i in range(1, 4):
        state, _ = ad.step(state, data.batch(i))
    mgr.wait()
    got = _leaf_copies(mgr.restore(state))
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    mgr.close()
