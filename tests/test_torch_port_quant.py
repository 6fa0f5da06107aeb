"""int8 KV storage and the paged pool's writes and reads: the PyTorch
port against the JAX package on the same numpy inputs.

Tolerances: int8 payloads agree exactly, or at most 1 LSB apart in at
most 0.1% of cells (the count is reported); fp32 scales to rtol 1e-6;
dense pool contents exactly (both sides round fp32 -> bf16 to nearest
even, and fp32 inputs are handed over bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.inference import quant as jq
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    kv_pool as jpool,
)
from torch_automatic_distributed_neural_network_tpu.models import gpt2_config as jgpt2
from torch_automatic_distributed_neural_network_tpu_torch.inference import quant as tq
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    kv_pool as tpool,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import gpt2_config


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def assert_int8_close(got, want, what):
    """Exact, or 1-LSB apart in <= 0.1% of cells."""
    got, want = _np(got).astype(np.int32), _np(want).astype(np.int32)
    diff = np.abs(got - want)
    n_off = int((diff > 0).sum())
    assert diff.max(initial=0) <= 1, f"{what}: {diff.max()} LSB apart"
    assert n_off <= 0.001 * diff.size, (
        f"{what}: {n_off}/{diff.size} cells 1 LSB apart")


def assert_leaf_equal(got, want, what):
    if isinstance(want, dict):
        assert_int8_close(got["q"], want["q"], what + ".q")
        np.testing.assert_allclose(_np(got["scale"]), _np(want["scale"]),
                                   rtol=1e-6, err_msg=what + ".scale")
    else:
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


@pytest.mark.parametrize("shape", [(3, 7, 4, 32), (2, 5, 2, 64)])
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_quantize_kv_matches_jax(shape, scale):
    x = (np.random.RandomState(0).randn(*shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 scale floor
    got = tq.quantize_kv(torch.from_numpy(x))
    want = jq.quantize_kv(jnp.asarray(x))
    assert got["q"].dtype == torch.int8
    assert tuple(got["scale"].shape) == shape[:-1] + (1,)
    assert_leaf_equal(got, want, "quantize_kv")
    np.testing.assert_allclose(
        _np(tq.dequantize_kv(got, torch.float32)),
        _np(jq.dequantize_kv(want, jnp.float32)), rtol=1e-6, atol=0)


def test_quantize_rounds_half_to_even():
    # 127 * (x / max) lands on .5 for these rows
    x = np.array([[0.5, 1.5, 2.5, 127.0], [-0.5, -2.5, 3.5, -127.0]],
                 np.float32)
    got = tq.quantize_kv(torch.from_numpy(x))["q"].numpy()
    want = np.asarray(jq.quantize_kv(jnp.asarray(x))["q"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :3], [0, 2, 2])


def _pools(rs, NB=10, bs=8, H=2, hd=16, quantized=False, bf16=False):
    x = rs.randn(NB, bs, H, hd).astype(np.float32)
    if quantized:
        return tq.quantize_kv(torch.from_numpy(x)), jq.quantize_kv(
            jnp.asarray(x))
    if bf16:
        return (torch.from_numpy(x).to(torch.bfloat16),
                jnp.asarray(x, jnp.bfloat16))
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("out_dtype", ["fp32", "bf16"])
def test_gather_blocks_matches_jax(pool, out_dtype):
    rs = np.random.RandomState(1)
    tp, jp = _pools(rs, quantized=pool == "int8", bf16=pool == "bf16")
    table = np.array([[1, 3, 0], [2, 0, 0], [9, 8, 7]], np.int32)
    tdt = torch.float32 if out_dtype == "fp32" else torch.bfloat16
    jdt = jnp.float32 if out_dtype == "fp32" else jnp.bfloat16
    got = tpool.gather_blocks(tp, torch.from_numpy(table), tdt)
    want = jpool.gather_blocks(jp, jnp.asarray(table), jdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_write_token_matches_jax(pool):
    """Active slots write at (table[pos // bs], pos % bs); the inactive
    slot's all-null table sends its write to the null block (compared
    apart from block 0, where colliding writes have no defined order)."""
    rs = np.random.RandomState(2)
    tp, jp = _pools(rs, quantized=pool == "int8", bf16=pool == "bf16")
    table = np.array([[1, 3, 0], [2, 5, 6], [0, 0, 0]], np.int32)
    pos = np.array([9, 17, 0], np.int32)
    new = rs.randn(3, 2, 16).astype(np.float32)
    tpool.write_token(tp, torch.from_numpy(table), torch.from_numpy(pos),
                      torch.from_numpy(new))
    jp = jpool.write_token(jp, jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(new))
    if pool == "int8":
        assert_leaf_equal({"q": tp["q"][1:], "scale": tp["scale"][1:]},
                          {"q": jp["q"][1:], "scale": jp["scale"][1:]},
                          "write_token")
    else:
        assert_leaf_equal(tp[1:], jp[1:], "write_token")


@pytest.mark.parametrize("mode", ["fp", "int8_dense_rows", "int8_qrows"])
def test_write_prefill_matches_jax(mode):
    """Dense rows into an fp pool, dense rows quantized on write, and
    already-quantized rows committed verbatim; P=13 tokens pad to two
    blocks of 8 (zeros, scales 1)."""
    cfg_j = jgpt2("test", vocab_size=64)
    cfg_t = gpt2_config("test", vocab_size=64)
    quantize = mode != "fp"
    tp = tpool.PagedKVPool(cfg_t, num_blocks=6, block_size=8,
                           quantize=quantize, device="cpu")
    jp = jpool.PagedKVPool(cfg_j, num_blocks=6, block_size=8,
                           quantize=quantize)
    rs = np.random.RandomState(3)
    L, P, H, hd = cfg_t.n_layers, 13, cfg_t.kv_heads, cfg_t.head_dim
    rows = [rs.randn(L, P, H, hd).astype(np.float32) for _ in range(2)]
    t_rows = [torch.from_numpy(r).to(torch.bfloat16) for r in rows]
    j_rows = [jnp.asarray(r, jnp.bfloat16) for r in rows]
    if mode == "int8_qrows":
        t_rows = [tq.quantize_kv(r) for r in t_rows]
        j_rows = [jq.quantize_kv(r) for r in j_rows]
    blocks = [4, 2]
    tp.write_prefill(blocks, *t_rows)
    jp.write_prefill(blocks, *j_rows)
    for side in ("k", "v"):
        assert_leaf_equal(tp.kv[side], jp.kv[side], f"pool.{side}")
        # the views the decode step writes through share the storage
        leaf = tp.k[1] if side == "k" else tp.v[1]
        payload = leaf["q"] if quantize else leaf
        whole = tp.kv[side]["q"] if quantize else tp.kv[side]
        assert payload.data_ptr() == whole[1].data_ptr()
    assert tp.total_bytes == jpool.pool_kv_bytes(
        cfg_j, 6, 8, jnp.bfloat16, quantize)


def test_pool_fork_read_and_allocator():
    cfg = gpt2_config("test", vocab_size=64)
    pool = tpool.PagedKVPool(cfg, num_blocks=5, block_size=8,
                             quantize=True, device="cpu")
    rs = np.random.RandomState(4)
    rows = torch.from_numpy(rs.randn(2, 8, 4, 32).astype(np.float32))
    got = pool.alloc(2)
    assert got == [1, 2] and pool.allocator.n_free == 2
    pool.write_prefill([got[0]], rows, rows)
    dst = pool.fork_block(got[0])
    k1, _ = pool.read_blocks([got[0]], 2, dtype=torch.float32)
    k2, _ = pool.read_blocks([dst], 2, dtype=torch.float32)
    np.testing.assert_array_equal(k1[:, :8].numpy(), k2[:, :8].numpy())
    pool.free([got[0], got[1], dst])
    with pytest.raises(ValueError, match="double-free"):
        pool.free([dst])
    assert pool.table_row([3], 3) == [3, 0, 0]
    assert pool.ship_prefill([1], rows, rows) == pool.bytes_per_block
    assert pool.n_transfers == 1
