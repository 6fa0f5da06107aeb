"""The collectives benchmarks of the PyTorch port against the JAX
package's ``parallel/collectives.py`` (``bench_collective``,
``bench_sweep``, ``bench_overlap``, ``_bus_factor``) and ``tadnn bench``.

On 2 and 4 gloo ranks (one spawn of ``tests/torch_port_dist_worker.py``
a world size, ``tests/torch_port_spawn.py``) each benchmarked collective
runs on every rank's row of one numpy-seeded input, and its result is
held to JAX's collective inside ``shard_map`` on the 8-device CPU sim's
first n devices: the gathers, the all-to-all and the ring permute
bitwise, the sums within 1e-6 of the summed magnitudes ``sum |x_r|``
elementwise (fp32; the ranks' values may be added in another order).  The per-rank sizes and device counts the benchmark reports
equal those of JAX's own ``bench_collective`` on as many devices, and
``bench_overlap``'s fields keep JAX's bounds
(``tests/test_collectives.py:3``).  Times are not compared: the port
times launches (CUDA events on the card, the host clock on gloo) where
JAX fences a chain of collectives with one readback.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from torch_automatic_distributed_neural_network_tpu.parallel import (
    collectives as jcoll,
)
from torch_automatic_distributed_neural_network_tpu.utils.jax_compat import (
    shard_map,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.parallel import (
    collectives as C,
)

from torch_port_spawn import spawn

OPS = ("allreduce", "allgather", "reduce_scatter", "all_to_all", "ppermute")
# an odd size: the per-rank count is rounded down to a multiple of n
SIZES = (1000, 2**12 + 12)
SUM_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _per_rank(size_bytes, n, itemsize=4):
    """JAX's rule: ``max(size // itemsize, n)`` rounded down to n."""
    per = max(size_bytes // itemsize, n)
    return per - per % n


def _inputs(world):
    rs = np.random.RandomState(world)
    per = _per_rank(SIZES[1], world)
    return {op: rs.randn(world, per).astype(np.float32) for op in OPS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            job = {"bench": {"inputs": _inputs(world), "sizes": SIZES}}
            cache[world] = spawn(world, job, tmp_path_factory.mktemp(
                f"bench{world}"))["bench"]
        return cache[world]

    return get


def _jax_results(world, inputs):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    ops = {
        "allreduce": lambda x: jax.lax.psum(x, "data"),
        "allgather": lambda x: jax.lax.all_gather(x, "data", tiled=True),
        "reduce_scatter": lambda x: jax.lax.psum_scatter(x, "data",
                                                         tiled=True),
        "all_to_all": lambda x: jax.lax.all_to_all(
            x, "data", split_axis=0, concat_axis=0, tiled=True),
        "ppermute": lambda x: jcoll.ppermute_ring(x, "data"),
    }
    out = {}
    for op, fn in ops.items():
        run = shard_map(lambda x: fn(x)[None], mesh=mesh,
                        in_specs=JP("data"), out_specs=JP("data"))
        out[op] = np.asarray(run(jnp.asarray(inputs[op].reshape(-1))))
    return out


@pytest.mark.parametrize("n", range(1, 9))
def test_bus_factor_equals_jax(n):
    for op in (*OPS, "broadcast"):
        assert C._bus_factor(op, n) == jcoll._bus_factor(op, n), (op, n)


@pytest.mark.parametrize("world", (2, 4))
def test_bench_ops_match_jax(worlds, world):
    ranks = worlds(world)
    inputs = _inputs(world)
    want = _jax_results(world, inputs)
    for rank, got in enumerate(ranks):
        for op in OPS:
            g = got["results"][op].numpy()
            w = want[op][rank]
            assert g.shape == w.shape, (op, rank)
            if op in ("allreduce", "reduce_scatter"):
                # relative to the summed magnitudes: the ranks' values
                # may be added in another order, and near a cancellation
                # one rounding is large against the sum itself
                mag = np.abs(inputs[op]).sum(0)
                if op == "reduce_scatter":
                    mag = mag.reshape(world, -1)[rank]
                assert (np.abs(g - w) <= SUM_RTOL * mag).all(), (
                    op, rank, float(np.abs(g - w).max()))
            else:
                np.testing.assert_array_equal(g, w,
                                              err_msg=f"{op} rank {rank}")


@pytest.mark.parametrize("world", (2, 4))
def test_bench_sizes_and_devices_follow_jax(worlds, world):
    ranks = worlds(world)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    rows = ranks[0]["bench"]
    expected = [(op, s) for op in OPS for s in SIZES]
    assert len(rows) == len(expected)
    for (op, size), r in zip(expected, rows):
        j = jcoll.bench_collective(op, size, mesh=mesh, iters=1, warmup=0)
        assert (r["op"], r["n_devices"], r["size_bytes"]) == (
            op, j.n_devices, j.size_bytes), r
        assert r["size_bytes"] == _per_rank(size, world) * 4
        assert r["time_s"] > 0 and r["alg_bw_gbps"] > 0
        assert r["bus_bw_gbps"] == pytest.approx(
            r["alg_bw_gbps"] * jcoll._bus_factor(op, world), rel=1e-12)


@pytest.mark.parametrize("world", (2, 4))
def test_bench_overlap_fields_are_consistent(worlds, world):
    """JAX's bounds (``tests/test_collectives.py:3``): no overlap claim on
    the CPU, only that the measurement works."""
    for got in worlds(world):
        r = got["overlap"]
        assert r["n_devices"] == world and r["layers"] == 3
        assert r["bucket_bytes"] == 2**16
        assert r["t_compute_s"] > 0 and r["t_comm_s"] > 0
        assert r["t_both_s"] > 0
        assert -1.0 <= r["overlap_frac"] <= 1.0


def test_tadnn_bench_prints_json_lines(capsys):
    """``tadnn bench --device cpu`` alone: a world of one gloo rank, one
    JSON line per (op, size) with JAX's fields; nothing crosses devices,
    so the bus bandwidth is 0 by the NCCL-tests factor (the ring permute's
    factor is 1)."""
    assert cli(["bench", "--device", "cpu", "--ops",
                "allreduce,allgather,ppermute", "--sizes", "4096,65536"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["op"], r["size_bytes"]) for r in rows] == [
        (op, s) for op in ("allreduce", "allgather", "ppermute")
        for s in (4096, 65536)]
    for r in rows:
        assert set(r) == {"op", "n_devices", "size_bytes", "time_s",
                          "alg_bw_gbps", "bus_bw_gbps"}
        assert r["n_devices"] == 1 and r["time_s"] > 0
        assert r["bus_bw_gbps"] == (r["alg_bw_gbps"]
                                    if r["op"] == "ppermute" else 0.0)
    assert not torch.distributed.is_initialized()
