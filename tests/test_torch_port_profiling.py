"""The port's ``utils/profiling.py`` and ``utils/debug.py`` (and
``obs/comms.crosscheck``) against the JAX package's, on the CPU.

- ``compiled_flops`` of a matmul equals JAX's cost analysis exactly
  (2·M·K·N); ``compiled_memory``'s argument and output bytes equal
  JAX's; a failing call returns JAX's error record and journals
  ``cost_analysis.error``; ``memory_stats`` is None on the CPU, as JAX
  returns for a device that keeps none.
- ``profiling.trace`` writes a Chrome trace holding an ``annotate``
  region.
- ``tree_hash`` of one seeded tree (float32 and float64 leaves in
  nested dicts, lists and tuples, a ``None``) is within 1e-6 relative
  of JAX's; ``assert_tree_finite`` names the same paths in the same
  order (JAX's ``keystr`` spelling); a ``TrainState`` is walked by
  field.
- ``nan_debugging`` raises where a backward function returns NaN and
  restores the anomaly mode after the block.
- ``comms.crosscheck`` joins an estimate with a cost record as JAX's.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.obs import (
    comms as jcomms,
)
from torch_automatic_distributed_neural_network_tpu.utils import (
    debug as jdebug,
)
from torch_automatic_distributed_neural_network_tpu.utils import (
    profiling as jprofiling,
)
from torch_automatic_distributed_neural_network_tpu_torch.core import (
    TrainState,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    comms,
    journal,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import (
    debug,
    profiling,
)

torch.set_num_threads(1)


def test_compiled_cost_equals_jax():
    rs = np.random.RandomState(0)
    a, b = rs.randn(64, 128).astype(np.float32), rs.randn(
        128, 32).astype(np.float32)
    got = profiling.compiled_flops(lambda x, y: x @ y, torch.from_numpy(a),
                                   torch.from_numpy(b))
    want = jprofiling.compiled_flops(jax.jit(lambda x, y: x @ y),
                                     jnp.asarray(a), jnp.asarray(b))
    assert got == want == 2 * 64 * 128 * 32
    x = rs.randn(256, 256).astype(np.float32)
    mem = profiling.compiled_memory(lambda t: (t @ t.T).sum(),
                                    torch.from_numpy(x))
    jmem = jprofiling.compiled_memory(jax.jit(lambda t: (t @ t.T).sum()),
                                      jnp.asarray(x))
    assert mem == {k: jmem[k] for k in ("argument_size", "output_size")}
    assert profiling.memory_stats("cpu") is None
    assert profiling.memory_stats(torch.device("cpu")) is None

    def boom(t):
        raise ValueError("shapes disagree")

    with journal.as_default(journal.Journal()) as j:
        cost = profiling.compiled_cost(boom, torch.ones(2))
    assert cost == {"flops": None, "memory": None,
                    "error": "ValueError: shapes disagree"}
    assert j.named("cost_analysis.error")[0]["error"] == cost["error"]
    assert profiling.compiled_flops(boom, torch.ones(2)) is None
    assert profiling.compiled_flops(torch.relu, torch.ones(3)) is None


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.annotate("tadnn_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = tmp_path.iterdir()
    with gzip.open(path, "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"tadnn_region", "aten::mm"} <= names


def _tree(rs, nan=False):
    bad = np.array([1.0, np.nan if nan else 2.0], np.float32)
    return {"b": [rs.randn(3, 4).astype(np.float32), bad],
            "a": {"y": rs.randn(7), "x": (rs.randn(2).astype(np.float32),
                                          None)},
            "c": np.array([np.inf if nan else 0.5], np.float32),
            "ints": np.arange(5, dtype=np.int32)}


def test_tree_hash_and_finite_paths_equal_jax():
    tree = _tree(np.random.RandomState(1))
    jtree = jax.tree.map(jnp.asarray, tree)
    got = debug.tree_hash(jax.tree.map(torch.as_tensor, tree))
    assert got == pytest.approx(jdebug.tree_hash(jtree), rel=1e-6)
    assert debug.tree_hash(tree) == pytest.approx(got, rel=1e-6)
    debug.assert_tree_finite(tree)  # all finite: no raise
    bad = _tree(np.random.RandomState(1), nan=True)
    with pytest.raises(FloatingPointError) as port_err:
        debug.assert_tree_finite(bad, "state")
    with pytest.raises(FloatingPointError) as jax_err:
        jdebug.assert_tree_finite(bad, "state")
    assert str(port_err.value) == str(jax_err.value)
    assert "['b'][1]" in str(port_err.value)
    state = TrainState(step=3, params={"w": torch.tensor([1.0, np.nan])},
                       opt_state=None, seed=0)
    with pytest.raises(FloatingPointError, match=r"\.params\['w'\]"):
        debug.assert_tree_finite(state)


def test_nan_debugging_raises_on_a_nan_gradient():
    before = torch.is_anomaly_enabled()
    with debug.nan_debugging():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        y = torch.sqrt(x)  # NaN in the forward: no raise here
        with pytest.raises(RuntimeError, match="returned nan"):
            y.sum().backward()
    assert torch.is_anomaly_enabled() == before


def test_comms_crosscheck_equals_jax():
    est = {"total_wire_bytes": 3000}
    for cost in (None, {"flops": 1.0, "memory": None},
                 {"flops": 1.0, "bytes_accessed": 12000.0},
                 {"flops": None, "memory": None, "error": "x"}):
        with journal.as_default(journal.Journal()) as j:
            got = comms.crosscheck(est, cost)
        assert got == jcomms.crosscheck(est, cost)
        assert j.named("comms.crosscheck")[0]["expected_wire_bytes"] == 3000
