"""Debug guards: NaN detection, finite-state assertions and a cheap
content hash (the JAX package's ``utils/debug.py``).

There are no hand-written comm threads to race in a training step — the
guards that replace TSAN/NCCL-debug are numeric: NaN detection,
finite-param assertions, and cross-process divergence checks (the latter
lives in ``training.trainer.Trainer._guard_divergence``).

A tree here is what a state is made of: tensors (or numpy arrays) in
mappings, lists, tuples and dataclasses such as ``TrainState``.  Paths
are spelled as ``jax.tree_util.keystr`` spells them (``['a'][0].params``),
keys in sorted order, so both packages name the same offending leaf.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator


@contextlib.contextmanager
def nan_debugging():
    """Enable ``torch.autograd`` anomaly detection inside the block: a
    backward function that returns NaN raises ``RuntimeError`` naming
    it, with the forward's traceback.  It slows every op — use for
    debugging only, not production steps.  Unlike JAX's
    ``jax_debug_nans`` it checks the backward only: a NaN made in the
    forward raises when its gradient is computed, not where it is made.
    """
    import torch

    prev = torch.is_anomaly_enabled()
    prev_check = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_check)


def tree_leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(keystr path, leaf) in the JAX flatten order; None is an empty
    subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")
    elif hasattr(tree, "_fields"):  # a namedtuple
        for f in tree._fields:
            yield from tree_leaves(getattr(tree, f), f"{path}.{f}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def _tensor(leaf: Any):
    import torch

    if isinstance(leaf, torch.Tensor):
        # a DTensor is checked on this process's shard
        return leaf.to_local() if hasattr(leaf, "to_local") else leaf
    return torch.as_tensor(leaf)


def assert_tree_finite(tree, name: str = "tree") -> None:
    """Host-side check that every floating leaf is finite; raises with
    the offending paths listed."""
    import torch

    bad = []
    for path, leaf in tree_leaves(tree):
        t = _tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad.append(path)
    if bad:
        raise FloatingPointError(f"Non-finite values in {name}: {bad}")


def tree_hash(tree) -> float:
    """Cheap content hash (abs-sum) of a tree, device-computed in fp32."""
    import torch

    total = None
    for _, leaf in tree_leaves(tree):
        s = _tensor(leaf).to(torch.float32).abs().sum()
        total = s if total is None else total + s.to(total.device)
    return float(total) if total is not None else 0.0
