"""Dtype-flow lint: dtype propagation over the traced step (DT00x).

The same trace-only walk as :mod:`graph_lint` (``make_fx`` on fake
tensors, nothing runs), but following *dtypes* instead of bytes.  Every
node of the fx graph carries its fake value (``node.meta["val"]``) with
a concrete dtype, so numerics hazards that only surface as slow
divergence on a real run — a loss accumulated in bf16, an f16 sum that
saturates at 65504, a Python scalar silently setting the result dtype
of a collective — are visible statically:

- **DT001** unintended f32→bf16/f16 downcast on the loss/optimizer
  path: a scalar downcast (the loss itself, an optimizer scale), or a
  reduction output downcast that is not the configured mixed-precision
  compute dtype.  Casting *inputs* down (the mixed-precision pattern)
  is fine and not flagged; casting the *accumulated result* down
  throws away exactly the bits the accumulation was widened for.
- **DT002** f16 overflow-prone accumulation: sum / mm / bmm / addmm /
  cumsum / convolution accumulating **in** float16 — partial sums
  overflow at 65504 even when every element is small.  bf16 shares
  f32's exponent range and is exempt.
- **DT003** Python-scalar operand entering a collective.  Torch has no
  weak-type bit; the closest thing is a tensor the step made from a
  Python number (``torch.tensor(2.0)``: a lifted constant,
  ``scalar_tensor``, or a 0-dim ``full``), whose dtype is torch's
  default for that literal rather than one the code chose.
- **DT004** mixed float dtypes across param leaves: grads and optimizer
  moments inherit per-leaf dtypes, so updates promote inconsistently
  (tree-level check, no trace needed).
"""

from __future__ import annotations

from typing import Any

import torch

from . import WARN, Finding
from .graph_lint import (
    COLLECTIVE_KINDS,
    _COLLECTIVE_NS,
    _graph_of,
    op_name,
    op_namespace,
)

_LOW_FLOATS = frozenset({"bfloat16", "float16"})

# Ops whose output is an accumulated value: downcasting it discards the
# accumulation's extra precision (DT001 reduced-path).
_REDUCTIONS = frozenset({
    "sum", "amax", "amin", "max", "min", "prod", "cumsum", "logcumsumexp",
    "mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "convolution",
})

# Sum-accumulating ops where f16 partials can exceed 65504 (DT002).
# Max/min never grow, so they are not listed.
_SUM_OPS = frozenset({
    "sum", "cumsum", "mm", "bmm", "addmm", "baddbmm", "matmul", "dot",
    "convolution",
})

# Ops that convert an element type: ``x.to(dtype)`` / ``x.float()``
_CONVERTS = frozenset({"_to_copy", "to", "convert_element_type"})

# Ops that pass a value through (the producer a cast looks past)
_PASS = frozenset({"view", "_unsafe_view", "reshape", "clone", "detach",
                   "alias", "expand", "squeeze", "unsqueeze", "t",
                   "permute", "transpose", "contiguous"})

# Ops that make a tensor from a Python number
_FROM_SCALAR = frozenset({"lift_fresh_copy", "scalar_tensor"})


def _dtype_name(val: Any) -> str:
    dtype = getattr(val, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def _val(x: Any) -> Any:
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _producer(node: Any) -> Any:
    """The node that computed ``node``'s value, looking through views
    and copies."""
    while (isinstance(node, torch.fx.Node) and node.op == "call_function"
           and op_name(node) in _PASS and node.args
           and isinstance(node.args[0], torch.fx.Node)):
        node = node.args[0]
    return node


def _check_downcast(node: Any, compute_name: str | None,
                    findings: list, seen: set) -> None:
    out = _val(node)
    src = node.args[0] if node.args else None
    src_val = _val(src)
    if not isinstance(out, torch.Tensor) or not isinstance(
            src_val, torch.Tensor):
        return
    if _dtype_name(src_val) != "float32":
        return
    new_name = _dtype_name(out)
    if new_name not in _LOW_FLOATS:
        return
    prod = _producer(src)
    prod_name = (op_name(prod) if isinstance(prod, torch.fx.Node)
                 and prod.op == "call_function" else None)
    if tuple(out.shape) == ():
        msg = (
            f"float32 scalar downcast to {new_name} — on the "
            "loss/optimizer path this throws away the accumulated "
            "precision (loss curves drift long before anything NaNs); "
            "keep scalars in f32 and cast activations instead"
        )
        key = ("DT001", "scalar", new_name)
    elif prod_name in _REDUCTIONS and new_name != compute_name:
        msg = (
            f"float32 output of {prod_name} downcast to {new_name} "
            "(not the configured compute dtype) — the reduction was "
            "accumulated wide and immediately narrowed; move the cast "
            "before the reduction or keep the result wide"
        )
        key = ("DT001", prod_name, new_name)
    else:
        return
    if key in seen:
        return
    seen.add(key)
    findings.append(Finding(
        "DT001", WARN, "dtype", f"<convert_element_type→{new_name}>", msg))


def _check_f16_sum(node: Any, findings: list, seen: set) -> None:
    name = op_name(node)
    in_names = {_dtype_name(_val(a)) for a in node.args
                if isinstance(_val(a), torch.Tensor)}
    out = _val(node)
    if not isinstance(out, torch.Tensor):
        return
    if "float16" in in_names and _dtype_name(out) == "float16":
        key = ("DT002", name)
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(
            "DT002", WARN, "dtype", f"<{name}>",
            f"{name} accumulates in float16 — partial sums overflow at "
            "65504 even when every element is small; accumulate in "
            "f32 (preferred_element_type=jnp.float32) or use bfloat16 "
            "(f32 exponent range)",
        ))


def _from_python_scalar(node: Any) -> bool:
    """Whether ``node``'s value is a tensor made from a Python number."""
    prod = _producer(node)
    if not isinstance(prod, torch.fx.Node) or prod.op != "call_function":
        return False
    name = op_name(prod)
    if name in _FROM_SCALAR:
        return True
    return name == "full" and bool(prod.args) and list(prod.args[0]) == []


def _check_weak_collective(node: Any, findings: list, seen: set) -> None:
    name = op_name(node)
    args = list(node.args)
    flat = []
    for a in args:
        flat += list(a) if isinstance(a, (list, tuple)) else [a]
    for a in flat:
        if isinstance(a, torch.fx.Node) and _from_python_scalar(a):
            key = ("DT003", name)
            if key in seen:
                return
            seen.add(key)
            findings.append(Finding(
                "DT003", WARN, "dtype", f"<{name}>",
                f"weak-typed operand ({_dtype_name(_val(a))}) enters "
                f"{name} — the result dtype follows Python-literal "
                "promotion rules at a collective boundary (differs "
                "across devices/jax versions); cast to a concrete "
                "dtype before the collective",
            ))
            return


def _walk(graph: Any, compute_name: str | None, findings: list,
          seen: set) -> None:
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = op_name(node)
        if name in _CONVERTS:
            _check_downcast(node, compute_name, findings, seen)
        elif name in _SUM_OPS:
            _check_f16_sum(node, findings, seen)
        if (op_namespace(node) in _COLLECTIVE_NS
                and name in COLLECTIVE_KINDS):
            _check_weak_collective(node, findings, seen)


def _flat(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out: list[tuple[str, Any]] = []
        for k, v in tree.items():
            out += _flat(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def lint_param_dtypes(abstract_params: Any) -> list[Finding]:
    """DT004: the param tree should agree on one float dtype."""
    counts: dict[str, int] = {}
    example: dict[str, str] = {}
    for path, leaf in _flat(abstract_params):
        dt = getattr(leaf, "dtype", None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            continue
        name = _dtype_name(leaf)
        counts[name] = counts.get(name, 0) + 1
        example.setdefault(name, path)
    if len(counts) <= 1:
        return []
    parts = ", ".join(f"{n}×{c}" for n, c in sorted(counts.items()))
    minority = min(counts, key=lambda n: counts[n])
    return [Finding(
        "DT004", WARN, "dtype", example[minority],
        f"param tree mixes float dtypes ({parts}; e.g. "
        f"{example[minority]} is {minority}) — grads and optimizer "
        "updates promote per leaf, so effective precision differs "
        "across the model; cast the tree or use a precision preset",
    )]


def lint_dtypes(
    closed: Any,
    *,
    abstract_params: Any = None,
    compute_dtype: Any = None,
) -> list[Finding]:
    """All dtype-layer rules over one traced step.

    ``compute_dtype`` is the intended mixed-precision compute dtype
    (``Precision.compute_dtype``): reduction outputs cast to it are the
    configured policy, not a finding.
    """
    findings: list[Finding] = []
    seen: set = set()
    compute_name = None
    if isinstance(compute_dtype, torch.dtype):
        compute_name = str(compute_dtype).replace("torch.", "")
    elif compute_dtype is not None:
        compute_name = str(compute_dtype)
    graph = _graph_of(closed)
    if graph is not None:
        _walk(graph, compute_name, findings, seen)
    if abstract_params is not None:
        findings += lint_param_dtypes(abstract_params)
    return findings


__all__ = ["lint_dtypes", "lint_param_dtypes"]
