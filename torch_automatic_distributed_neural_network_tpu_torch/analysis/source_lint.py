"""Source lint: rule-based AST engine over the repo's Python (SL00x).

Small by design — not a general linter, just the failure classes this
codebase has actually hit or that jit makes uniquely painful:

- SL001 duplicate top-level defs (the bad-merge class: a second def
  silently shadows the first),
- SL004/SL005 jit-specific hazards (truthiness branches on traced
  arguments, host clock / numpy RNG baked in at trace time) — applied
  only to functions the module demonstrably jits (decorator or a
  ``jit(fn)`` reference), so host-side helpers named ``*_step`` are not
  false-positived,
- SL002/SL003/SL006 plain-Python footguns (bare except, mutable or
  call-evaluated defaults).

Suppression is explicit and justified: ``# tadnn: lint-ok(SL00x)
<reason>`` on the flagged line or the line above; a suppression without
a reason does not count.

The PyTorch package's copy of the JAX package's
``analysis/source_lint.py``, rule set and ids unchanged; by default it
lints this package.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable, Iterator

from . import ERROR, WARN, Finding

_SUPPRESS_RE = re.compile(
    r"#\s*tadnn:\s*lint-ok\(\s*([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"\s*\)\s*(\S.*)?$"
)

# Default-argument calls that are fine: immutable constructors and the
# dataclasses field() indirection.
_SAFE_DEFAULT_CALLS = frozenset({
    "field", "dataclasses.field", "frozenset", "tuple", "PartitionSpec",
    "P",
})

# func-attribute dotted names whose call inside a jitted function bakes
# a host-side value into the trace (SL005).
_HOST_CLOCK_RNG = (
    "time.time", "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.time_ns", "datetime.now",
    "datetime.datetime.now", "np.random.", "numpy.random.",
    "random.random", "random.randint", "random.uniform",
    "random.gauss", "random.choice", "random.shuffle",
)


def _dotted(node: ast.AST) -> str:
    """'jax.jit' for Attribute(Name('jax'),'jit'); '' if not a pure
    name/attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_jit_expr(node: ast.AST) -> bool:
    """Does this expression denote jit (bare or ``partial(jit, ...)``
    or ``jit(...)`` with options)?"""
    name = _dotted(node)
    if name in ("jit", "jax.jit", "filter_jit", "eqx.filter_jit"):
        return True
    if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        if fn in ("jit", "jax.jit", "filter_jit", "eqx.filter_jit"):
            return True
        if fn in ("partial", "functools.partial") and node.args:
            return _is_jit_expr(node.args[0])
    return False


def _static_names(call: ast.Call | None,
                  fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    """Parameter names jit treats as static (static_argnames/nums)."""
    if call is None:
        return set()
    names: set[str] = set()
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            for n in ast.walk(kw.value):
                if isinstance(n, ast.Constant) and isinstance(n.value, str):
                    names.add(n.value)
        elif kw.arg == "static_argnums":
            for n in ast.walk(kw.value):
                if isinstance(n, ast.Constant) and isinstance(n.value, int):
                    if 0 <= n.value < len(params):
                        names.add(params[n.value])
    return names


def _jitted_functions(
    tree: ast.Module,
) -> dict[str, tuple[ast.FunctionDef | ast.AsyncFunctionDef, set[str]]]:
    """name -> (def node, static param names) for every function this
    module jits, via decorator or a ``jit(name)`` call anywhere."""
    defs = {
        n.name: n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    out: dict[str, tuple] = {}
    for name, node in defs.items():
        for dec in node.decorator_list:
            if _is_jit_expr(dec):
                call = dec if isinstance(dec, ast.Call) else None
                out[name] = (node, _static_names(call, node))
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call) and _is_jit_expr(n.func) and n.args
                and isinstance(n.args[0], ast.Name)):
            target = n.args[0].id
            if target in defs and target not in out:
                out[target] = (defs[target], _static_names(n, defs[target]))
    return out


def _reads_traced(node: ast.AST, traced: set[str]) -> bool:
    """Would Python truthiness on this expression concretize a traced
    value?  Conservative: attribute/subscript/call results are treated
    as host values (``x.ndim``, ``x.shape[0]``, ``isinstance(x, ...)``
    are all legal under trace)."""
    if isinstance(node, ast.Name):
        return node.id in traced
    if isinstance(node, ast.BoolOp):
        return any(_reads_traced(v, traced) for v in node.values)
    if isinstance(node, ast.UnaryOp):
        return _reads_traced(node.operand, traced)
    if isinstance(node, ast.BinOp):
        return (_reads_traced(node.left, traced)
                or _reads_traced(node.right, traced))
    if isinstance(node, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False  # identity/membership checks are host-side
        return (_reads_traced(node.left, traced)
                or any(_reads_traced(c, traced) for c in node.comparators))
    return False


class _Suppressions:
    def __init__(self, source: str):
        self.by_line: dict[int, set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m and m.group(2):  # reason is mandatory
                codes = {c.strip() for c in m.group(1).split(",")}
                self.by_line[i] = codes

    def covers(self, lineno: int, code: str) -> bool:
        for ln in (lineno, lineno - 1):
            if code in self.by_line.get(ln, set()):
                return True
        return False


def lint_source(source: str, filename: str = "<string>") -> list[Finding]:
    """Run all SL rules over one module's source text."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Finding(
            "SL001", ERROR, "source", f"{filename}:{e.lineno or 0}",
            f"syntax error: {e.msg}",
        )]
    sup = _Suppressions(source)
    findings: list[Finding] = []

    def add(code: str, severity: str, lineno: int, msg: str) -> None:
        if not sup.covers(lineno, code):
            findings.append(Finding(
                code, severity, "source", f"{filename}:{lineno}", msg))

    # SL001 — duplicate top-level defs (module body only: conditional
    # redefinition under `if TYPE_CHECKING` / try-import is not flagged
    # because those live in nested bodies).
    seen: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name in seen:
                add("SL001", ERROR, node.lineno,
                    f"top-level {node.name!r} shadows the definition at "
                    f"line {seen[node.name]} (last-def-wins: the first "
                    "one is dead code)")
            else:
                seen[node.name] = node.lineno

    for node in ast.walk(tree):
        # SL002 — bare except
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            add("SL002", ERROR, node.lineno,
                "bare `except:` also swallows KeyboardInterrupt/"
                "SystemExit; catch Exception (or narrower)")
        # SL003/SL006 — default-argument hazards
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            args = node.args
            for default in list(args.defaults) + [
                    d for d in args.kw_defaults if d is not None]:
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    add("SL003", ERROR, default.lineno,
                        "mutable default argument — one object shared "
                        "across every call; default to None and build "
                        "inside")
                elif isinstance(default, ast.Call):
                    fn = _dotted(default.func)
                    if fn in ("list", "dict", "set", "bytearray"):
                        add("SL003", ERROR, default.lineno,
                            f"mutable default argument ({fn}()) — one "
                            "object shared across every call; default "
                            "to None and build inside")
                    elif fn not in _SAFE_DEFAULT_CALLS:
                        add("SL006", WARN, default.lineno,
                            f"default argument calls {fn or 'a function'}"
                            "() — evaluated once at def time, then "
                            "shared; default to None and construct in "
                            "the body")

    # SL004/SL005 — jit-specific rules, only inside provably-jitted fns
    for name, (fn_node, static) in _jitted_functions(tree).items():
        a = fn_node.args
        traced = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
        traced -= static
        traced.discard("self")
        inner_defs = {
            n for n in ast.walk(fn_node)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn_node
        }
        skip = {id(x) for d in inner_defs for x in ast.walk(d)}
        for node in ast.walk(fn_node):
            if id(node) in skip:
                continue
            if isinstance(node, (ast.If, ast.While)) and _reads_traced(
                    node.test, traced):
                add("SL004", ERROR, node.lineno,
                    f"Python truthiness branch on traced value in jitted "
                    f"{name!r} — raises TracerBoolConversionError at "
                    "trace time; use jnp.where/lax.cond or hoist to a "
                    "static argument")
            if isinstance(node, ast.Call):
                fn = _dotted(node.func)
                if fn and any(
                        fn == p or (p.endswith(".") and fn.startswith(p))
                        for p in _HOST_CLOCK_RNG):
                    add("SL005", ERROR, node.lineno,
                        f"{fn}() inside jitted {name!r} runs on the host "
                        "at trace time only — the value is baked into "
                        "the compiled step; use jax.random / pass times "
                        "in as arguments")
    return findings


def lint_file(path: pathlib.Path | str) -> list[Finding]:
    path = pathlib.Path(path)
    try:
        source = path.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("SL001", ERROR, "source", f"{path}:0",
                        f"unreadable: {e}")]
    return lint_source(source, filename=str(path))


def iter_py_files(paths: Iterable[pathlib.Path | str]) -> Iterator[pathlib.Path]:
    seen: set[pathlib.Path] = set()
    for p in paths:
        p = pathlib.Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            if f.suffix == ".py" and f not in seen and f.exists():
                seen.add(f)
                yield f


def default_paths(repo_root: pathlib.Path | str | None = None) -> list[pathlib.Path]:
    """What the SL rules lint by default: this package (under
    ``repo_root``: the directory holding it), its examples included."""
    package = pathlib.Path(__file__).resolve().parents[1]
    repo_root = (package.parent if repo_root is None
                 else pathlib.Path(repo_root))
    return [repo_root / package.name]


def lint_paths(
    paths: Iterable[pathlib.Path | str] | None = None,
    repo_root: pathlib.Path | str | None = None,
) -> list[Finding]:
    """Lint a path set (files and/or directories); defaults to
    :func:`default_paths`."""
    if paths is None:
        paths = default_paths(repo_root)
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings
