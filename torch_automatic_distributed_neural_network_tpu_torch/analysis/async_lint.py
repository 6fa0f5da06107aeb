"""Async-safety lint: AST rules over the gateway's asyncio layer (AS00x).

The gateway core is single-threaded and clock-injected by design: the
event loop owns all mutable state, `VirtualClock`s drive every timeout
in tests/chaos, and the HTTP layer is pure asyncio.  Each rule guards
one way that design gets silently broken:

- AS001 blocking call (``time.sleep``, ``subprocess``, ``requests``,
  ``socket`` ...) inside an ``async def`` — stalls the whole event loop,
- AS002 statement-level call of a locally-defined ``async def`` without
  ``await``/``create_task`` — the coroutine is created and dropped,
- AS003 wall-clock read (``time.monotonic()``, ``asyncio.sleep`` ...)
  inside a class whose ``__init__`` takes an injectable ``clock`` — the
  class signed up for virtual time; reading the real clock in its
  methods breaks deterministic replay and chaos schedules (the
  ``clock=time.monotonic`` *default argument* is the sanctioned idiom
  and is not flagged),
- AS004 handing a method that mutates attribute state to a thread /
  executor — the loop no longer owns that state; marshal through
  ``call_soon_threadsafe`` or a queue (WARN: heuristic).

Suppression matches source_lint: ``# tadnn: lint-ok(AS00x) <reason>``
on the flagged line or the line above; the reason is mandatory.

The PyTorch package's copy of the JAX package's
``analysis/async_lint.py``, rule set and ids unchanged; by default it
lints this package's gateway.
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

# Dotted names (exact, or prefix when ending in '.') whose call inside
# an async def blocks the event loop (AS001).
_BLOCKING = (
    "time.sleep", "os.system", "os.popen", "os.wait", "os.waitpid",
    "subprocess.", "requests.", "urllib.request.", "http.client.",
    "socket.create_connection", "socket.getaddrinfo",
    "socket.gethostbyname",
)

# Wall-clock reads that bypass an injected clock (AS003).  asyncio.sleep
# belongs here, not in AS001: it does not block the loop, but inside a
# clock-injected class it ties behaviour to real time all the same.
_WALL_CLOCK = (
    "time.time", "time.monotonic", "time.perf_counter",
    "time.perf_counter_ns", "time.time_ns", "datetime.now",
    "datetime.datetime.now", "asyncio.sleep",
)

# run_in_executor / submit receivers that look like executors (AS004
# only fires on these, so ``gateway.submit(...)`` is never confused
# with ``pool.submit(...)``).
_EXECUTORISH = ("executor", "pool", "threads", "workers")


def _dotted(node: ast.AST) -> str:
    """'time.sleep' for Attribute(Name('time'),'sleep'); '' if not a
    pure name/attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _matches(name: str, patterns: tuple[str, ...]) -> bool:
    return bool(name) and any(
        name == p or (p.endswith(".") and name.startswith(p))
        for p in patterns
    )


def _mutates_attributes(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    """Does this function store through an attribute (``self.x = ...``,
    ``self.xs[k] = ...``, ``self.n += 1``)?  Mutating method calls
    (``self.xs.append``) are deliberately out of scope — too noisy."""
    for node in ast.walk(fn):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute):
                return True
            if isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Attribute):
                return True
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


def _async_defs(tree: ast.Module) -> tuple[set[str], dict[str, set[str]]]:
    """(module-level async def names, class name -> async method names).
    Only locally-defined coroutines are AS002 candidates — calls into
    other modules are not resolvable without imports."""
    module: set[str] = {
        n.name for n in tree.body if isinstance(n, ast.AsyncFunctionDef)
    }
    per_class: dict[str, set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            per_class[node.name] = {
                m.name for m in node.body
                if isinstance(m, ast.AsyncFunctionDef)
            }
    return module, per_class


def _clock_injected_classes(tree: ast.Module) -> list[ast.ClassDef]:
    """Classes whose ``__init__`` takes a ``clock`` parameter."""
    out: list[ast.ClassDef] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for m in node.body:
            if (isinstance(m, ast.FunctionDef) and m.name == "__init__"):
                params = (m.args.posonlyargs + m.args.args
                          + m.args.kwonlyargs)
                if any(p.arg == "clock" for p in params):
                    out.append(node)
                break
    return out


def _default_arg_nodes(fn: ast.AST) -> set[int]:
    """ids of every node inside default-argument expressions of defs
    under ``fn`` — defaults evaluate at def time, not per call, so
    ``clock=time.monotonic`` (or even ``t0=time.monotonic()``) is the
    injection point itself, not a bypass."""
    skip: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for d in list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]:
                skip.update(id(x) for x in ast.walk(d))
    return skip


def lint_source(source: str, filename: str = "<string>") -> list[Finding]:
    """Run all AS rules over one module's source text."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Finding(
            "AS001", ERROR, "async", f"{filename}:{e.lineno or 0}",
            f"syntax error: {e.msg}",
        )]
    sup = _Suppressions(source)
    findings: list[Finding] = []

    def add(code: str, severity: str, lineno: int, msg: str) -> None:
        if not sup.covers(lineno, code):
            findings.append(Finding(
                code, severity, "async", f"{filename}:{lineno}", msg))

    async_module, async_per_class = _async_defs(tree)

    # AS001 — blocking calls inside async defs.  Nested *sync* defs are
    # excluded: they only run when called, possibly via an executor.
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        skip = {
            id(x)
            for d in ast.walk(fn)
            if isinstance(d, ast.FunctionDef)
            for x in ast.walk(d)
        }
        for node in ast.walk(fn):
            if id(node) in skip or not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if _matches(name, _BLOCKING):
                add("AS001", ERROR, node.lineno,
                    f"{name}() blocks the event loop inside async "
                    f"{fn.name!r} — every connection and the gateway "
                    "pump stall behind it; await an async equivalent "
                    "or push it through run_in_executor")

    # AS002 — statement-level call of a local coroutine without await.
    # `foo()` / `self.foo()` as a bare statement creates the coroutine
    # object and drops it; the body never runs.
    class _AwaitVisitor(ast.NodeVisitor):
        def __init__(self) -> None:
            self.cls: str | None = None

        def visit_ClassDef(self, node: ast.ClassDef) -> None:
            prev, self.cls = self.cls, node.name
            self.generic_visit(node)
            self.cls = prev

        def visit_Expr(self, node: ast.Expr) -> None:
            call = node.value
            if isinstance(call, ast.Call):
                target: str | None = None
                if (isinstance(call.func, ast.Name)
                        and call.func.id in async_module):
                    target = call.func.id
                elif (isinstance(call.func, ast.Attribute)
                      and isinstance(call.func.value, ast.Name)
                      and call.func.value.id == "self"
                      and self.cls is not None
                      and call.func.attr in async_per_class.get(
                          self.cls, set())):
                    target = f"self.{call.func.attr}"
                if target is not None:
                    add("AS002", ERROR, node.lineno,
                        f"{target}(...) is an async def called without "
                        "await — the coroutine is created and garbage-"
                        "collected, its body never runs; await it or "
                        "wrap in asyncio.create_task")
            self.generic_visit(node)

    _AwaitVisitor().visit(tree)

    # AS003 — wall-clock reads inside clock-injected classes (default
    # arguments excluded: `clock=time.monotonic` is the idiom).
    for cls in _clock_injected_classes(tree):
        skip = _default_arg_nodes(cls)
        for node in ast.walk(cls):
            if id(node) in skip or not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if _matches(name, _WALL_CLOCK):
                add("AS003", ERROR, node.lineno,
                    f"{name}() inside clock-injected class {cls.name!r} "
                    "— this class takes `clock` in __init__ precisely "
                    "so virtual time can drive it; call self.clock() "
                    "(or derive sleeps from it) instead")

    # AS004 — attribute-mutating callable handed to a thread/executor.
    local_defs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {
        n.name: n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        target: ast.AST | None = None
        via = ""
        if name.endswith("Thread") and name.split(".")[-1] == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    target, via = kw.value, "Thread(target=...)"
        elif name.endswith(".run_in_executor") and len(node.args) >= 2:
            target, via = node.args[1], "run_in_executor"
        elif name.endswith(".submit") and node.args:
            recv = name.rsplit(".", 2)[-2].lower()
            if any(tag in recv for tag in _EXECUTORISH):
                target, via = node.args[0], "executor.submit"
        if target is None:
            continue
        fn_node: ast.AST | None = None
        tname = ""
        if isinstance(target, ast.Name) and target.id in local_defs:
            fn_node, tname = local_defs[target.id], target.id
        elif (isinstance(target, ast.Attribute)
              and isinstance(target.value, ast.Name)
              and target.value.id == "self"
              and target.attr in local_defs):
            fn_node, tname = local_defs[target.attr], f"self.{target.attr}"
        if fn_node is not None and _mutates_attributes(fn_node):
            add("AS004", WARN, node.lineno,
                f"{via} runs {tname!r}, which assigns attribute state, "
                "off the event loop — the loop no longer owns that "
                "state; marshal writes through call_soon_threadsafe "
                "or a queue")
    return findings


def lint_file(path: pathlib.Path | str) -> list[Finding]:
    path = pathlib.Path(path)
    try:
        source = path.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("AS001", ERROR, "async", f"{path}:0",
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
    """What the AS rules lint by default: this package's gateway (under
    ``repo_root``: the directory holding the package; the rest of the
    package is synchronous by construction)."""
    package = pathlib.Path(__file__).resolve().parents[1]
    repo_root = (package.parent if repo_root is None
                 else pathlib.Path(repo_root))
    return [repo_root / package.name / "inference" / "gateway"]


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
