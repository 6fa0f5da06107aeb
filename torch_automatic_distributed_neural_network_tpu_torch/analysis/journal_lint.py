"""Journal telemetry contract lint (JL00x) — producer/consumer flow
checks against the event schema registry (:mod:`..obs.schema`).

An AST pass in the ``Finding``/``RULES`` vocabulary: it resolves
every journal **emission site** (``journal.event(...)`` /
``journal.span(...)`` and their wrappers, including literal-dict splats
and span-record field attachments ``rec["f"] = ...``) and every
**consumption site** (``e.get("field")`` reads scoped to an event kind
by a name filter — comprehension filters, ``last("kind")``-style
helpers, ``if name == "kind":`` chains) and checks both ends against
the registry:

- JL001  unknown event kind (emitted or consumed, not in the registry)
- JL002  required field missing at an emission site
- JL003  literal payload value type-incompatible with the schema
- JL004  field emitted but never declared (closed-schema drift)
- JL005  declared optional field never emitted anywhere (dead schema)
- JL006  consumer reads a field no producer declares
- JL007  emission (or hardcoded consumer acceptance) under a
         deprecated alias — use ``obs.schema.names_for``

The lint **self-validates**:
:data:`MUTATIONS` plants single-line payload drifts into
:data:`FIXTURE` and :func:`self_check` asserts each yields exactly its
expected JL finding while the clean fixture yields none.

Suppression follows source lint: ``# tadnn: lint-ok(JL00x) <reason>``
on the flagged line or the line above.

The PyTorch package's copy of the JAX package's
``analysis/journal_lint.py``, on the port's schema registry (a copy of
JAX's): by default it scans this package.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable, Sequence

from . import ERROR, WARN, Finding
from .source_lint import _Suppressions, iter_py_files
from ..obs import schema as _schema

_UNKNOWN = object()  # payload value not statically resolvable

# Receiver-name hints that make a non-literal first argument count as a
# *dynamic emission site* (vs. an unrelated ``.span(i)``/``.event(x)``
# method on some other object, e.g. ``re.Match.span``).
_JOURNALISH = ("journal", "obs", "jrn")


# -- scan products ----------------------------------------------------------

@dataclasses.dataclass
class EmitSite:
    file: str
    line: int
    kinds: tuple[str, ...]  # empty = dynamic (unresolvable name)
    fields: dict  # field -> literal value | _UNKNOWN
    has_splat: bool
    is_span: bool


@dataclasses.dataclass
class Read:
    file: str
    line: int
    field: str
    kinds: tuple[str, ...]


@dataclasses.dataclass
class NameTest:
    file: str
    line: int
    kind: str


@dataclasses.dataclass
class ScanResult:
    sites: list[EmitSite]
    reads: list[Read]
    tests: list[NameTest]
    sup: _Suppressions


# -- small AST helpers ------------------------------------------------------

def _literal_kinds(node: ast.AST) -> tuple[str, ...]:
    """Event names a first-argument expression can evaluate to: a
    string literal, or an IfExp whose branches are both literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, ast.IfExp):
        a = _literal_kinds(node.body)
        b = _literal_kinds(node.orelse)
        if a and b:
            return a + b
    return ()


def _literal_value(node: ast.AST):
    """The JSON-ish value a payload expression statically is, else
    :data:`_UNKNOWN` (type checks are skipped for unknowns)."""
    if isinstance(node, ast.Constant):
        return node.value
    if (isinstance(node, ast.UnaryOp)
            and isinstance(node.op, (ast.USub, ast.UAdd))
            and isinstance(node.operand, ast.Constant)
            and isinstance(node.operand.value, (int, float))
            and not isinstance(node.operand.value, bool)):
        v = node.operand.value
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        return []
    if isinstance(node, ast.Dict):
        return {}
    if isinstance(node, ast.JoinedStr):
        return ""
    return _UNKNOWN


def _receiver_dotted(func: ast.AST) -> str:
    parts: list[str] = []
    node = func.value if isinstance(func, ast.Attribute) else None
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts)).lower()


def _emit_call(call: ast.Call) -> str | None:
    """'event' / 'span' when this Call is a journal emission."""
    f = call.func
    if isinstance(f, ast.Attribute):
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    else:
        return None
    if name not in ("event", "span") or not call.args:
        return None
    first = call.args[0]
    if isinstance(first, ast.Constant) and not isinstance(first.value, str):
        return None  # re.Match.span(1) and friends
    if not _literal_kinds(first):
        # non-literal name: only journal-looking receivers (or calls
        # carrying payload) count as dynamic emission sites
        recv = _receiver_dotted(f)
        if not call.keywords and not any(h in recv for h in _JOURNALISH) \
                and recv not in ("j", "jr"):
            return None
    return name


def _const_strs(node: ast.AST) -> tuple[str, ...]:
    """String literals a comparator holds: a constant, a tuple/list/set
    of constants, or a ``names_for("kind")`` call (resolved through the
    registry's alias table)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return ()
        return tuple(out)
    if (isinstance(node, ast.Call) and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        fn = node.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if fname == "names_for":
            # registry-driven acceptance is the sanctioned alias
            # mechanism: attribute to the canonical kind only (aliases
            # share its schema) so JL007 never fires on names_for use
            return (_schema.canonical(node.args[0].value),)
    return ()


def _name_subject(node: ast.AST) -> tuple[str, str] | None:
    """('get', var) for ``var.get("name")`` / ``var["name"]``;
    ('var', var) for a bare name variable."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "name"
            and isinstance(node.func.value, ast.Name)):
        return ("get", node.func.value.id)
    if (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == "name"):
        return ("get", node.value.id)
    if isinstance(node, ast.Name):
        return ("var", node.id)
    return None


def _name_test(test: ast.AST):
    """``(subject, kinds)`` when ``test`` filters records by event name
    (``x.get("name") == "k"`` / ``in ("k1","k2")`` / or-chains /
    the matching arm of an and-chain); None otherwise."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        subj = _name_subject(test.left)
        if subj and isinstance(test.ops[0], (ast.Eq, ast.In)):
            ks = _const_strs(test.comparators[0])
            if ks:
                return subj, ks
        return None
    if isinstance(test, ast.BoolOp):
        if isinstance(test.op, ast.Or):
            parts = [_name_test(v) for v in test.values]
            if all(parts) and len({p[0] for p in parts}) == 1:
                return parts[0][0], tuple(
                    k for p in parts for k in p[1])
            return None
        for v in test.values:  # And: the name-test conjunct scopes it
            r = _name_test(v)
            if r:
                return r
    return None


def _get_reads(node: ast.AST):
    """Yield ``(receiver_expr, field, lineno)`` for every literal
    ``X.get("field")`` / ``name["field"]`` read under ``node``."""
    for n in ast.walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "get" and n.args
                and isinstance(n.args[0], ast.Constant)
                and isinstance(n.args[0].value, str)):
            yield n.func.value, n.args[0].value, n.lineno
        elif (isinstance(n, ast.Subscript)
              and isinstance(n.ctx, ast.Load)
              and isinstance(n.value, ast.Name)
              and isinstance(n.slice, ast.Constant)
              and isinstance(n.slice.value, str)):
            yield n.value, n.slice.value, n.lineno


# -- per-module scanner -----------------------------------------------------

class _ModuleScan:
    def __init__(self, tree: ast.Module, filename: str):
        self.tree = tree
        self.file = filename
        self.sites: list[EmitSite] = []
        self.reads: list[Read] = []
        self.tests: list[NameTest] = []
        self.parents: dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node

    def run(self) -> None:
        self._scan_emissions()
        scopes = [self.tree] + [
            n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            self._scan_consumption(scope)

    # -- producers ----------------------------------------------------

    def _scan_emissions(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            what = _emit_call(node)
            if what is None:
                continue
            fields: dict = {}
            has_splat = False
            for kw in node.keywords:
                if kw.arg is not None:
                    fields[kw.arg] = _literal_value(kw.value)
                elif isinstance(kw.value, ast.Dict) and all(
                        isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        for k in kw.value.keys):
                    for k, v in zip(kw.value.keys, kw.value.values):
                        fields[k.value] = _literal_value(v)
                else:
                    has_splat = True
            if what == "span":
                has_splat |= self._span_attachments(node, fields)
            self.sites.append(EmitSite(
                self.file, node.lineno, _literal_kinds(node.args[0]),
                fields, has_splat, what == "span"))

    def _span_attachments(self, call: ast.Call, fields: dict) -> bool:
        """Fold ``with j.span(...) as rec: rec["f"] = v`` attachments
        into the site's fields; True when a non-literal key makes the
        attachment set unresolvable (treated like a splat)."""
        item = self.parents.get(id(call))
        if not isinstance(item, ast.withitem) or item.context_expr is not call:
            return False
        if not isinstance(item.optional_vars, ast.Name):
            return False
        rec = item.optional_vars.id
        with_node = self.parents.get(id(item))
        if not isinstance(with_node, (ast.With, ast.AsyncWith)):
            return False
        unresolved = False
        for n in ast.walk(with_node):
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == rec):
                    if (isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)):
                        val = getattr(n, "value", None)
                        fields[t.slice.value] = (
                            _literal_value(val) if val is not None
                            and not isinstance(n, ast.AugAssign)
                            else _UNKNOWN)
                    else:
                        unresolved = True
        return unresolved

    # -- consumers ----------------------------------------------------

    def _scope_stmts(self, scope: ast.AST):
        """All nodes of this scope, excluding nested function bodies
        (they are their own scopes)."""
        inner = {
            id(x)
            for n in ast.walk(scope)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not scope
            for x in ast.walk(n)
        }
        for n in ast.walk(scope):
            if id(n) not in inner or n is scope:
                yield n

    def _kinds_of_expr(self, node: ast.AST, bindings: dict) -> tuple:
        if isinstance(node, ast.Name):
            return bindings.get(node.id, ())
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or):
            return self._kinds_of_expr(node.values[0], bindings)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            k = node.args[0].value
            if _schema.get(k) is not None:
                return (k,)
            return ()
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("reversed", "sorted", "list")
                and node.args):
            return self._kinds_of_expr(node.args[0], bindings)
        if isinstance(node, ast.Subscript):
            return self._kinds_of_expr(node.value, bindings)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            kinds: tuple = ()
            for gen in node.generators:
                if not isinstance(gen.target, ast.Name):
                    continue
                for t in gen.ifs:
                    r = _name_test(t)
                    if r and r[0] == ("get", gen.target.id):
                        kinds += r[1]
            return kinds
        return ()

    def _scan_consumption(self, scope: ast.AST) -> None:
        bindings: dict[str, tuple[str, ...]] = {}
        name_vars: dict[str, str] = {}  # nameVar -> record var
        nodes = list(self._scope_stmts(scope))
        # pass 1: variable bindings
        for n in nodes:
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)):
                continue
            var = n.targets[0].id
            kinds = self._kinds_of_expr(n.value, bindings)
            if kinds:
                bindings[var] = kinds
            subj = _name_subject(n.value)
            if subj and subj[0] == "get":
                name_vars[var] = subj[1]
        # pass 2: kind-scoped reads + consumer name literals
        for n in nodes:
            if isinstance(n, ast.If):
                self._if_reads(n, bindings, name_vars)
            elif isinstance(n, (ast.ListComp, ast.GeneratorExp,
                                ast.SetComp, ast.DictComp)):
                self._comp_reads(n, bindings)
            elif isinstance(n, (ast.For, ast.AsyncFor)):
                self._for_reads(n, bindings)
        # pass 3: inline reads on bound receivers
        for n in nodes:
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "get" and n.args
                    and isinstance(n.args[0], ast.Constant)
                    and isinstance(n.args[0].value, str)
                    and n.args[0].value != "name"):
                recv = n.func.value
                if isinstance(recv, ast.Name):
                    kinds = bindings.get(recv.id, ())
                else:
                    kinds = self._kinds_of_expr(recv, bindings)
                if kinds:
                    self.reads.append(Read(
                        self.file, n.lineno, n.args[0].value, kinds))

    def _record_test(self, line: int, kinds: Iterable[str]) -> None:
        for k in kinds:
            self.tests.append(NameTest(self.file, line, k))

    def _body_reads(self, stmts: Sequence[ast.stmt], kinds: tuple,
                    recvars: set | None) -> None:
        """Reads inside a kind-scoped If body; nested Ifs carrying their
        own name test are skipped (they re-scope on their own)."""
        for stmt in stmts:
            if isinstance(stmt, ast.If) and _name_test(stmt.test):
                continue
            for recv, field, line in _get_reads(stmt):
                if field == "name":
                    continue
                if recvars is not None and not (
                        isinstance(recv, ast.Name) and recv.id in recvars):
                    continue
                if recvars is None and not isinstance(recv, ast.Name):
                    continue
                self.reads.append(Read(self.file, line, field, kinds))

    def _if_reads(self, node: ast.If, bindings: dict,
                  name_vars: dict) -> None:
        r = _name_test(node.test)
        if not r:
            return
        subj, kinds = r
        if subj[0] == "var":
            if subj[1] in name_vars:
                recvars = {name_vars[subj[1]]}
            elif subj[1] == "name" and any(
                    _schema.get(k) is not None for k in kinds):
                # a bare ``name`` parameter compared against registry
                # kinds (the LiveAggregator._fold convention) — the
                # record variable is unknowable, so reads are collected
                # unscoped.  Bare variables matching no known kind are
                # NOT name tests (``if name == "convert_element_type"``
                # in the jaxpr walkers compares primitive names).
                recvars = None
            else:
                return
        else:
            recvars = {subj[1]}
        self._record_test(node.lineno, kinds)
        self._body_reads(node.body, kinds, recvars)

    def _comp_reads(self, node, bindings: dict) -> None:
        for gen in node.generators:
            if not isinstance(gen.target, ast.Name):
                continue
            kinds = self._kinds_of_expr(gen.iter, bindings)
            for t in gen.ifs:
                r = _name_test(t)
                if r and r[0] == ("get", gen.target.id):
                    kinds += r[1]
                    self._record_test(t.lineno if hasattr(t, "lineno")
                                      else node.lineno, r[1])
            if not kinds:
                continue
            var = gen.target.id
            elts = [e for e in (
                getattr(node, "elt", None), getattr(node, "key", None),
                getattr(node, "value", None), *gen.ifs) if e is not None]
            for e in elts:
                for recv, field, line in _get_reads(e):
                    if (field != "name" and isinstance(recv, ast.Name)
                            and recv.id == var):
                        self.reads.append(Read(self.file, line, field, kinds))

    def _for_reads(self, node, bindings: dict) -> None:
        if not isinstance(node.target, ast.Name):
            return
        kinds = self._kinds_of_expr(node.iter, bindings)
        if kinds:
            self._body_reads(node.body, kinds, {node.target.id})


# -- scanning + rules -------------------------------------------------------

def scan_source(source: str, filename: str = "<string>") -> ScanResult:
    tree = ast.parse(source, filename=filename)
    scan = _ModuleScan(tree, filename)
    scan.run()
    return ScanResult(scan.sites, scan.reads, scan.tests,
                      _Suppressions(source))


def _apply_rules(results: Sequence[ScanResult], *,
                 full_scan: bool) -> tuple[list[Finding], dict]:
    sup = {r.sup: r for r in results}
    by_file = {}
    for r in results:
        for s in r.sites:
            by_file.setdefault(s.file, r.sup)
        for rd in r.reads:
            by_file.setdefault(rd.file, r.sup)
        for t in r.tests:
            by_file.setdefault(t.file, r.sup)
    findings: list[Finding] = []

    def add(code: str, sev: str, file: str, line: int, msg: str) -> None:
        s = by_file.get(file)
        if s is not None and s.covers(line, code):
            return
        findings.append(Finding(code, sev, "journal", f"{file}:{line}", msg))

    sites = [s for r in results for s in r.sites]
    reads = [rd for r in results for rd in r.reads]
    tests = [t for r in results for t in r.tests]

    emitted: dict[str, set[str]] = {}  # canonical kind -> fields union
    splatted: set[str] = set()  # kinds with >=1 unresolvable-payload site
    resolved_kinds: set[str] = set()
    dynamic_sites = 0

    for site in sites:
        if not site.kinds:
            dynamic_sites += 1
            continue
        for kind in site.kinds:
            canon = _schema.canonical(kind)
            resolved_kinds.add(canon)
            if kind in _schema.ALIASES:
                add("JL007", WARN, site.file, site.line,
                    f"emitted under deprecated alias {kind!r} — the "
                    f"canonical kind is {canon!r}")
            sch = _schema.get(kind)
            if sch is None:
                add("JL001", ERROR, site.file, site.line,
                    f"unknown event kind {kind!r}: not declared in "
                    "obs/schema.py (see `tadnn check --journal --rules`)")
                continue
            emitted.setdefault(canon, set()).update(site.fields)
            if site.has_splat:
                splatted.add(canon)
            else:
                for f in sch.required:
                    if f not in site.fields:
                        add("JL002", ERROR, site.file, site.line,
                            f"{canon}: required field {f!r} not emitted "
                            "at this site")
            declared = sch.fields()
            for f, v in site.fields.items():
                spec = declared.get(f)
                if spec is None:
                    # base-named extras (an event passing dur_s=,
                    # launch metas passing host=) ride on the record's
                    # own field set; only undeclared NON-base fields
                    # are closed-schema drift
                    if f in _schema.BASE_FIELDS:
                        continue
                    if not sch.open:
                        add("JL004", ERROR, site.file, site.line,
                            f"{canon}: field {f!r} emitted but not "
                            "declared in the schema")
                elif v is not _UNKNOWN and not _schema.check_value(v, spec):
                    add("JL003", ERROR, site.file, site.line,
                        f"{canon}: literal {f}={v!r} is not of declared "
                        f"type {spec!r}")

    if full_scan:
        for canon, sch in sorted(_schema.REGISTRY.items()):
            if sch.open or canon in splatted or canon not in emitted:
                continue
            for f in sch.optional:
                if f not in emitted[canon] and f not in _schema.BASE_FIELDS:
                    findings.append(Finding(
                        "JL005", WARN, "journal", f"schema:{canon}",
                        f"declared optional field {f!r} is never emitted "
                        "by any producer (dead schema)"))

    for rd in reads:
        kinds = [_schema.canonical(k) for k in rd.kinds]
        schemas = [_schema.get(k) for k in kinds]
        if any(s is None or s.open for s in schemas):
            continue  # unknown kinds surface via JL001 at the test site
        if rd.field in _schema.BASE_FIELDS:
            continue
        if not any(rd.field in s.fields() for s in schemas):
            add("JL006", ERROR, rd.file, rd.line,
                f"consumer reads field {rd.field!r} of "
                f"{'/'.join(sorted(set(kinds)))} but no producer "
                "declares it")

    seen_tests = set()
    for t in tests:
        key = (t.file, t.line, t.kind)
        if key in seen_tests:
            continue
        seen_tests.add(key)
        if _schema.get(t.kind) is None:
            add("JL001", ERROR, t.file, t.line,
                f"consumer filters on unknown event kind {t.kind!r}")
        elif t.kind in _schema.ALIASES:
            add("JL007", WARN, t.file, t.line,
                f"consumer hardcodes deprecated alias {t.kind!r} — "
                "accept via obs.schema.names_for"
                f"({_schema.canonical(t.kind)!r})")

    known = resolved_kinds & set(_schema.REGISTRY)
    stats = {
        "kinds_emitted": len(resolved_kinds),
        "kinds_known": len(_schema.REGISTRY),
        "sites": sum(1 for s in sites if s.kinds),
        "dynamic_sites": dynamic_sites,
        "coverage": (len(known) / len(resolved_kinds)
                     if resolved_kinds else 1.0),
        "reads": len(reads),
    }
    del sup
    return findings, stats


def lint_sources(named: Sequence[tuple[str, str]], *,
                 full_scan: bool = False) -> tuple[list[Finding], dict]:
    """Scan ``(filename, source)`` pairs and apply JL001–JL007.
    ``full_scan`` enables the whole-world rules (JL005 dead schema) —
    only correct when ``named`` is the complete producer set."""
    results = []
    findings: list[Finding] = []
    for fname, src in named:
        try:
            results.append(scan_source(src, fname))
        except SyntaxError as e:
            findings.append(Finding(
                "JL001", ERROR, "journal", f"{fname}:{e.lineno or 0}",
                f"unparseable module: {e.msg}"))
    more, stats = _apply_rules(results, full_scan=full_scan)
    return findings + more, stats


def default_paths(repo_root: pathlib.Path | str | None = None
                  ) -> list[pathlib.Path]:
    """The complete producer/consumer set: this package and the root
    ``chip_smoke.py`` that drives it (under ``repo_root``: the
    directory holding the package).  Its examples emit through the
    package's own helpers; tests are excluded — they emit synthetic
    kinds for their own fixtures."""
    package = pathlib.Path(__file__).resolve().parents[1]
    repo_root = (package.parent if repo_root is None
                 else pathlib.Path(repo_root))
    paths = [repo_root / package.name]
    if (repo_root / "chip_smoke.py").exists():
        paths.append(repo_root / "chip_smoke.py")
    return paths


def lint_paths(paths: Iterable[pathlib.Path | str] | None = None,
               repo_root: pathlib.Path | str | None = None,
               *, full_scan: bool | None = None
               ) -> tuple[list[Finding], dict]:
    """Journal-contract lint over a path set.  With no explicit paths
    the full default set is scanned and whole-world rules (JL005) are
    enabled; explicit paths default to site-local rules only."""
    if full_scan is None:
        full_scan = paths is None
    if paths is None:
        paths = default_paths(repo_root)
    named: list[tuple[str, str]] = []
    for f in iter_py_files(paths):
        try:
            named.append((str(f), f.read_text()))
        except (OSError, UnicodeDecodeError) as e:
            return ([Finding("JL001", ERROR, "journal", f"{f}:0",
                             f"unreadable: {e}")], {})
    return lint_sources(named, full_scan=full_scan)


# -- journal-file audit -----------------------------------------------------

def audit_journal(path: str) -> tuple[list[Finding], dict]:
    """Validate a committed/artifact JSONL journal record-by-record
    against the registry (the runtime half of the contract, applied
    after the fact).  Torn lines are skipped, as ``Journal.read`` does."""
    import json

    findings: list[Finding] = []
    n = 0
    torn = 0
    severities = {"JL005": WARN, "JL007": WARN}
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if not isinstance(rec, dict):
                torn += 1
                continue
            n += 1
            for code, msg in _schema.validate_record(rec):
                findings.append(Finding(
                    code, severities.get(code, ERROR), "journal",
                    f"{path}:{lineno}", msg))
    return findings, {"records": n, "torn": torn}


# -- self-validation (mutation harness) -------------------------------------

# A clean synthetic producer/consumer module: every kind it emits is
# fully covered (all declared fields appear) so a full_scan over just
# this module yields zero findings.
FIXTURE = '''\
def produce(j, rid):
    j.event("serve.preempt", rid=rid, n_regenerate=4)
    j.event("gateway.hedge", kind="fire", rid=rid, primary="r0",
            replica="r1", winner="r1")
    j.event("gateway.breaker",
            **{"replica": "r0", "from": "closed", "to": "open"})
    j.event("journal.rotated", rotations=1, max_bytes=1024)
    j.event("serve.request_done", rid=rid, n_prompt=7, n_new=3,
            queue_s=0.0, total_s=0.5, tokens_per_s=6.0, preempted=0,
            ttft_s=0.1, itl_s=[0.01, 0.02], prefill_s=0.1, decode_s=0.4,
            itl_mean_s=0.015, kv_ship_s=None, cached_tokens=0,
            prefill_chunks=1, prefill_compute_s=0.1, lost_s=0.0,
            replica="r0")
    with j.span("ckpt.wait", sharded=True):
        pass


def consume(events):
    done = [e for e in events if e.get("name") == "serve.preempt"]
    out = [e.get("rid") for e in done]
    for e in events:
        name = e.get("name")
        if name == "gateway.hedge":
            out.append(e.get("winner"))
        elif name in ("gateway.breaker",):
            out.append(e.get("replica"))
    return out
'''

# (anchor-to-replace, replacement, expected JL code) — each anchor is a
# unique single-line fragment of FIXTURE; applying exactly one mutation
# must yield exactly its expected finding.
MUTATIONS: tuple[tuple[str, str, str], ...] = (
    ('j.event("serve.preempt", rid=rid, n_regenerate=4)',
     'j.event("serve.preemptX", rid=rid, n_regenerate=4)',
     "JL001"),  # producer kind typo
    ('j.event("serve.preempt", rid=rid, n_regenerate=4)',
     'j.event("serve.preempt", rid=rid)',
     "JL002"),  # required field dropped
    ('"from": "closed", "to": "open"}',
     '"from": "closed"}',
     "JL002"),  # required key dropped from a literal-dict splat
    ("rotations=1, max_bytes=1024",
     'rotations="one", max_bytes=1024',
     "JL003"),  # int field emitted as str
    ('with j.span("ckpt.wait", sharded=True):',
     'with j.span("ckpt.wait", sharded="yes"):',
     "JL003"),  # bool field emitted as str (span site)
    ('j.event("serve.preempt", rid=rid, n_regenerate=4)',
     'j.event("serve.preempt", rid=rid, n_regenerate=4, slot=3)',
     "JL004"),  # undeclared field on a closed schema
    ('replica="r1", winner="r1")',
     'replica="r1")',
     "JL005"),  # declared optional field no longer emitted anywhere
    ('out = [e.get("rid") for e in done]',
     'out = [e.get("slot_id") for e in done]',
     "JL006"),  # consumer reads a field nobody declares
    ('j.event("serve.request_done", rid=rid, n_prompt=7, n_new=3,',
     'j.event("serve.request", rid=rid, n_prompt=7, n_new=3,',
     "JL007"),  # emission under the deprecated alias
    ('if e.get("name") == "serve.preempt"]',
     'if e.get("name") == "serve.gone"]',
     "JL001"),  # consumer filters on an unknown kind
)


def self_check() -> list[str]:
    """Prove the lint detects what it claims to detect: the clean
    fixture yields zero findings; each planted single-line mutation
    yields exactly its expected finding."""
    problems: list[str] = []
    clean, _ = lint_sources([("<fixture>", FIXTURE)], full_scan=True)
    if clean:
        problems.append(
            "clean fixture not clean: "
            + "; ".join(f.format() for f in clean))
    for i, (old, new, code) in enumerate(MUTATIONS):
        if FIXTURE.count(old) != 1:
            problems.append(f"mutation {i} ({code}): anchor not unique "
                            f"({FIXTURE.count(old)} occurrences)")
            continue
        got, _ = lint_sources(
            [("<fixture>", FIXTURE.replace(old, new))], full_scan=True)
        codes = [f.code for f in got]
        if codes != [code]:
            problems.append(
                f"mutation {i} expected exactly [{code}], got {codes}: "
                + "; ".join(f.format() for f in got))
    return problems
