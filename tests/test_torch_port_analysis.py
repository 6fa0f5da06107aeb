"""The jax-free analysis layers of the PyTorch port (``analysis/``:
``source_lint``, ``async_lint``, ``model_check``, ``journal_lint`` and
the ``Finding`` vocabulary) and ``tune/slo`` against the JAX package's,
on the same inputs.  No tolerance: findings, states and orders are
compared exactly.

- The rule table, ``summarize``, ``filter_ignored``, ``exit_code`` and
  the ``lint.*`` journal records equal JAX's; an empty spec lints to
  nothing and a preflight before the plan raises JAX's ValueError (the
  traced layers: ``tests/test_torch_port_{lint,mem_lint,search}.py``).
- Source, async and journal lint give JAX's findings (rule, severity,
  ``file:line``, message) on fixture sources that break every rule (and
  suppress some), and on the JAX package's own ``inference/serve/`` and
  ``inference/gateway/`` files read as text; the journal lint's
  mutation self-check passes, its audit of a written journal equals
  JAX's, and over the port's package (its default target) it reports no
  error, as the source and async lints do.
- ``model_check.explore`` on a small ``ProtocolModel`` over each
  package's ``BlockAllocator`` (two holders acquiring, sharing and
  releasing three blocks) visits the same states, transitions and depth
  and reaches the same verdict; with a planted bug (a release that
  forgets to clear the holder) both find the refcount mismatch, minimize
  it to the same two-event script, and the script saved by one replays
  on the other (and clean on the repaired model).
- ``tune/slo``: ``SLOSpec.parse`` and ``rank`` order a seeded set of
  predictions identically, annotations included.
"""

import json
import pathlib
import textwrap
import types

import numpy as np
import pytest

from torch_automatic_distributed_neural_network_tpu import analysis as janalysis
from torch_automatic_distributed_neural_network_tpu.analysis import (
    async_lint as jasync_lint,
)
from torch_automatic_distributed_neural_network_tpu.analysis import (
    journal_lint as jjournal_lint,
)
from torch_automatic_distributed_neural_network_tpu.analysis import (
    model_check as jmodel_check,
)
from torch_automatic_distributed_neural_network_tpu.analysis import (
    source_lint as jsource_lint,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve.kv_pool import (
    BlockAllocator as JAllocator,
)
from torch_automatic_distributed_neural_network_tpu.tune import slo as jslo
from torch_automatic_distributed_neural_network_tpu_torch import analysis
from torch_automatic_distributed_neural_network_tpu_torch.analysis import (
    async_lint,
    journal_lint,
    model_check,
    source_lint,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve.kv_pool import (
    BlockAllocator,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
    as_default,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import slo

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "torch_automatic_distributed_neural_network_tpu"
PORT_PKG = ROOT / "torch_automatic_distributed_neural_network_tpu_torch"


def _rows(findings):
    return [f.to_json() for f in findings]


def test_finding_vocabulary_matches_jax():
    assert {c: vars(r) for c, r in analysis.RULES.items()} == {
        c: vars(r) for c, r in janalysis.RULES.items()}
    fs = [analysis.Finding("SL002", analysis.ERROR, "source", "a.py:3", "x"),
          analysis.Finding("JL005", analysis.WARN, "journal", "b.py:9", "y"),
          analysis.Finding("SL002", analysis.ERROR, "source", "c.py:1", "z")]
    jfs = [janalysis.Finding(**f.to_json()) for f in fs]
    assert analysis.summarize(fs) == janalysis.summarize(jfs)
    for ignore in ((), ("sl002",), ("JL005", "SL002")):
        assert _rows(analysis.filter_ignored(fs, ignore)) == _rows(
            janalysis.filter_ignored(jfs, ignore))
    with pytest.raises(ValueError, match="unknown lint code"):
        analysis.filter_ignored(fs, ("XX999",))
    for subset in (fs, fs[1:2], []):
        for strict in (False, True):
            assert analysis.exit_code(subset, strict=strict) == (
                janalysis.exit_code([janalysis.Finding(**f.to_json())
                                     for f in subset], strict=strict))
    assert fs[0].format() == jfs[0].format()
    jnl = Journal(None, host0_only=False, validate=True)
    with as_default(jnl):
        analysis.journal_findings(fs, phase="check")
    assert [r["name"] for r in jnl.records][-4:] == (
        ["lint.finding"] * 3 + ["lint.summary"])
    assert jnl.records[-1]["errors"] == 2
    err = analysis.PreflightError(fs)
    assert err.findings == fs and "2 error(s)" in str(err)
    # the traced layers are ported (tests/test_torch_port_lint.py): an
    # empty spec lints to nothing, and a preflight before the plan is
    # JAX's ValueError
    assert analysis.check_spec({}) == janalysis.check_spec({}) == []
    assert analysis.analyze({}) == janalysis.analyze({}) == []
    unplanned = types.SimpleNamespace(plan=None)
    for pkg in (analysis, janalysis):
        with pytest.raises(ValueError, match="needs a built plan"):
            pkg.preflight(unplanned, None)


SOURCE_FIXTURE = textwrap.dedent('''\
    import time
    from functools import partial

    import jax
    import numpy as np


    def helper(x, acc=[], opts={}, when=time.time()):
        try:
            return x
        except:
            return None


    def helper(x):  # a second def shadows the first
        return x


    @jax.jit
    def train_step(state, batch):
        if batch:
            return state
        t = time.time()
        noise = np.random.rand()
        return state + t + noise


    @partial(jax.jit, static_argnames=("n",))
    def scan_step(x, n):
        if n:
            return x
        return x


    def fine(x=None, y=(), z=frozenset()):
        try:
            return x
        except:  # tadnn: lint-ok(SL002) the fixture's sanctioned case
            return None


    def unjustified(x=[]):  # tadnn: lint-ok(SL003)
        return x
''')

ASYNC_FIXTURE = textwrap.dedent('''\
    import asyncio
    import subprocess
    import threading
    import time


    async def pump(self):
        time.sleep(0.1)
        subprocess.run(["true"])
        await asyncio.sleep(0)


    async def flush():
        return None


    async def loop_body():
        flush()
        await flush()


    class Gate:
        def __init__(self, clock=time.monotonic):
            self.clock = clock
            self.n = 0

        def now(self):
            return time.monotonic()

        async def wait(self):
            await asyncio.sleep(1.0)

        def bump(self):
            self.n += 1

        def start(self, executor):
            executor.submit(self.bump)
            threading.Thread(target=self.bump).start()

        def ok(self):
            return time.monotonic()  # tadnn: lint-ok(AS003) host stamp
''')


def _named(directory, pattern="*.py"):
    return [(str(p.relative_to(ROOT)), p.read_text())
            for p in sorted(directory.glob(pattern))]


def test_source_lint_matches_jax():
    got = source_lint.lint_source(SOURCE_FIXTURE, "fixture.py")
    want = jsource_lint.lint_source(SOURCE_FIXTURE, "fixture.py")
    assert _rows(got) == _rows(want)
    assert {f.code for f in got} == {"SL001", "SL002", "SL003", "SL004",
                                     "SL005", "SL006"}
    for name, text in _named(JAX_PKG / "inference" / "serve"):
        assert _rows(source_lint.lint_source(text, name)) == _rows(
            jsource_lint.lint_source(text, name)), name
    # its default target is the port's own package, and it is clean
    assert source_lint.default_paths() == [PORT_PKG]
    assert [f.format() for f in source_lint.lint_paths()] == []


def test_async_lint_matches_jax():
    got = async_lint.lint_source(ASYNC_FIXTURE, "fixture.py")
    want = jasync_lint.lint_source(ASYNC_FIXTURE, "fixture.py")
    assert _rows(got) == _rows(want)
    assert {f.code for f in got} == {"AS001", "AS002", "AS003", "AS004"}
    for sub in ("serve", "gateway"):
        for name, text in _named(JAX_PKG / "inference" / sub):
            assert _rows(async_lint.lint_source(text, name)) == _rows(
                jasync_lint.lint_source(text, name)), name
    assert async_lint.default_paths() == [PORT_PKG / "inference" / "gateway"]
    assert async_lint.lint_paths() == []


def test_journal_lint_matches_jax_and_passes_on_the_port(tmp_path):
    assert journal_lint.self_check() == [] == jjournal_lint.self_check()
    # each mutation of the fixture, and the JAX package's serving files,
    # give JAX's findings and stats
    cases = [[("<fixture>", journal_lint.FIXTURE.replace(old, new))]
             for old, new, _ in journal_lint.MUTATIONS]
    cases.append(_named(JAX_PKG / "inference" / "serve"))
    cases.append(_named(JAX_PKG / "inference" / "gateway"))
    for named in cases:
        for full in (False, True):
            got, gstats = journal_lint.lint_sources(named, full_scan=full)
            want, wstats = jjournal_lint.lint_sources(named, full_scan=full)
            assert _rows(got) == _rows(want) and gstats == wstats
    scan = journal_lint.scan_source(journal_lint.FIXTURE, "f.py")
    jscan = jjournal_lint.scan_source(journal_lint.FIXTURE, "f.py")

    def sites(result, unknown):
        return [{**vars(s), "fields": {k: "?" if v is unknown else v
                                       for k, v in s.fields.items()}}
                for s in result.sites]

    assert sites(scan, journal_lint._UNKNOWN) == sites(
        jscan, jjournal_lint._UNKNOWN)
    assert [vars(r) for r in scan.reads] == [vars(r) for r in jscan.reads]
    # the port's package: every emission and consumption site resolves
    # against the schema, with no error
    findings, stats = journal_lint.lint_paths()
    assert [f.format() for f in findings if f.severity == analysis.ERROR] \
        == []
    assert stats["sites"] > 40 and stats["coverage"] == 1.0
    assert journal_lint.default_paths() == [PORT_PKG, ROOT / "chip_smoke.py"]
    # a written journal, audited record by record
    path = tmp_path / "j.jsonl"
    jnl = Journal(str(path), host0_only=False)
    jnl.event("serve.preempt", rid=3, n_regenerate=4)
    jnl.event("serve.preempt", rid=3)  # a required field missing
    jnl.event("serve.unknown_kind", x=1)
    jnl.close()
    with open(path, "a") as f:
        f.write('{"torn": ')
    got, gstats = journal_lint.audit_journal(str(path))
    want, wstats = jjournal_lint.audit_journal(str(path))
    assert _rows(got) == _rows(want) and gstats == wstats
    assert {f.code for f in got} == {"JL001", "JL002"} and gstats["torn"] == 1


def _allocator_model(mc, allocator_cls, *, bug=False):
    """Two holders over a 4-block allocator (3 usable), three operations
    each: acquire one block, share a held block with the other holder;
    a release of everything held is always enabled.  Safety: the
    allocator's refcounts equal the holders' counts and no block is
    lost; quiescence (every operation spent, nothing held): no block is
    live.  ``bug``: a release that forgets to clear the holder, so the
    next release double-frees."""

    class AllocatorModel(mc.ProtocolModel):
        name = "allocator"
        rule = "PC001"

        def initial(self):
            return {"alloc": allocator_cls(4), "held": [[], []],
                    "ops": [0, 0]}

        def enabled(self, w):
            out = []
            for h, held in enumerate(w["held"]):
                other = w["held"][1 - h]
                if w["ops"][h] < 3 and len(held) < 2 and w["alloc"].n_free:
                    out.append(("acquire", h))
                if w["ops"][h] < 3 and held and len(other) < 2:
                    out.append(("share", h))
                if held:
                    out.append(("release", h))
            return out

        def apply(self, w, ev):
            kind, h = ev
            alloc = w["alloc"]
            if kind == "acquire":
                w["held"][h] += alloc.acquire(1)
                w["ops"][h] += 1
            elif kind == "share":
                b = w["held"][h][0]
                alloc.ref(b)
                w["held"][1 - h].append(b)
                w["ops"][h] += 1
            else:
                alloc.release(list(w["held"][h]))
                if not bug:
                    w["held"][h] = []

        def violations(self, w):
            refs = {}
            for held in w["held"]:
                for b in held:
                    refs[b] = refs.get(b, 0) + 1
            alloc = w["alloc"]
            if any(alloc.refcount(b) != n for b, n in refs.items()):
                return [("PC001", f"refcounts {refs}")]
            if alloc.n_free + alloc.n_live != 3:
                return [("PC001", "a block was lost")]
            return []

        def quiescent(self, w):
            return not self.enabled(w)

        def terminal_violations(self, w):
            if w["alloc"].n_live:
                return [("PC006", "blocks still live at quiescence")]
            return []

        def fingerprint(self, w):
            return mc.canonical(w)

    return AllocatorModel({"holders": 2, "blocks": 3})


def _result(res):
    out = res.to_json()
    out.pop("wall_s")
    return out


def test_model_check_matches_jax(tmp_path):
    got = model_check.explore(_allocator_model(model_check, BlockAllocator))
    want = jmodel_check.explore(_allocator_model(jmodel_check, JAllocator))
    assert _result(got) == _result(want)
    assert got.complete and not got.counterexamples and got.states > 20
    # a planted double free: found, minimized and replayed alike
    bad = model_check.explore(
        _allocator_model(model_check, BlockAllocator, bug=True))
    jbad = jmodel_check.explore(
        _allocator_model(jmodel_check, JAllocator, bug=True))
    assert _result(bad) == _result(jbad)
    cx = bad.counterexamples[0]
    assert cx.code == "PC001" and cx.minimized and cx.events == [
        ("acquire", 0), ("release", 0)]
    path = str(tmp_path / "cx.json")
    model_check.save_script(cx, path)
    assert json.load(open(path)) == jbad.counterexamples[0].to_json()
    with pytest.raises(model_check.ProtocolViolation, match="PC001"):
        model_check.replay_script(path, lambda name, scope: _allocator_model(
            model_check, BlockAllocator, bug=True))
    with pytest.raises(jmodel_check.ProtocolViolation, match="PC001"):
        jmodel_check.replay_script(
            model_check.load_script(path).to_json(),
            lambda name, scope: _allocator_model(jmodel_check, JAllocator,
                                                 bug=True))
    # on the repaired model the script replays clean
    assert model_check.replay_script(path, lambda name, scope: (
        _allocator_model(model_check, BlockAllocator))) is None


def test_slo_rank_matches_jax():
    text = "tok_s_chip>=40,p99_ms<=2500,headroom>=0.1,ttft_ms<=800"
    spec, jspec = slo.SLOSpec.parse(text), jslo.SLOSpec.parse(text)
    assert vars(spec) == vars(jspec)
    rs = np.random.RandomState(4)
    preds = []
    for i in range(40):
        p = {"id": i, "tok_s_per_chip": float(rs.uniform(10, 80)),
             "p99_s": float(rs.uniform(0.5, 4.0)),
             "hbm_headroom_frac": float(rs.uniform(-0.1, 0.5)),
             "ttft_p99_s": float(rs.uniform(0.1, 1.5)),
             "step_time_s": float(rs.uniform(0.1, 1.0)),
             "fits": bool(rs.rand() > 0.1)}
        for key in ("tok_s_per_chip", "ttft_p99_s"):
            if rs.rand() < 0.1:
                p[key] = None
        preds.append(p)
    got = slo.rank([dict(p) for p in preds], spec)
    want = jslo.rank([dict(p) for p in preds], jspec)
    assert got == want and got[0]["slo_ok"]
    assert [slo.rank_key(p) for p in got] == [jslo.rank_key(p) for p in want]
    for bad in ("tok_s_chip>40", "latency<=3", "p99_ms>=3"):
        with pytest.raises(ValueError):
            slo.SLOSpec.parse(bad)
        with pytest.raises(ValueError):
            jslo.SLOSpec.parse(bad)
    assert vars(slo.SLOSpec.parse("")) == vars(slo.SLOSpec())
