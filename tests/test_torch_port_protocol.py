"""The port's protocol models (``analysis/protocol.py``) and ``tadnn
check`` against the JAX package's.

- Each cheap model (allocator, reserve scheduler, gateway — JAX's own
  cheap tier) explored at ``default_scope`` over the port's serving
  objects gives JAX's scope, state count, transitions, depth, frontier
  peak and completeness, exactly, and no violation.
- A counterexample script JAX saves for a planted bug replays through
  the port's model, under the port's copy of the same mutation, as a
  ``ProtocolViolation`` with the same rule code, and does not reproduce
  on the port's clean code.
- ``tadnn check --no-source --protocol --json`` (the models cut to the
  allocator for this tier) prints JAX's per-model statistics and writes
  no counterexample; ``--serving --family gpt2 --size test`` gives JAX's
  findings and estimate (``params_bytes`` counted on the meta device)
  in JSON and as text; the source lint of one file gives JAX's findings
  and exit code, ``--strict`` too; ``--rules`` (and ``--rules
  --journal``) print JAX's tables; ``--preflight`` of a file without
  ``tadnn_check()`` exits 2 as JAX's does, and ``--memory`` and
  ``--serving --trace-serve`` (on ``--device cpu``) exit 0 as JAX's do
  (their findings against JAX's: ``tests/test_torch_port_lint.py``,
  ``tests/test_torch_port_mem_lint.py``).
- Slow tier, as JAX's ``tests/test_protocol.py`` marks it: all five
  models at ``default_scope`` equal to JAX's, and the full mutation
  sweep — every mutation in ``MUTATIONS`` caught with JAX's rule code by
  a minimized counterexample that replays as a violation under the
  mutation and not on clean code.

Exact equality: the models are deterministic breadth-first searches.
"""

import json
import textwrap

import pytest

from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu.analysis import (
    model_check as jmodel_check,
)
from torch_automatic_distributed_neural_network_tpu.analysis import (
    protocol as jprotocol,
)
from torch_automatic_distributed_neural_network_tpu_torch.analysis import (
    model_check,
    protocol,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli

CHEAP = ("allocator", "scheduler-reserve", "gateway")


def _stats(res):
    return (res.states, res.transitions, res.depth, res.frontier_peak,
            res.complete, len(res.counterexamples))


def _explore(proto, mc, name):
    return mc.explore(proto.build_model(name, proto.default_scope(name)))


@pytest.fixture(scope="module")
def jax_cheap():
    return {name: _explore(jprotocol, jmodel_check, name) for name in CHEAP}


@pytest.mark.parametrize("name", CHEAP)
def test_cheap_model_explores_as_jax(name, jax_cheap):
    assert protocol.default_scope(name) == jprotocol.default_scope(name)
    got = _explore(protocol, model_check, name)
    assert _stats(got) == _stats(jax_cheap[name])
    assert got.complete and not got.counterexamples and got.states > 100


@pytest.mark.parametrize("name", ("sched-evict-skip-release",
                                  "prefix-drop-leak", "gw-ledger-dup",
                                  "alloc-ref-noop"))
def test_jax_counterexample_replays_through_the_port(name, tmp_path):
    cx = jprotocol.run_mutation(name).counterexamples[0]
    path = str(tmp_path / f"{name}.json")
    jmodel_check.save_script(cx, path)
    with protocol.MUTATIONS[name].patch():
        with pytest.raises(model_check.ProtocolViolation) as ei:
            model_check.replay_script(path, protocol.build_model)
    assert ei.value.code == cx.code
    try:  # clean code: passes, or the script no longer applies
        model_check.replay_script(path, protocol.build_model)
    except ValueError:
        pass


def _json_out(main, args, capsys):
    rc = main(args)
    return rc, json.loads(capsys.readouterr().out)


def test_check_protocol_cli_equals_jax(tmp_path, capsys, monkeypatch,
                                       jax_cheap):
    monkeypatch.setattr(protocol, "MODEL_NAMES", ("allocator",))
    rc, out = _json_out(cli, ["check", "--no-source", "--protocol",
                              "--json", "--counterexample-dir",
                              str(tmp_path)], capsys)
    assert rc == 0 and out["findings"] == []
    (rec,) = out["protocol"]
    want = jax_cheap["allocator"]
    assert (rec["states"], rec["transitions"], rec["depth"],
            rec["frontier_peak"], rec["complete"], rec["violations"]) == (
        _stats(want))
    assert rec["scope"] == jprotocol.default_scope("allocator")
    assert list(tmp_path.iterdir()) == []


def test_check_serving_cli_equals_jax(capsys):
    args = ["check", "--no-source", "--serving", "--family", "gpt2",
            "--size", "test"]
    got = _json_out(cli, args + ["--json"], capsys)
    want = _json_out(jcli.main, args + ["--json"], capsys)
    assert got == want and got[0] == 0
    assert got[1]["serve_estimate"]["params_bytes"] > 0
    for extra in (["--serve-streams", "100000", "--serve-tp", "2"],
                  ["--serve-adapters", "4", "--serve-quant-kv",
                   "--serve-prefix-cache", "--serve-prefix-hit-rate",
                   "0.5", "--budget", "1GiB"]):
        rc = cli(args + extra)
        text = capsys.readouterr().out
        assert (rc, text) == (jcli.main(args + extra),
                              capsys.readouterr().out)
    assert rc == 0 and "serve estimate:" in text
    assert cli(["check", "--serving", "--family", "vit"]) == 2


def test_check_source_rules_and_refusals_equal_jax(tmp_path, capsys):
    src = tmp_path / "fixture.py"
    src.write_text(textwrap.dedent("""\
        def f(x=[]):
            try:
                return x
            except:
                pass
        """))
    for extra in ([], ["--strict"], ["--json"], ["--ignore", "SL004"]):
        args = ["check", str(src), *extra]
        rc = cli(args)
        got = capsys.readouterr().out
        assert (rc, got) == (jcli.main(args), capsys.readouterr().out)
    assert cli(["check", str(src)]) == 1
    capsys.readouterr()
    assert cli(["check", "--rules"]) == 0
    rules = capsys.readouterr().out
    assert jcli.main(["check", "--rules"]) == 0
    assert rules == capsys.readouterr().out
    assert cli(["check", "--rules", "--journal"]) == 0
    registry = capsys.readouterr().out
    assert jcli.main(["check", "--rules", "--journal"]) == 0
    assert registry == capsys.readouterr().out
    for flag, port_only, want_out in (
            (["--preflight", str(src)], [], ""),
            (["--memory", "--size", "32,10", "--batch", "64",
              "--no-compiled"], ["--device", "cpu"], "memory estimate"),
            (["--serving", "--family", "gpt2", "--size", "test",
              "--trace-serve"], ["--device", "cpu"], "serve estimate")):
        rc = cli(["check", "--no-source", *flag, *port_only])
        out = capsys.readouterr()
        assert rc == jcli.main(["check", "--no-source", *flag])
        capsys.readouterr()
        if want_out:
            assert rc == 0 and want_out in out.out
        else:
            assert rc == 2 and "does not define tadnn_check()" in out.err


@pytest.mark.slow
def test_all_models_explore_as_jax():
    for name in protocol.MODEL_NAMES:
        got = _explore(protocol, model_check, name)
        want = _explore(jprotocol, jmodel_check, name)
        assert _stats(got) == _stats(want), name
        assert got.complete and not got.counterexamples, name


@pytest.mark.slow
def test_every_mutation_is_caught_with_jax_rule_code(tmp_path):
    assert set(protocol.MUTATIONS) == set(jprotocol.MUTATIONS)
    for name, mut in protocol.MUTATIONS.items():
        res = protocol.run_mutation(name)
        assert res.counterexamples, f"{name} ({mut.note}) not caught"
        cx = res.counterexamples[0]
        want = jprotocol.run_mutation(name).counterexamples[0]
        assert cx.minimized and cx.code == want.code, name
        assert cx.events == want.events, name
        script = str(tmp_path / f"{name}.json")
        model_check.save_script(cx, script)
        with mut.patch():
            with pytest.raises(model_check.ProtocolViolation):
                model_check.replay_script(script, protocol.build_model)
        try:
            model_check.replay_script(script, protocol.build_model)
        except ValueError:
            pass
