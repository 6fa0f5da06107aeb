"""The port's journal event schema (``obs/schema.py``) against the JAX
package's, and its runtime validation (``Journal(validate=True)``,
``TADNN_JOURNAL_VALIDATE``).

The registry is a copy: the same kinds, versions, aliases, required and
optional fields and their types (exact equality).  ``validate_record``
gives the same rule codes on the cases of
``tests/test_journal_contract.py`` (exact).  The port's entry points run
clean under validation on the CPU: ``serve --smoke`` with LoRA tenants
(int8 and fp32 pools, prefix cache on) and the ``finetune_lora``
example.
"""

import json

import pytest

from torch_automatic_distributed_neural_network_tpu.obs import schema as jschema
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    Journal,
    as_default,
    schema,
)


def test_registry_equals_the_jax_registry():
    assert sorted(schema.REGISTRY) == sorted(jschema.REGISTRY)
    assert schema.ALIASES == jschema.ALIASES
    assert schema.BASE_FIELDS == jschema.BASE_FIELDS
    for name, want in jschema.REGISTRY.items():
        got = schema.REGISTRY[name]
        assert (got.name, got.kind, got.version, got.open) == (
            want.name, want.kind, want.version, want.open), name
        assert got.required == want.required, name
        assert got.optional == want.optional, name
    for alias in jschema.ALIASES:
        assert schema.canonical(alias) == jschema.canonical(alias)
        assert set(schema.names_for(schema.canonical(alias))) == set(
            jschema.names_for(jschema.canonical(alias)))
    assert schema.registry_markdown() == jschema.registry_markdown()


def _rec(name, **fields):
    return {"kind": "event", "name": name, "t": 0.0, "wall": 0.0,
            "depth": 0, **fields}


def _prefix_kind(kind):
    rec = _rec("serve.prefix", rid=1, n_blocks=2)
    rec["kind"] = kind
    return rec


# (record, expected codes): the cases of tests/test_journal_contract.py
CASES = {
    "clean": (_rec("serve.preempt", rid=3, n_regenerate=2), []),
    "jl001_unknown_kind": (_rec("serve.bogus"), ["JL001"]),
    "jl002_missing_required": (_rec("serve.preempt", rid=3), ["JL002"]),
    "jl003_type": (_rec("serve.preempt", rid="three", n_regenerate=2),
                   ["JL003"]),
    "jl004_undeclared": (_rec("serve.preempt", rid=3, n_regenerate=2,
                              slot=1), ["JL004"]),
    "open_schema_extras": (_rec("tune.decision", key="k", source="measured",
                                anything_else={"deep": 1}), []),
    "jl007_alias": (_rec("serve.request", rid=1, n_prompt=1, n_new=1,
                         queue_s=0.0, total_s=0.1, tokens_per_s=10.0,
                         preempted=0, ttft_s=0.05, itl_s=[]), ["JL007"]),
    "kind_payload": (_prefix_kind("publish"), []),
    "kind_payload_type": (_prefix_kind(7), ["JL003"]),
    "adapter_stall": (_rec("serve.adapter", kind="stall", rid=4,
                           adapter="tenant1"), []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validate_record_gives_the_jax_codes(case):
    rec, want = CASES[case]
    got = [c for c, _ in schema.validate_record(rec)]
    assert got == [c for c, _ in jschema.validate_record(rec)] == want


def test_check_value_matches_jax():
    for value, spec in ((3, "float"), ("3", "float"), (None, "str?"),
                        (None, "str"), ([1], "list"), ({}, "dict"),
                        (True, "int"), (2, "number"), (object(), "any")):
        assert schema.check_value(value, spec) == jschema.check_value(
            value, spec), (value, spec)
    with pytest.raises(ValueError):
        schema.check_value(1, "complex128")


def test_validate_true_raises_at_the_emitting_site():
    j = Journal(None, host0_only=False, validate=True)
    j.event("serve.preempt", rid=1, n_regenerate=2)
    with pytest.raises(schema.JournalContractError, match="JL002"):
        j.event("serve.preempt", rid=1)
    with pytest.raises(schema.JournalContractError, match="JL001"):
        with j.span("no.such.span"):
            pass
    assert issubclass(schema.JournalContractError, ValueError)
    # the bad records were not written
    assert [r["name"] for r in j.records] == ["journal.start",
                                              "serve.preempt"]


def test_environment_gate_and_default_off(monkeypatch):
    monkeypatch.delenv("TADNN_JOURNAL_VALIDATE", raising=False)
    j = Journal(None, host0_only=False)
    assert not j.validate
    j.event("serve.bogus")  # off by default: written as is
    for value, on in (("1", True), ("0", False), ("", False),
                      (" 1 ", True)):
        monkeypatch.setenv("TADNN_JOURNAL_VALIDATE", value)
        assert Journal(None, host0_only=False).validate is on, value
    monkeypatch.setenv("TADNN_JOURNAL_VALIDATE", "1")
    with pytest.raises(schema.JournalContractError):
        Journal(None, host0_only=False).event("serve.bogus")
    # an explicit argument wins over the environment
    assert not Journal(None, host0_only=False, validate=False).validate


@pytest.mark.parametrize("flags", [
    ["--adapters", "3", "--quant-adapters"],
    ["--adapters", "2", "--adapter-rank", "4", "--prefix-cache",
     "--shared-prefix", "8"],
])
def test_serve_smoke_with_adapters_validates(flags, monkeypatch, capsys,
                                             tmp_path):
    from torch_automatic_distributed_neural_network_tpu_torch.cli import main

    monkeypatch.setenv("TADNN_JOURNAL_VALIDATE", "1")
    path = tmp_path / "serve.jsonl"
    assert main(["serve", "--smoke", "--device", "cpu", "--journal",
                 str(path), *flags]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["adapters"] == int(flags[1])
    assert summary["n_requests"] == 8
    assert 0.0 <= summary["adapter_hit_rate"] <= 1.0
    records = [json.loads(line) for line in path.read_text().splitlines()]
    names = {r["name"] for r in records}
    assert {"serve.adapter", "serve.step", "serve.request_done"} <= names
    steps = [r for r in records if r["name"] == "serve.step"]
    assert all("adapters_resident" in r and "adapters_pinned" in r
               for r in steps)
    assert steps[-1]["adapters_pinned"] == 0
    for rec in records:  # the JAX registry reads them too
        assert jschema.validate_record(rec) == [], rec


def test_finetune_lora_example_validates(monkeypatch, capsys):
    from torch_automatic_distributed_neural_network_tpu_torch.examples import (
        finetune_lora,
    )

    monkeypatch.setenv("TADNN_JOURNAL_VALIDATE", "1")
    j = Journal(None, host0_only=False)
    assert j.validate
    with as_default(j):
        out = finetune_lora.main(["run.device=cpu", "run.pretrain_steps=2",
                                  "run.steps=3", "run.batch_size=4",
                                  "model.seq_len=32"])
    assert {"plan", "comms.estimate"} <= {r["name"] for r in j.records}
    # Adam's two moments, for the factors only
    assert out["n_opt"] == 2 * out["n_lora"]
    assert out["n_lora"] < 0.1 * out["n_base"]
    assert "adapters merged back" in capsys.readouterr().out
