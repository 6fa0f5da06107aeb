"""The port's plan, graph and dtype lints against the JAX package's
(``analysis/{plan,graph,dtype}_lint.py``, ``analysis/serve_trace.py``,
``analysis.preflight`` and ``tadnn check --preflight / --trace-serve``),
on the CPU.

- **Plan lint**: the same specs and degrees (JAX's
  ``tests/test_analysis.py`` cases) give the same findings — codes,
  paths and messages, the spec's repr aside (``PartitionSpec(..)`` in
  JAX, ``P(..)`` in the port).
- **Graph and dtype lint**: each of JAX's seeded faults gets its torch
  counterpart in a step traced on fake tensors (``make_fx``) and the
  same code: GL001 a host sync (``.item()``) where JAX has a debug
  print, GL003 a captured 0-dim tensor where JAX has a weak-typed
  capture (torch has no weak bit, so JAX's strongly-typed capture has
  no silent counterpart; a tensor the step makes itself stays silent),
  GL004 the same unhashable static argument, DT001 / DT002 / DT004 the
  same casts, products and trees.  GL002's hidden all-gather and DT003
  run on 2 gloo ranks (``tests/test_torch_port_search.py``'s spawn).
  A clean GPT-2 ``test`` step gives no finding in either package.
- **Kernel nodes**: a traced GPT-2 ``test`` step (flash attention, the
  layers' remat) holds K1 twice a layer and K2, K3 once, as the CUDA
  step launches them; a traced decode step K4 once a layer; the ops'
  fake outputs have the plain versions' shapes and dtypes (exact).
- The Trainer preflight as JAX's ``TestTrainerPreflight``; the CLI's
  ``--preflight FILE`` with a seeded PL001 exits 1 as JAX's does, and
  ``--trace-serve`` flags a seeded ``.item()`` in the decode step.
"""

import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_automatic_distributed_neural_network_tpu as tad
from torch_automatic_distributed_neural_network_tpu import analysis as janalysis
from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu.analysis import (
    dtype_lint as jdtype_lint,
    graph_lint as jgraph_lint,
    plan_lint as jplan_lint,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.training import (
    next_token_loss as jnext_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch import (
    GPT2,
    MLP,
    AutoDistribute,
    adamw,
    next_token_loss,
    sgd,
    softmax_xent_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch import analysis
from torch_automatic_distributed_neural_network_tpu_torch.analysis import (
    dtype_lint,
    graph_lint,
    plan_lint,
    serve_trace,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve \
    import engine as engine_mod
from torch_automatic_distributed_neural_network_tpu_torch.obs import Journal
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    journal as obs_journal,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops import (
    flash_attention as fa,
    paged_attention as pa,
)
from torch_automatic_distributed_neural_network_tpu_torch.planner import P
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    Trainer,
    TrainerConfig,
)


def codes(findings):
    return [f.code for f in findings]


def sds(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _norm(findings):
    """(code, severity, where, msg) with the spec's repr made the
    port's."""
    return [(f.code, f.severity, f.where,
             f.msg.replace("PartitionSpec(", "P(")) for f in findings]


# ---------------------------------------------------------------------------
# plan lint: the same findings as JAX's
# ---------------------------------------------------------------------------

DEG8 = {"data": 1, "fsdp": 8, "tensor": 1}

# (specs, batch spec, degrees, strategy, shapes, big_leaf_bytes): JAX's
# tests/test_analysis.py TestPlanLint cases
PLAN_CASES = {
    "pl001_divisibility": ({"w": ("fsdp", None)}, ("fsdp",), DEG8, "fsdp",
                           {"w": (12, 4)}, None),
    "pl001_too_many_dims": ({"b": (None, "fsdp")}, ("fsdp",), DEG8, "fsdp",
                            {"b": (16,)}, None),
    "pl002_duplicate": ({"w": ("fsdp", "fsdp")}, ("fsdp",), DEG8, "fsdp",
                        {"w": (16, 8)}, None),
    "pl003_unknown": ({"w": ("tensor", None)}, ("data",), {"data": 8}, "tp",
                      None, None),
    "pl004_dead_axis": ({"w": (None, None)}, ("data",),
                        {"data": 4, "tensor": 2}, "dp", None, None),
    "seq_not_dead": ({"w": (None,)}, ("data",), {"data": 4, "seq": 2}, "dp",
                     None, None),
    "pl005_big_leaf": ({"emb": (None, None), "w": ("fsdp", None)}, ("fsdp",),
                       DEG8, "fsdp", {"emb": (512, 128), "w": (16, 4)}, 1024),
    "dp_no_pl005": ({"emb": (None, None)}, ("data",), {"data": 8}, "dp",
                    {"emb": (512, 128)}, 1024),
    "pl005_table_default": ({"emb": (None, None), "w": ("fsdp", None)},
                            ("fsdp",), DEG8, "fsdp",
                            {"emb": (512, 128), "w": (16, 4)}, None),
    "nested_tree": ({"dense": {"kernel": ("fsdp", None), "bias": (None,)}},
                    ("fsdp",), DEG8, "fsdp",
                    {"dense": {"kernel": (12, 4), "bias": (4,)}}, None),
}


def _tree(fn, t):
    if isinstance(t, dict):
        return {k: _tree(fn, v) for k, v in t.items()}
    return fn(t)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_lint_findings_equal_jax(case):
    specs, bspec, degrees, strategy, shapes, big = PLAN_CASES[case]
    kw = {} if big is None else {"big_leaf_bytes": big}
    want = jplan_lint.lint_specs(
        _tree(lambda s: JP(*s), specs), JP(*bspec), degrees, strategy,
        None if shapes is None else _tree(lambda s: sds(*s), shapes), **kw)
    got = plan_lint.lint_specs(
        _tree(lambda s: P(*s), specs), P(*bspec), degrees, strategy,
        None if shapes is None else _tree(lambda s: meta(*s), shapes), **kw)
    assert _norm(got) == _norm(want)
    assert all(f.layer == "plan" for f in got)


def test_planner_output_is_clean_as_jax():
    from torch_automatic_distributed_neural_network_tpu import planner as jp
    from torch_automatic_distributed_neural_network_tpu import topology as jt
    from torch_automatic_distributed_neural_network_tpu_torch import planner

    jabs = {"dense": {"kernel": sds(64, 32), "bias": sds(32)},
            "out": {"kernel": sds(32, 16), "bias": sds(16)}}
    jplan = jp.make_plan(jabs, mesh=jt.build_mesh(fsdp=8), strategy="fsdp")
    assert jplan_lint.lint_plan(jplan, jabs) == []
    pabs = {"dense.weight": meta(32, 64), "dense.bias": meta(32),
            "out.weight": meta(16, 32), "out.bias": meta(16)}
    plan = planner.make_plan(pabs, mesh={"fsdp": 8}, strategy="fsdp")
    assert plan_lint.lint_plan(plan, pabs) == []


# ---------------------------------------------------------------------------
# graph lint: seeded faults, one code each
# ---------------------------------------------------------------------------


def test_host_sync_is_gl001_as_debug_print_in_jax():
    def jstep(x):
        jax.debug.print("loss={x}", x=x.sum())
        return x * 2

    def step(x):
        print(f"loss={x.sum().item()}")
        return x * 2

    want = jgraph_lint.lint_hazards(jgraph_lint.trace_step(jstep, sds(4)))
    got = graph_lint.lint_hazards(graph_lint.trace_step(step, torch.ones(4)))
    assert codes(got) == codes(want) == ["GL001"]
    assert "_local_scalar_dense" in got[0].where
    # the data-dependent value never ends the trace: the step after the
    # sync is traced too
    gm = graph_lint.trace_step(step, torch.ones(4))
    assert any(graph_lint.op_name(n) == "mul"
               for n in graph_lint.iter_eqns(gm))


def test_captured_scalar_is_gl003():
    jscale = jnp.asarray(2.0)  # weak-typed closure capture
    want = jgraph_lint.lint_hazards(
        jgraph_lint.trace_step(lambda x: x * jscale, sds(4)))
    scale = torch.tensor(2.0)  # a 0-dim tensor captured at trace time
    got = graph_lint.lint_hazards(
        graph_lint.trace_step(lambda x: x * scale, torch.ones(4)))
    assert codes(got) == codes(want) == ["GL003"]
    assert got[0].msg == want[0].msg and got[0].where == "<const 2.0>"
    # made inside the step (a lifted constant) or a Python literal: silent
    assert graph_lint.lint_hazards(graph_lint.trace_step(
        lambda x: x * torch.tensor(2.0), torch.ones(4))) == []
    assert graph_lint.lint_hazards(graph_lint.trace_step(
        lambda x: x * 2.0, torch.ones(4))) == []


def test_unhashable_static_arg_is_gl004_as_jax():
    args = {"cfg": {"lr": 0.1}, "n": 4, "dims": (1, 2)}
    got = graph_lint.lint_static_args(args)
    assert _norm(got) == _norm(jgraph_lint.lint_static_args(args))
    assert codes(got) == ["GL004"] and got[0].severity == analysis.ERROR


# ---------------------------------------------------------------------------
# dtype lint
# ---------------------------------------------------------------------------


def test_scalar_downcast_is_dt001():
    want = jdtype_lint.lint_dtypes(jax.make_jaxpr(
        lambda x: jnp.sum(x * x).astype(jnp.bfloat16))(jnp.ones((8, 4))))
    got = dtype_lint.lint_dtypes(graph_lint.trace_step(
        lambda x: (x * x).sum().to(torch.bfloat16), torch.ones(8, 4)))
    assert codes(got) == codes(want) == ["DT001"]
    assert got[0].msg == want[0].msg


def test_reduction_downcast_is_dt001_unless_compute_dtype():
    jclosed = jax.make_jaxpr(lambda a, b: (a @ b).astype(jnp.bfloat16))(
        jnp.ones((8, 4)), jnp.ones((4, 8)))
    gm = graph_lint.trace_step(lambda a, b: (a @ b).to(torch.bfloat16),
                               torch.ones(8, 4), torch.ones(4, 8))
    assert codes(dtype_lint.lint_dtypes(gm)) == codes(
        jdtype_lint.lint_dtypes(jclosed)) == ["DT001"]
    assert codes(dtype_lint.lint_dtypes(
        gm, compute_dtype=torch.bfloat16)) == codes(jdtype_lint.lint_dtypes(
            jclosed, compute_dtype=jnp.bfloat16)) == []


def test_f16_matmul_is_dt002_bf16_exempt():
    for jdt, dt, want in ((jnp.float16, torch.float16, ["DT002"]),
                          (jnp.bfloat16, torch.bfloat16, [])):
        h = jnp.ones((8, 8), jdt)
        jfs = jdtype_lint.lint_dtypes(jax.make_jaxpr(lambda a, b: a @ b)(h, h))
        t = torch.ones(8, 8, dtype=dt)
        fs = dtype_lint.lint_dtypes(graph_lint.trace_step(
            lambda a, b: a @ b, t, t))
        assert codes(fs) == codes(jfs) == want


def test_mixed_param_dtypes_is_dt004():
    jfs = jdtype_lint.lint_param_dtypes({
        "a": sds(4, 4), "b": sds(4, 4),
        "head": sds(4, 2, dtype=jnp.bfloat16)})
    fs = dtype_lint.lint_param_dtypes({
        "a": meta(4, 4), "b": meta(4, 4),
        "head": meta(4, 2, dtype=torch.bfloat16)})
    # JAX names the leaf by its key path (``['head']``), the port by the
    # parameter's name
    assert _norm(fs) == [(c, sev, w.replace("['head']", "head"),
                          m.replace("['head']", "head"))
                         for c, sev, w, m in _norm(jfs)]
    assert codes(fs) == ["DT004"]
    assert dtype_lint.lint_param_dtypes({"a": meta(4, 4)}) == []


# ---------------------------------------------------------------------------
# the traced step: clean, and its kernel nodes
# ---------------------------------------------------------------------------


def test_clean_gpt2_step_has_no_finding_in_either_package():
    """``analysis.preflight`` on GPT-2 ``test`` (dp, one device) at a 16
    GiB budget: no finding in JAX's and none in the port's."""
    jsample = {"tokens": np.zeros((4, 33), np.int32)}
    jad = tad.AutoDistribute(
        JGPT2("test", vocab_size=256, max_seq_len=32),
        optimizer=optax.adamw(1e-3), loss_fn=jnext_token_loss,
        strategy="dp", devices=jax.devices()[:1])
    jad.init(jax.random.key(0), jsample)
    with obs_journal.as_default(Journal()):
        want = janalysis.preflight(jad, jsample, budget="16GiB")
    ad = AutoDistribute(GPT2("test", vocab_size=256, max_seq_len=32),
                        optimizer=adamw(1e-3), loss_fn=next_token_loss,
                        strategy="dp", device="cpu")
    ad.init(torch.Generator().manual_seed(0), jsample)
    j = Journal()
    with obs_journal.as_default(j):
        got = analysis.preflight(ad, jsample, budget="16GiB")
    assert got == [] and want == []
    assert not j.named("lint.skipped")
    (est,) = j.named("lint.mem_estimate")
    assert est["phase"] == "preflight" and est["budget_bytes"] == 16 * 2**30


def test_traced_step_holds_the_kernels_as_launched():
    """K1 twice a layer (the layers' remat recomputes it), K2 and K3
    once, both in the trace and in the step the dispatcher runs (the
    plain versions on the CPU, counted by a dispatch mode)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if name.startswith("tadnn."):
                self.n[name.split(".")[1]] = self.n.get(
                    name.split(".")[1], 0) + 1
            return func(*args, **(kwargs or {}))

    model = GPT2("test", vocab_size=256, max_seq_len=32,
                 attention_impl="flash", dtype=torch.float32)
    ad = AutoDistribute(model, optimizer=adamw(1e-3),
                        loss_fn=next_token_loss, device="cpu")
    batch = {"tokens": np.random.RandomState(0).randint(
        0, 256, (2, 33)).astype(np.int32)}
    state = ad.init(torch.Generator().manual_seed(0), batch)
    gm = graph_lint.trace_step(ad.traceable_step(),
                               *ad.abstract_state(batch), torch.Generator())
    L = model.cfg.n_layers
    want = {"flash_forward": 2 * L, "flash_dkv": L, "flash_dq": L}
    assert graph_lint.kernel_nodes(gm) == want
    counter = Count()
    with counter:
        ad.step(state, batch)
    assert counter.n == want
    # the CPU path counts no launch
    assert fa.flash_forward.launches == 0


def test_decode_trace_holds_k4_once_a_layer():
    model = GPT2("test", vocab_size=256, max_seq_len=64)
    fs, stats = serve_trace.serve_trace_check(model, device="cpu")
    assert fs == []
    assert stats["decode"]["kernels"] == {
        "paged_attention": model.cfg.n_layers}
    assert stats["prefill"]["eqns"] > 0


def test_direct_launch_only_for_plain_cuda_tensors_outside_modes():
    """The wrappers skip the dispatcher only for plain CUDA tensors with
    no dispatch mode active: a CPU tensor, a fake tensor, a meta tensor
    and any tensor under a dispatch mode (the fake run, the FLOP
    counter) go through the op (the CUDA case runs in
    ``tests/test_torch_port_cuda.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from torch_automatic_distributed_neural_network_tpu_torch.utils import (
        profiling,
    )

    cpu = torch.zeros(2)
    assert not fa.direct_launch(cpu)
    assert not fa.direct_launch(torch.empty(2, device="meta"))
    with FakeTensorMode():
        fake = torch.empty(2)
        assert not fa.direct_launch(fake)
    assert not fa.direct_launch(fake)
    with profiling.Flops():
        assert not fa.direct_launch(cpu)
    # under the FLOP counter the op is taken: K1's formula counts it
    q = torch.zeros(1, 16, 2, 32)
    with profiling.Flops() as flops:
        fa.flash_forward(q, q, q)
    assert flops.total == 2 * 2 * 1 * 2 * 16 * 16 * 32


def test_fake_outputs_match_the_plain_versions():
    """Each op's fake output against its plain version's real one: the
    same shapes and dtypes (exact), K1-K3 in fp32 and bf16, K4 dense and
    int8."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rs = np.random.RandomState(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)

    def sig(x):
        return [(tuple(y.shape), y.dtype) for y in (
            x if isinstance(x, (tuple, list)) else (x,))]

    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (t(2, 64, 2, 32, dtype=dt) for _ in range(4))
        lse = t(2, 2, 64)
        delta = t(2, 2, 64)
        calls = {
            "flash_forward": lambda *a: fa.flash_forward(*a[:3],
                                                         causal=True),
            "flash_dkv": lambda *a: fa.flash_dkv(*a, causal=True),
            "flash_dq": lambda *a: fa.flash_dq(*a, causal=True),
        }
        for name, call in calls.items():
            args = (q, k, v) if name == "flash_forward" else (
                q, k, v, do, lse, delta)
            real = call(*args)
            mode = FakeTensorMode()
            with mode:
                fake = call(*(mode.from_tensor(a) for a in args))
            assert sig(fake) == sig(real), (name, dt)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    ctx = torch.tensor([9, 3], dtype=torch.int32)
    q = t(2, 4, 32)
    for pool in ({"q": torch.from_numpy(rs.randint(
                    -127, 127, (4, 8, 2, 32)).astype(np.int8)),
                  "scale": t(4, 8, 2, 1).abs()},
                 t(4, 8, 2, 32)):
        real = pa.paged_attention(q, pool, pool, tables, ctx)
        mode = FakeTensorMode()
        with mode:
            f = (lambda x: {k: mode.from_tensor(v) for k, v in x.items()}
                 if isinstance(x, dict) else mode.from_tensor(x))
            fake = pa.paged_attention(mode.from_tensor(q), f(pool), f(pool),
                                      mode.from_tensor(tables),
                                      mode.from_tensor(ctx))
        assert sig(fake) == sig(real)


# ---------------------------------------------------------------------------
# the Trainer preflight (JAX's TestTrainerPreflight)
# ---------------------------------------------------------------------------


def _toy_batches(steps):
    for seed in range(steps):
        rs = np.random.RandomState(seed)
        yield {"x": rs.randn(16, 8).astype(np.float32),
               "label": rs.randint(0, 10, size=(16,)).astype(np.int32)}


def _fit(cfg, journal):
    ad = AutoDistribute(MLP(features=(16, 10), in_features=8),
                        optimizer=sgd(0.1), loss_fn=softmax_xent_loss,
                        strategy="fsdp", device="cpu")
    Trainer(ad, cfg, journal=journal).fit(_toy_batches(cfg.steps))
    return journal


class TestTrainerPreflight:
    def test_preflight_journals_lint_events(self):
        j = _fit(TrainerConfig(steps=2, preflight=True), Journal())
        summaries = j.named("lint.summary")
        assert summaries and summaries[0]["phase"] == "preflight"
        assert summaries[0]["errors"] == 0

    def test_preflight_off_is_silent(self):
        j = _fit(TrainerConfig(steps=2, preflight=False), Journal())
        assert j.named("lint") == []

    def test_preflight_raise_action(self, monkeypatch):
        bad = analysis.Finding("PL001", analysis.ERROR, "plan", "w",
                               "seeded")
        monkeypatch.setattr(analysis, "preflight",
                            lambda ad, batch, rng=None, **kw: [bad])
        with pytest.raises(analysis.PreflightError) as ei:
            _fit(TrainerConfig(steps=2, preflight=True,
                               preflight_action="raise"), Journal())
        assert "PL001" in str(ei.value)

    def test_analyzer_crash_never_blocks_training(self, monkeypatch):
        def boom(ad, batch, rng=None, **kw):
            raise RuntimeError("analyzer bug")

        monkeypatch.setattr(analysis, "preflight", boom)
        j = _fit(TrainerConfig(steps=2, preflight=True), Journal())
        skipped = j.named("lint.skipped")
        assert skipped and "analyzer bug" in skipped[0]["error"]
        assert j.named("run_end")[0]["stop_step"] == 2

    def test_preflight_report_rendering(self, tmp_path):
        from torch_automatic_distributed_neural_network_tpu_torch.obs import (
            report as obs_report,
        )

        jpath = tmp_path / "journal.jsonl"
        with Journal(str(jpath)) as j:
            with obs_journal.as_default(j):
                analysis.journal_findings(
                    [analysis.Finding("GL002", analysis.WARN, "graph",
                                      "<all_gather over data>", "seeded")],
                    phase="preflight")
        rep = obs_report.generate(str(jpath))
        assert rep["lint"]["warnings"] == 1
        assert rep["lint"]["findings"][0]["code"] == "GL002"
        text = obs_report.format_report(rep)
        assert "lint (preflight): 0 error(s), 1 warning(s)" in text


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_check_preflight_file_seeded_pl001_exits_1_as_jax(tmp_path, capsys):
    jspec = tmp_path / "jax_spec.py"
    jspec.write_text(textwrap.dedent("""
        import jax
        from jax.sharding import PartitionSpec as P

        def tadnn_check():
            return {"param_specs": {"w": P("fsdp", None)},
                    "batch_spec": P("fsdp"), "degrees": {"fsdp": 8},
                    "strategy": "fsdp",
                    "abstract_params": {
                        "w": jax.ShapeDtypeStruct((12, 4), "float32")}}
    """))
    spec = tmp_path / "port_spec.py"
    spec.write_text(textwrap.dedent("""
        import torch
        from torch_automatic_distributed_neural_network_tpu_torch.planner \\
            import P

        def tadnn_check():
            return {"param_specs": {"w": P("fsdp", None)},
                    "batch_spec": P("fsdp"), "degrees": {"fsdp": 8},
                    "strategy": "fsdp",
                    "abstract_params": {
                        "w": torch.empty(12, 4, device="meta")},
                    "fn": lambda x: (x * 2).sum(),
                    "args": (torch.ones(4),)}
    """))
    assert jcli.main(["check", "--no-source", "--preflight",
                      str(jspec)]) == 1
    want = capsys.readouterr().out
    assert cli(["check", "--no-source", "--preflight", str(spec)]) == 1
    got = capsys.readouterr().out
    assert "PL001" in got and "PL001" in want
    assert cli(["check", "--no-source", "--json", "--preflight",
                str(spec)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["code"] for f in out["findings"]] == ["PL001"]


def test_trace_serve_flags_an_item_in_the_decode_step(monkeypatch, capsys):
    args = ["check", "--no-source", "--serving", "--family", "gpt2",
            "--size", "test", "--trace-serve", "--device", "cpu"]
    assert cli([*args, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == []
    assert out["serve_trace"]["decode"]["kernels"] == {"paged_attention": 2}
    step = engine_mod._paged_decode_step

    def syncing(*a, **k):
        out = step(*a, **k)
        int(out.sum().item())  # a stray host sync in the sampled path
        return out

    monkeypatch.setattr(engine_mod, "_paged_decode_step", syncing)
    assert cli([*args, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [(f["code"], f["where"]) for f in out["findings"]] == [
        ("GL001", "serve:decode:<_local_scalar_dense>")]
    assert cli([*args, "--strict"]) == 1
    assert "GL001" in capsys.readouterr().out
