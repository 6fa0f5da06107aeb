"""The export cache of the PyTorch port (``export/``) against the JAX
package's (``tests/test_export.py``), and the ``AutoDistribute`` hooks it
builds on: ``export_step``, ``compiled_step_text``, ``state_shardings``.

The port's cold start compiles no program: it builds its kernels with
``nvcc``, so an entry holds the kernel libraries a kind launches on the
card (none on the CPU).  The cases are JAX's, held to the event
sequences JAX journals in the same scenarios: a cold start journals
``export.miss`` then ``export.store``, a warm one only ``export.hit``,
with losses and parameters bitwise equal; stale versions, torn and
missing payloads journal ``export.stale`` and rebuild; keys separate
across plans, batches, topologies and kinds; compaction, ``gc`` and the
hit's ``touch``; ``tadnn export --json``, ``--serve``, ``--verify``,
``--gc`` and ``--worlds``; the cost memo.  A test that needs a library
uses a stand-in file (``stand_in``: ``ops.build.build`` replaced by a
writer of fixed bytes, the build directory a temporary one), since
building and loading a real one is the card's job (``chip_smoke.py``'s
phase ``export``).  JAX's ``test_serve_cold_warm_token_parity`` is red
on the reference, so the serving test holds the port's tokens to its own
cold run (identical tokens), not to JAX's.

On 2 gloo ranks (one spawn of ``tests/torch_port_dist_worker.py``): the
keys ``tadnn export --worlds 2`` and the launcher's ``--prewarm`` store
are the ones a real 2-rank run looks up (``export.hit``);
``hlo_collective_bytes(compiled_step_text(..))`` equals
``graph_lint``'s collective inventory of the same trace under fsdp, per
family, exactly; ``state_shardings`` gives the placements of the tensors
``init`` makes under fsdp, tp and ZeRO-1.  ``plan_blob`` (but its spec
digest, which hashes the port's parameter names) and
``opt_state_spec_tree`` (by name: the mesh axes and the first shard's
elements) equal JAX's.  The launcher's background prewarm stores its
world's entry.
"""

import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import planner as jplanner
from torch_automatic_distributed_neural_network_tpu.export import (
    cache as jexport_cache,
)
from torch_automatic_distributed_neural_network_tpu.models import GPT2 as JGPT2
from torch_automatic_distributed_neural_network_tpu.training import (
    optim as joptim,
)
import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch import (
    MLP,
    AutoDistribute,
    planner,
    sgd,
    softmax_xent_loss,
    topology,
)
from torch_automatic_distributed_neural_network_tpu_torch.cli import main as cli
from torch_automatic_distributed_neural_network_tpu_torch.export import (
    ExecutableCache,
    executable_key,
    plan_blob,
)
from torch_automatic_distributed_neural_network_tpu_torch.export import (
    aot as export_aot,
)
from torch_automatic_distributed_neural_network_tpu_torch.export import (
    cache as export_cache_mod,
)
from torch_automatic_distributed_neural_network_tpu_torch.interop import (
    jax_param_path,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    DecoderLM,
    gpt2_config,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import (
    journal as obs_journal,
)
from torch_automatic_distributed_neural_network_tpu_torch.ops import build
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    adamw,
    launch,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    optim as optim_mod,
)
from torch_automatic_distributed_neural_network_tpu_torch.tune import (
    cache as tune_cache,
)

from torch_port_spawn import spawn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_env_cache(monkeypatch):
    monkeypatch.delenv("TADNN_EXPORT_CACHE", raising=False)


def toy_batch(seed=0, batch=16, dim=8):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(batch, dim).astype(np.float32),
            "label": rs.randint(0, 10, size=(batch,))}


def make_ad(cache=None, strategy="auto", **kw):
    return AutoDistribute(MLP(features=(32, 16, 10), in_features=8),
                          optimizer=sgd(0.1), loss_fn=softmax_xent_loss,
                          strategy=strategy, export_cache=cache,
                          device="cpu", **kw)


def train_run(cache, n_steps=3, strategy="auto"):
    """One fresh AutoDistribute trained n_steps against the cache.
    Returns (losses, final_params, journal_records, ad)."""
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        ad = make_ad(cache=cache, strategy=strategy)
        state = ad.init(torch.Generator().manual_seed(0), toy_batch())
        losses = []
        for i in range(n_steps):
            state, metrics = ad.step(state, toy_batch(seed=i))
            losses.append(float(metrics["loss"]))
    params = {n: p.detach().clone() for n, p in state.params.items()}
    return losses, params, j.records, ad


def names(records, prefix="export."):
    return [r["name"] for r in records if r["name"].startswith(prefix)]


class StandIn:
    """``ops.build.build`` replaced by a writer of fixed bytes: records
    each call's names and whether it was forced."""

    def __init__(self, root):
        self.root = root
        self.calls = []

    def __call__(self, names, *, ptxas_verbose=False, force=False):
        self.calls.append((list(names), force))
        for name in names:
            path = build.library_path(name)
            if force or not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_bytes(f"stand-in {name}".encode() * 64)
        return {name: "" for name in names}


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """A temporary build directory, the stand-in build, and the step's
    kernel sources as on the card (K4's source, for a short payload)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    fake = StandIn(tmp_path / "build")
    monkeypatch.setattr(build, "build", fake)
    monkeypatch.setattr(AutoDistribute, "_export_libraries",
                        lambda self: ["paged_attention"])
    monkeypatch.setattr(export_aot, "_rebuilt", set())
    return fake


# -- train step: cold/warm parity, no build on a warm start --------------------


def test_train_cold_warm_bitwise_parity_and_no_build(tmp_path, stand_in):
    cache = str(tmp_path / "exe")
    cold_losses, cold_params, cold_rec, cold_ad = train_run(cache)
    assert names(cold_rec)[:2] == ["export.miss", "export.store"]
    assert cold_ad._export_info["source"] == "compile"
    assert stand_in.calls == [(["paged_attention"], False)]
    compiles = [r for r in cold_rec if r["name"] == "compile"]
    assert [r["fn"] for r in compiles] == ["train_step"]
    lib = build.library_path("paged_attention")
    built = lib.read_bytes()
    lib.unlink()  # a fresh process's empty build directory

    warm_losses, warm_params, warm_rec, warm_ad = train_run(cache)
    assert names(warm_rec) == ["export.hit"]
    # the acceptance bar: a warm start builds nothing (on the card: no
    # nvcc) and journals no compile; the library is back, byte for byte
    assert stand_in.calls == [(["paged_attention"], False)]
    assert not [r for r in warm_rec if r["name"] == "compile"]
    assert lib.read_bytes() == built
    assert cold_losses == warm_losses
    for n, p in cold_params.items():
        assert torch.equal(p, warm_params[n]), n
    hit = next(r for r in warm_rec if r["name"] == "export.hit")
    store = next(r for r in cold_rec if r["name"] == "export.store")
    # deserialize_s < compile_s is the card's gate (an nvcc build against
    # a copy); the stand-in build here takes microseconds
    assert hit["payload_bytes"] == store["payload_bytes"]
    assert warm_ad._export_info["key"] == cold_ad._export_info["key"]


def test_export_step_prewarms_a_fresh_autodistribute(tmp_path, stand_in):
    cache = str(tmp_path / "exe")
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        info = make_ad().export_step(None, toy_batch(), cache=cache)
    assert info["source"] == "compile"
    exe = ExecutableCache(cache)
    files = exe.payload_files(exe.lookup(info["key"]))
    assert len(files) == 1
    assert os.path.isfile(os.path.join(cache, files[0]))
    build.library_path("paged_attention").unlink()  # a fresh process
    _, _, warm_rec, warm_ad = train_run(cache)
    assert names(warm_rec) == ["export.hit"]
    assert warm_ad._export_info["key"] == info["key"]


def test_export_disabled_by_default_and_off_spec(tmp_path, monkeypatch):
    _, _, rec, ad = train_run(cache=None)
    assert not names(rec)  # opt-in: no cache spec, no env -> no events
    assert ad._export_info is None
    with pytest.raises(ValueError, match="disabled"):
        make_ad(cache=False).export_step(None, toy_batch(), cache=False)
    monkeypatch.setenv("TADNN_EXPORT_CACHE", str(tmp_path / "env"))
    _, _, rec, ad = train_run(cache=False)  # False wins over the env
    assert not names(rec) and ad._export_info is None
    _, _, rec, _ = train_run(cache=None)  # None defers to the env
    assert names(rec) == ["export.miss", "export.store"]


# -- key separation -----------------------------------------------------------


def test_keys_separate_across_plans_and_batches(tmp_path):
    cache = str(tmp_path / "exe")
    a = make_ad(cache=cache, strategy="dp")
    a.init(torch.Generator().manual_seed(0), toy_batch())
    b = make_ad(cache=cache, strategy="fsdp")
    b.init(torch.Generator().manual_seed(0), toy_batch())
    assert a._export_info["key"] != b._export_info["key"]
    # same plan, different batch shape -> a different entry
    c = make_ad(cache=cache, strategy="dp")
    c.init(torch.Generator().manual_seed(0), toy_batch(batch=8))
    assert c._export_info["key"] != a._export_info["key"]
    # tags fold into the key
    d = make_ad(cache=cache, strategy="dp", export_tags={"epoch": 2})
    d.init(torch.Generator().manual_seed(0), toy_batch())
    assert d._export_info["key"] != a._export_info["key"]
    assert len(ExecutableCache(cache).entries()) == 4


def test_keys_separate_across_topologies_as_jax():
    topo_a = {"num_devices": 8, "num_hosts": 1, "platform": "gpu",
              "device_kind": "NVIDIA H100 80GB HBM3", "num_slices": 1}
    topo_b = dict(topo_a, num_hosts=2)
    topo_c = dict(topo_a, device_kind="cpu")
    program = {"plan": {"strategy": "dp"}, "batch": "f32[16,8]"}
    keys = {executable_key("train_step", "sig0", t, program)
            for t in (topo_a, topo_b, topo_c)}
    assert len(keys) == 3
    assert executable_key("train_step", "sig0", topo_a, program) != \
        executable_key("serve_decode", "sig0", topo_a, program)
    # the same machinery as JAX's: the same inputs give JAX's key
    for t in (topo_a, topo_b, topo_c):
        for kind in ("train_step", "serve_decode"):
            assert executable_key(kind, "sig0", t, program, {"e": 1}) == \
                jexport_cache.executable_key(kind, "sig0", t, program,
                                             {"e": 1})


# -- stale fallback -----------------------------------------------------------


def _tamper_env_field(cache_dir, field="torch", value="0.0.0-elsewhere"):
    """Rewrite every index record as if it came from another env."""
    index = os.path.join(cache_dir, "index.jsonl")
    lines = []
    with open(index) as f:
        for line in f:
            rec = json.loads(line)
            rec["record"]["env"][field] = value
            lines.append(json.dumps(rec))
    with open(index, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_stale_version_falls_back_loudly_and_rebuilds(tmp_path, stand_in):
    cache = str(tmp_path / "exe")
    cold_losses, _, _, _ = train_run(cache)
    _tamper_env_field(cache, "torch")

    report = ExecutableCache(cache).verify()
    assert len(report) == 1 and not report[0]["live"]
    assert "torch" in report[0]["reason"]

    losses, _, rec, _ = train_run(cache)
    ev = names(rec)
    assert ev[0] == "export.stale"
    assert "export.store" in ev  # rebuilt AND overwrote the entry
    # rebuilt from csrc/ (forced), once
    assert [c for c in stand_in.calls if c[1]] == [(["paged_attention"], True)]
    stale = next(r for r in rec if r["name"] == "export.stale")
    assert "0.0.0-elsewhere" in stale["reason"]
    assert losses == cold_losses  # the run itself is unharmed
    # the overwrite healed the cache: next start hits again
    _, _, rec2, _ = train_run(cache)
    assert names(rec2) == ["export.hit"]


def test_torn_payload_is_stale_not_fatal(tmp_path, stand_in):
    cache = str(tmp_path / "exe")
    train_run(cache)
    exe = ExecutableCache(cache)
    (key, rec), = exe.entries().items()
    (lib_file,) = exe.payload_files(rec)
    with open(os.path.join(cache, lib_file), "wb") as f:
        f.write(b"\x80\x04 not a library")
    losses, _, recs, _ = train_run(cache)
    ev = names(recs)
    assert "export.stale" in ev and "export.store" in ev
    stale = next(r for r in recs if r["name"] == "export.stale")
    assert stale["reason"].startswith("deserialize failed")
    assert losses  # trained through the rebuild


def test_missing_payload_is_stale(tmp_path, stand_in):
    cache = str(tmp_path / "exe")
    train_run(cache)
    exe = ExecutableCache(cache)
    (key, rec), = exe.entries().items()
    (lib_file,) = exe.payload_files(rec)
    os.remove(os.path.join(cache, lib_file))
    report = exe.verify()
    assert not report[0]["live"]
    assert "missing" in report[0]["reason"]


def test_changed_source_digest_is_stale(tmp_path, stand_in):
    """A library whose sources changed in ``csrc/`` (its digested file
    name no longer ``library_path``'s) is stale, never installed."""
    cache = str(tmp_path / "exe")
    train_run(cache)
    exe = ExecutableCache(cache)
    (key, rec), = exe.entries().items()
    rec = json.loads(json.dumps(rec))
    rec["libs"][0]["file"] = "libpaged_attention_0000000000000000.so"
    exe.put_record(key, rec)
    reason = exe.check_live(exe.lookup(key))
    assert reason.startswith("source digest") and "csrc/" in reason
    _, _, recs, _ = train_run(cache)
    assert names(recs)[:1] == ["export.stale"]


# -- the library install (a stand-in file: loading is the card's job) ---------


def test_library_install_copies_and_checks_sha256(tmp_path, stand_in):
    cache = ExecutableCache(str(tmp_path / "exe"))
    build.build(["paged_attention"])
    lib = build.library_path("paged_attention")
    want = lib.read_bytes()
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        rec = cache.store("k", ["paged_attention"], kind="serve_decode")
    (entry,) = rec["libs"]
    assert entry["file"] == lib.name and entry["bytes"] == len(want)
    assert rec["payload_bytes"] == len(want)
    (lib_file,) = cache.payload_files(rec)
    assert lib_file == os.path.join(
        "libs", export_cache_mod.env_tag(rec["env"]), lib.name)
    stored = os.path.join(cache.root, lib_file)
    with open(stored, "rb") as f:
        assert f.read() == want
    lib.unlink()
    assert cache.load("k", rec, check_load=False) == rec["libs"]
    assert lib.read_bytes() == want  # installed where the build looks
    # the same record over other bytes: the sha256 refuses them
    with open(stored, "wb") as f:
        f.write(b"x" * len(want))
    lib.unlink()
    with pytest.raises(ValueError, match="sha256"):
        cache.load("k", rec, check_load=False)
    assert not lib.exists()


def test_entries_share_one_library_and_a_miss_installs_it(tmp_path,
                                                          stand_in):
    """Two entries that launch the same library (here two batch shapes)
    point at one file, and a miss for the second installs that file
    instead of building the library again; a torn file is built."""
    cache = str(tmp_path / "exe")
    train_run(cache)
    lib = build.library_path("paged_attention")
    built = lib.read_bytes()
    lib.unlink()  # a fresh process's empty build directory
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        ad = make_ad(cache=cache)
        ad.init(torch.Generator().manual_seed(0), toy_batch(batch=8))
    assert names(j.records) == ["export.miss", "export.store"]
    assert ad._export_info["source"] == "compile"
    assert stand_in.calls == [(["paged_attention"], False)]  # cold run's
    assert lib.read_bytes() == built
    exe = ExecutableCache(cache)
    files = {f for rec in exe.entries().values()
             for f in exe.payload_files(rec)}
    assert len(exe.entries()) == 2 and len(files) == 1
    assert sum(len(fs) for _, _, fs in
               os.walk(os.path.join(cache, "libs"))) == 1
    (only,) = files
    with open(os.path.join(cache, only), "wb") as f:
        f.write(b"torn")
    lib.unlink()
    make_ad(cache=cache).init(torch.Generator().manual_seed(0),
                              toy_batch(batch=4))
    assert stand_in.calls == [(["paged_attention"], False)] * 2
    with open(os.path.join(cache, only), "rb") as f:
        assert f.read() == built  # the store wrote the built bytes back


def test_unloadable_library_falls_back_to_a_build(tmp_path, stand_in,
                                                   monkeypatch):
    """A cached library that ``ctypes`` will not load (here the stand-in
    bytes) journals ``export.fallback`` once and is built from the
    sources; a second entry holding it (K4's two serving kinds) keeps
    the built library."""
    monkeypatch.setattr(export_cache_mod, "_fell_back", set())
    cache = ExecutableCache(str(tmp_path / "exe"))
    build.build(["paged_attention"])
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        recs = [cache.store(k, ["paged_attention"], kind=k)
                for k in ("serve_decode", "serve_prefill")]
        n_builds = len(stand_in.calls)
        cache.load("serve_decode", recs[0], check_load=True)
        lib = build.library_path("paged_attention")
        lib.write_bytes(b"rebuilt")  # mark the library the fallback built
        cache.load("serve_prefill", recs[1], check_load=True)
    (fb,) = [r for r in j.records if r["name"] == "export.fallback"]
    assert fb["fn"] == "libpaged_attention" and "OSError" in fb["error"]
    assert stand_in.calls[n_builds:] == [(["paged_attention"], False)]
    assert lib.read_bytes() == b"rebuilt"  # not the cached copy again


# -- serving ------------------------------------------------------------------


def serve_tokens(cache):
    from torch_automatic_distributed_neural_network_tpu_torch.inference.serve \
        import ServeEngine

    cfg = gpt2_config("test", vocab_size=128, max_seq_len=64,
                      dtype=torch.float32)
    model = DecoderLM(cfg).init_weights(torch.Generator().manual_seed(1))
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        eng = ServeEngine(model, n_slots=4, max_len=64, block_size=8,
                          journal=j, export_cache=cache, device="cpu")
        eng.submit([5, 6, 7, 8, 9], max_new_tokens=8, eos_id=None)
        eng.submit([11, 12, 13], max_new_tokens=5, eos_id=None)
        done = eng.run()
    return [r.out_tokens for r in done], j.records, eng


def test_serve_cold_warm_token_identity(tmp_path):
    """JAX's serving case, held to the port's own cold run (JAX's
    ``test_serve_cold_warm_token_parity`` is red on the reference)."""
    cache = str(tmp_path / "exe")
    cold_toks, cold_rec, cold_eng = serve_tokens(cache)
    assert sorted(names(cold_rec)) == ["export.miss", "export.miss",
                                       "export.store", "export.store"]
    assert {i["kind"] for i in cold_eng.export_info} == \
        {"serve_decode", "serve_prefill"}
    warm_toks, warm_rec, warm_eng = serve_tokens(cache)
    assert names(warm_rec) == ["export.hit", "export.hit"]
    assert all(i["source"] == "hit" for i in warm_eng.export_info)
    assert cold_toks == warm_toks


# -- CLI ----------------------------------------------------------------------

MLP_ARGV = ["export", "--family", "mlp", "--size", "32,16,10", "--seq", "4",
            "--batch", "8", "--strategy", "dp", "--device", "cpu"]


def test_cli_export_json_smoke(tmp_path, capsys):
    cache = str(tmp_path / "exe")
    argv = [*MLP_ARGV, "--cache", cache, "--json"]
    assert cli(argv) == 0
    cold = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert cold[0]["kind"] == "train_step"
    assert cold[0]["source"] == "compile"

    assert cli(argv) == 0
    warm = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert warm[0]["source"] == "hit"
    assert warm[0]["key"] == cold[0]["key"]

    assert cli(["export", "--verify", "--cache", cache, "--json"]) == 0
    ver = json.loads(capsys.readouterr().out.strip())
    assert ver["cache"] == cache
    assert [e["live"] for e in ver["entries"]] == [True]
    assert cli(["export", "--verify", "--cache", cache]) == 0
    assert "[live ] train_step" in capsys.readouterr().out


def test_cli_export_serve_and_report_render(tmp_path, capsys):
    from torch_automatic_distributed_neural_network_tpu_torch.obs import (
        report,
    )

    cache = str(tmp_path / "exe")
    jpath = str(tmp_path / "journal.jsonl")
    argv = ["export", "--family", "gpt2", "--size", "test", "--serve",
            "--batch", "8", "--seq", "16", "--strategy", "dp",
            "--device", "cpu", "--cache", cache, "--journal", jpath,
            "--json"]
    assert cli(argv) == 0
    out = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert {r["kind"] for r in out} == {"train_step", "serve_decode",
                                        "serve_prefill"}
    rep = report.generate(jpath)
    assert rep["export"]["stores"] == 3
    text = report.format_report(rep)
    assert "export cache" in text


# -- shared JSONL compaction (tune cache + export index) ----------------------


def test_tune_cache_size_cap_compacts(tmp_path):
    path = str(tmp_path / "tune_cache.jsonl")
    for i in range(200):
        tune_cache.store(f"key{i % 4}", {"winner": i}, path=path,
                         max_bytes=0)
    before = {k: tune_cache.lookup(f"key{k}", path=path) for k in range(4)}
    stats = tune_cache.compact_jsonl(path)
    assert stats["kept"] == 4 and stats["dropped"] == 196
    assert stats["after_bytes"] < stats["before_bytes"]
    for k in range(4):
        assert tune_cache.lookup(f"key{k}", path=path) == before[k]
    tune_cache.compact_jsonl(path, max_bytes=80)
    assert os.path.getsize(path) <= 80
    assert tune_cache.lookup("key3", path=path) == before[3]


def test_store_triggers_compaction_over_cap(tmp_path):
    path = str(tmp_path / "tune_cache.jsonl")
    for i in range(50):
        tune_cache.store("hot", {"winner": i}, path=path, max_bytes=500)
    assert os.path.getsize(path) < 500
    assert tune_cache.lookup("hot", path=path) == {"winner": 49}


def test_export_index_compaction_deletes_orphan_payloads(tmp_path):
    cache = ExecutableCache(str(tmp_path / "exe"), max_index_bytes=0)
    lib = {"name": "k1", "file": "libk1_0.so", "bytes": 7, "sha256": ""}
    cache.put_record("k1", {"kind": "train_step", "env": {},
                            "libs": [lib]})
    (live,) = cache.payload_files(cache.lookup("k1"))
    orphan = os.path.join(os.path.dirname(live), "liborphan_0.so")
    gone_env = os.path.join("libs", "0" * 16, "libk1_0.so")
    for f in (live, orphan, gone_env):  # no record points at the last two
        os.makedirs(os.path.join(cache.root, os.path.dirname(f)),
                    exist_ok=True)
        with open(os.path.join(cache.root, f), "wb") as fh:
            fh.write(pickle.dumps("payload"))
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        stats = cache.compact()
    assert stats["orphan_payloads_removed"] == 2
    assert os.path.isfile(os.path.join(cache.root, live))
    assert not os.path.exists(os.path.join(cache.root, orphan))
    assert not os.path.exists(os.path.join(cache.root, gone_env))
    assert not os.path.exists(os.path.join(cache.root, "libs", "0" * 16))
    assert names(j.records) == ["export.compact"]


# -- cost memo ----------------------------------------------------------------


def count_measured_calls(monkeypatch) -> list:
    """Count the calls ``compiled_cost`` measures (runs under its
    ``FlopCounterMode``); a memo hit measures none."""
    from torch.utils import flop_counter

    calls = []

    class Counting(flop_counter.FlopCounterMode):
        def __enter__(self):
            calls.append(1)
            return super().__enter__()

    monkeypatch.setattr(flop_counter, "FlopCounterMode", Counting)
    return calls


def test_compiled_cost_memoizes(tmp_path, monkeypatch):
    """JAX's memory and disk tiers.  The port's key digests the callable,
    the state it reaches and its arguments' shapes, dtypes and devices
    (nothing is lowered), so one measured call serves the three."""
    from torch_automatic_distributed_neural_network_tpu_torch.utils import (
        profiling,
    )

    monkeypatch.setenv("TADNN_EXPORT_CACHE", str(tmp_path / "exe"))
    monkeypatch.setattr(profiling, "_cost_memo", {})
    calls = count_measured_calls(monkeypatch)

    def fn(x):
        return (x @ x.T).sum()

    x = torch.ones(8, 8)
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        first = profiling.compiled_cost(fn, x)
        second = profiling.compiled_cost(fn, x)  # in-process memo
        profiling._cost_memo.clear()
        third = profiling.compiled_cost(fn, x)  # disk tier
        other = profiling.compiled_cost(fn, torch.ones(4, 8))
    assert "error" not in first
    assert first == second == third
    assert other["flops"] == 2 * 4 * 8 * 4
    tiers = [r["tier"] for r in j.records
             if r["name"] == "cost_analysis.cached"]
    assert tiers == ["memory", "disk"]
    assert len(calls) == 2  # the 8 x 8 call ran once, the 4 x 8 once


def test_compiled_cost_keys_the_state_the_callable_reaches(monkeypatch):
    """Two GPT-2 widths on the same tokens, passed as the module, as its
    bound ``forward`` and in a closure, are separate entries with their
    own FLOPs (the memo keys the parameters' shapes, as JAX's key holds
    the lowered program's); the same model again is a hit.  A callable
    whose state cannot be described is measured on every call."""
    import threading

    from torch_automatic_distributed_neural_network_tpu_torch.utils import (
        profiling,
    )

    monkeypatch.setattr(profiling, "_cost_memo", {})
    calls = count_measured_calls(monkeypatch)
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 128, size=(2, 16)))
    models = [DecoderLM(gpt2_config("test", vocab_size=128, max_seq_len=64,
                                    d_model=d, dtype=torch.float32))
              for d in (128, 256)]
    forms = [lambda m: m, lambda m: m.forward, lambda m: (lambda t: m(t))]
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        flops = [[profiling.compiled_flops(form(m), tokens) for m in models]
                 for form in forms]
        again = profiling.compiled_flops(models[1], tokens)
    for small, wide in flops:
        assert small and wide and wide > small
        assert small == flops[0][0] and wide == flops[0][1]
    assert again == flops[0][1]
    assert len(calls) == 6  # one measured call per form and width
    assert len([r for r in j.records
                if r["name"] == "cost_analysis.cached"]) == 1
    # a hit keeps what depends on the shapes alone
    assert all(set(v["memory"]) == {"argument_size", "output_size"}
               for v in profiling._cost_memo.values())

    lock = threading.Lock()

    def locked(x):
        with lock:
            return (x @ x.T).sum()

    assert profiling._cost_cache_key(locked, (tokens,), {}) is None
    x = torch.ones(4, 4)
    profiling.compiled_cost(locked, x)
    profiling.compiled_cost(locked, x)
    assert len(calls) == 8


def test_compiled_cost_failure_not_cached(tmp_path, monkeypatch):
    from torch_automatic_distributed_neural_network_tpu_torch.utils import (
        profiling,
    )

    monkeypatch.setenv("TADNN_EXPORT_CACHE", str(tmp_path / "exe"))
    monkeypatch.setattr(profiling, "_cost_memo", {})

    class Boom:
        def __call__(self, *a, **k):
            raise RuntimeError("no run today")

    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        out = profiling.compiled_cost(Boom())
        out2 = profiling.compiled_cost(Boom())
    assert "no run today" in out["error"]
    assert "no run today" in out2["error"]
    assert not profiling._cost_memo
    assert not [r for r in j.records
                if r["name"] == "cost_analysis.cached"]


# -- GC by last-hit age (tadnn export --gc) -----------------------------------


def _entry(cache_dir):
    c = ExecutableCache(cache_dir)
    (key, rec), = c.entries().items()
    return c, key, rec


def test_gc_drops_cold_entries_and_keeps_fresh(tmp_path, stand_in):
    cache = str(tmp_path / "exe")
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        make_ad().export_step(None, toy_batch(), cache=cache)
        c, key, rec = _entry(cache)
        (payload,) = [os.path.join(cache, f) for f in c.payload_files(rec)]
        assert os.path.isfile(payload)
        assert c.gc(max_age_s=3600.0)["dropped"] == 0
        stats = c.gc(max_age_s=0.0)
    assert stats["dropped"] == 1 and stats["kept"] == 0
    assert stats["payload_bytes_freed"] > 0
    assert not os.path.isfile(payload)
    assert c.entries() == {}
    gcs = [r for r in j.records if r["name"] == "export.gc"]
    assert len(gcs) == 2 and gcs[-1]["dropped"] == 1


def test_hit_refreshes_last_hit_so_hot_entries_survive_gc(tmp_path,
                                                          stand_in):
    cache = str(tmp_path / "exe")
    train_run(cache)
    c, key, rec = _entry(cache)
    (payload,) = [os.path.join(cache, f) for f in c.payload_files(rec)]
    rec = dict(rec)
    rec["created"] = 1.0
    rec.pop("last_hit", None)
    c.put_record(key, rec)
    _, _, warm_rec, _ = train_run(cache)
    assert names(warm_rec) == ["export.hit"]
    refreshed = c.entries()[key]
    assert refreshed.get("last_hit", 0.0) > 1.0
    j = obs_journal.Journal()
    with obs_journal.as_default(j):
        assert c.gc(max_age_s=3600.0)["dropped"] == 0
    assert os.path.isfile(payload)
    stale = dict(refreshed)
    stale["created"] = 1.0
    stale["last_hit"] = 1.0
    c.put_record(key, stale)
    with obs_journal.as_default(j):
        assert c.gc(max_age_s=3600.0)["dropped"] == 1


def test_cli_export_gc(tmp_path, capsys, stand_in):
    cache = str(tmp_path / "exe")
    assert cli([*MLP_ARGV, "--cache", cache, "--json"]) == 0
    capsys.readouterr()
    assert cli(["export", "--gc", "--max-age-days", "30",
                "--cache", cache, "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["dropped"] == 0 and out["kept"] == 1
    assert cli(["export", "--gc", "--max-age-days", "0",
                "--cache", cache, "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["dropped"] == 1 and out["payload_bytes_freed"] > 0
    assert cli(["export", "--verify", "--cache", cache, "--json"]) == 0
    ver = json.loads(capsys.readouterr().out.strip())
    assert ver["entries"] == []


# -- plan blob and optimizer specs against JAX ----------------------------------


def _gpt2_pair():
    jm = JGPT2("test", scan_layers=False)
    jabs = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    cfg = gpt2_config("test")
    with torch.device("meta"):
        pabs = planner.abstract_params(DecoderLM(cfg))
    return jabs, pabs, (cfg.n_heads, cfg.kv_heads)


PLAN_CASES = [(s, n) for s in ("dp", "fsdp", "tp") for n in (2, 4)]


@pytest.mark.parametrize("strategy,n", PLAN_CASES,
                         ids=[f"{s}-{n}" for s, n in PLAN_CASES])
def test_plan_blob_matches_jax(strategy, n):
    jabs, pabs, heads = _gpt2_pair()
    jplan = jplanner.make_plan(jabs, strategy=strategy,
                               devices=jax.devices()[:n])
    plan = planner.make_plan(pabs, strategy=strategy, heads=heads,
                             topology=topology.parse_topology(f"cpu-{n}"))
    want = jexport_cache.plan_blob(jplan)
    got = plan_blob(plan)
    assert set(got) == set(want)
    for field in set(want) - {"specs"}:
        assert got[field] == want[field], field


def _shard_numel(shape, spec, degrees, slices):
    (first,) = slices(shape, spec, degrees)[:1]
    return int(np.prod([b - a for a, b in first]))


@pytest.mark.parametrize("strategy,zero1", [("fsdp", False), ("tp", False),
                                            ("dp", True)])
def test_opt_state_spec_tree_matches_jax(strategy, zero1):
    """The Adam moments' specs by parameter name: the mesh axes each uses
    and the elements of its first shard (the two packages lay some
    weights out differently, as ``tests/test_torch_port_planner.py``
    compares plans); JAX's tree over optax's state, the port's over its
    own.  The step count is replicated in both."""
    jabs, pabs, heads = _gpt2_pair()
    jplan = jplanner.make_plan(jabs, strategy=strategy, zero1=zero1,
                               devices=jax.devices()[:4])
    plan = planner.make_plan(pabs, strategy=strategy, zero1=zero1,
                             heads=heads,
                             topology=topology.parse_topology("cpu-4"))
    deg = plan.degrees
    jopt = jax.eval_shape(optax.adamw(1e-3).init, jabs)
    jspecs = jplan.opt_spec_tree if zero1 else jplan.param_specs
    jtree = dict(jplanner._flatten_with_paths(
        joptim.opt_state_spec_tree(jopt, jabs, jspecs)))
    jflat = dict(jplanner._flatten_with_paths(jabs))
    opt = adamw(1e-3).init(dict(pabs))
    tree = optim_mod.opt_state_spec_tree(
        opt, dict(pabs), plan.opt_spec_tree if zero1 else plan.param_specs)
    assert tree[0]["count"] == planner.P()
    assert [s for p, s in jtree.items() if p.endswith("count")] == [
        jplanner.P()]
    checked = 0
    for moment in ("mu", "nu"):
        for name, spec in tree[0][moment].items():
            ppath = jax_param_path(name)
            (jpath,) = [p for p in jtree
                        if f"{moment}/" in p and p.endswith("/" + ppath)]
            jspec = jtree[jpath]
            assert planner.spec_axes(spec) == jplanner.spec_axes(jspec), (
                name, spec, jspec)
            assert _shard_numel(tuple(pabs[name].shape), spec, deg,
                                planner.leaf_shard_slices) == \
                _shard_numel(jflat[ppath].shape, jspec, deg,
                             jplanner.leaf_shard_slices), name
            checked += 1
    assert checked == 2 * len(pabs)


# -- the compilation cache ----------------------------------------------------


def test_enable_compilation_cache_points_the_kernel_build(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    d = tmp_path / "kernels"
    assert tad.enable_compilation_cache(str(d)) == str(d)
    assert tad.enable_compilation_cache is topology.enable_compilation_cache
    assert build.library_path("paged_attention").parent == d
    assert not d.exists()  # made at the first build
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert topology.enable_compilation_cache() == str(
        tmp_path / "home" / ".cache" / "tadnn_kernels")
    # tadnn run turns it on unless TADNN_NO_COMPILE_CACHE=1
    seen = []
    monkeypatch.setattr(topology, "enable_compilation_cache",
                        lambda *a: seen.append(a))
    script = tmp_path / "s.py"
    script.write_text("pass\n")
    for env, want in (("", 1), ("1", 1)):
        monkeypatch.setenv("TADNN_NO_COMPILE_CACHE", env)
        assert cli(["run", str(script)]) == 0
        assert len(seen) == want
    monkeypatch.delenv("TADNN_NO_COMPILE_CACHE")


# -- two gloo ranks: world keys, the step's text, shardings ---------------------

LAUNCH_WORKLOAD = {"vocab_size": 512, "seq_len": 33, "batch_size": 16,
                   "lr": 0.1}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``tadnn export --worlds 2`` and a launcher ``--prewarm`` for a
    world of 2 fill one cache; then 2 gloo ranks look the keys up."""
    tmp = tmp_path_factory.mktemp("export2")
    cache = str(tmp / "exe")
    buf = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(buf):
        assert cli(["export", "--family", "gpt2", "--size", "test",
                    "--seq", "16", "--batch", "8", "--strategy", "dp",
                    "--device", "cpu", "--cache", cache, "--worlds", "2",
                    "--json"]) == 0
    (line,) = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert launch.main([
        "--worker", "--launch-dir", str(tmp), "--prewarm", "--simulate",
        "--num-processes", "2", "--export-cache", cache,
        *(a for k, v in LAUNCH_WORKLOAD.items()
          for a in (f"--{k.replace('_', '-')}", str(v)))]) == 0
    (done,) = [r for r in obs_journal.Journal.read(
        str(tmp / "journal_prewarm_w2.jsonl"))
        if r["name"] == "export.prewarm_done"]
    out = spawn(2, {"export": {"cache": cache, "seq": 16, "batch": 8,
                               "launch": LAUNCH_WORKLOAD}},
                tmp_path_factory.mktemp("export2_spawn"))["export"]
    return line, done, out


def test_world_exports_hit_in_a_real_world(two_ranks):
    line, done, out = two_ranks
    assert (line["world"], line["source"]) == (2, "compile")
    assert out["cli"] == {"events": ["export.hit"], "key": line["key"]}
    assert (done["world"], done["source"]) == (2, "compile")
    assert out["launch"] == {"events": ["export.hit"], "key": done["key"]}


def test_compiled_step_text_bytes_equal_the_inventory(two_ranks):
    from torch_automatic_distributed_neural_network_tpu_torch.obs.trace import (
        collective_family,
    )

    _, _, out = two_ranks
    want: dict = {}
    for rec in out["inventory"]:
        fam = collective_family(f"c10d::{rec['prim']}")
        w = want.setdefault(fam, {"count": 0, "payload_bytes": 0})
        w["count"] += rec["count"]
        w["payload_bytes"] += rec["bytes"]
    assert out["text_bytes"] == want
    # fsdp: the parameters gathered, the gradients reduce-scattered
    assert {"all-gather", "reduce-scatter"} <= set(want)


@pytest.mark.parametrize("name", ["fsdp", "tp", "dp_zero1"])
def test_state_shardings_match_the_initialized_state(two_ranks, name):
    _, _, out = two_ranks
    checked, bad = out["shardings"][name]
    assert checked > 0 and bad == []


def test_launcher_prewarms_a_shrink_world(tmp_path):
    """The elastic launcher's background prewarm (JAX's ``_prewarm``): a
    detached ``--prewarm`` worker for a world of 1, journaled
    ``export.prewarm`` by the launcher and ``export.prewarm_done`` by the
    worker, once a world, its entry stored in the cohort's cache."""
    cache = str(tmp_path / "exe")
    lnch = launch.Launcher(launch.LaunchConfig(
        str(tmp_path / "run"), hosts=2, elastic=True, simulate=True,
        export_cache=cache))
    with obs_journal.as_default(lnch.journal):
        lnch._prewarm(1)
        lnch._prewarm(1)  # once a world
    (proc,) = lnch._prewarm_procs
    assert proc.wait(timeout=120) == 0
    lnch._reap_prewarms()
    lnch.journal.close()
    (pre,) = [r for r in obs_journal.Journal.read(
        str(tmp_path / "run" / "journal_launcher.jsonl"))
        if r["name"] == "export.prewarm"]
    (done,) = [r for r in obs_journal.Journal.read(
        str(tmp_path / "run" / "journal_prewarm_w1.jsonl"))
        if r["name"] == "export.prewarm_done"]
    assert (pre["world"], pre["pid"]) == (1, proc.pid)
    assert (done["world"], done["source"]) == (1, "compile")
    assert list(ExecutableCache(cache).entries()) == [done["key"]]
