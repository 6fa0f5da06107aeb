"""The migration path's data side and example in the PyTorch port
against the JAX package: ``data/torch_adapter.py`` (``TorchDatasetAdapter``
over two epochs, ``TorchLoaderAdapter``, the collate conventions),
``data/text.py`` (``ByteTokenizer``, ``load_tokenizer``,
``tokenize_file`` with small ``chunk_chars``, a large-vocab tokenizer's
uint32 file) and ``tadnn tokenize``, the packages' exported names, and
``examples/finetune_from_torch.py`` with both sources against the JAX
example.

Tolerances: batches, token files (byte for byte) and names exactly;
the example's first three losses within 2e-5 relative of the JAX
example's on the same weights and batches (fp32 on both sides; JAX runs
on the 8-device CPU mesh, data parallel, so its mean sums in another
order).
"""

import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader, TensorDataset

from torch_automatic_distributed_neural_network_tpu import cli as jcli
from torch_automatic_distributed_neural_network_tpu import data as jdata
from torch_automatic_distributed_neural_network_tpu import models as jmodels
from torch_automatic_distributed_neural_network_tpu.core import AutoDistribute as JAutoDistribute
from torch_automatic_distributed_neural_network_tpu_torch import cli
from torch_automatic_distributed_neural_network_tpu_torch import data as pdata
from torch_automatic_distributed_neural_network_tpu_torch import models as pmodels
from torch_automatic_distributed_neural_network_tpu_torch.core import AutoDistribute
from torch_automatic_distributed_neural_network_tpu_torch.data import (
    ByteTokenizer,
    TokenFileDataset,
    TorchDatasetAdapter,
    TorchLoaderAdapter,
    load_tokenizer,
    tokenize_file,
)
from torch_automatic_distributed_neural_network_tpu_torch.data.torch_adapter import (
    default_collate,
)
from torch_automatic_distributed_neural_network_tpu_torch.examples import (
    finetune_from_torch,
)

LOSS_RTOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXT = ("héllo wörld — ünïcode ✓\n" * 7 + "no newline at the end: 日本語"
        + "\n\n" + "x" * 40)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tensor_dataset(n=40, d=6, classes=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return TensorDataset(torch.randn(n, d, generator=g),
                         torch.randint(0, classes, (n,), generator=g))


class _DictDataset:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"tokens": torch.full((5,), i, dtype=torch.int32),
                "mask": np.arange(5) % 2 == i % 2}


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dataset,kw", [
    (_tensor_dataset, {"seed": 3}),
    (_tensor_dataset, {"shuffle": False}),
    (_DictDataset, {"seed": 1}),
], ids=["pairs_shuffled", "pairs_in_order", "dicts"])
def test_dataset_adapter_batches_equal_jax_over_two_epochs(dataset, kw):
    ds = dataset()
    port = TorchDatasetAdapter(ds, batch_size=4, **kw)
    ref = jdata.TorchDatasetAdapter(ds, batch_size=4, **kw)
    assert port.steps_per_epoch == ref.steps_per_epoch
    for step in range(2 * port.steps_per_epoch):
        _equal_batches(port.batch(step), ref.batch(step))
    # a resumed adapter (a new instance) replays the same batches
    again = TorchDatasetAdapter(ds, batch_size=4, **kw)
    _equal_batches(again.batch(port.steps_per_epoch + 1),
                   port.batch(port.steps_per_epoch + 1))
    it = iter(port)
    _equal_batches(next(it), ref.batch(0))


def test_loader_adapter_batches_equal_jax():
    loader = DataLoader(_tensor_dataset(n=24), batch_size=6, shuffle=False)
    got = list(TorchLoaderAdapter(loader))
    want = list(jdata.TorchLoaderAdapter(loader))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _equal_batches(a, b)
    dicts = DataLoader(_DictDataset(), batch_size=5)
    for a, b in zip(TorchLoaderAdapter(dicts), jdata.TorchLoaderAdapter(dicts)):
        _equal_batches(a, b)
    assert not TorchLoaderAdapter.step_indexed


def test_collate_conventions_and_refusals():
    ds = _tensor_dataset(n=8)
    assert set(default_collate([ds[0], ds[1]])) == {"x", "label"}
    assert set(default_collate([np.ones(3), np.zeros(3)])) == {"x"}
    for collate in (default_collate,
                    jdata.torch_adapter.default_collate):
        with pytest.raises(ValueError, match="pairs"):
            collate([(1, 2, 3)])
    with pytest.raises(ValueError, match="batch_size"):
        TorchDatasetAdapter(ds, batch_size=9)
    with pytest.raises(ValueError, match="pairs"):
        list(TorchLoaderAdapter([(np.ones(2), np.ones(2), np.ones(2))]))


class _WideTokenizer:
    """A tokenizer with HF's attribute names and a vocabulary past
    uint16 (the file takes uint32 ids)."""

    vocab_size = 70000
    eos_token_id = 69999

    def encode(self, text, add_special_tokens=True):
        assert not add_special_tokens
        return [60000 + ord(c) % 9000 for c in text]


def _written(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("tokenizer,kw", [
    (None, {}),
    (None, {"chunk_chars": 7}),
    (None, {"chunk_chars": 1, "append_eos": False}),
    ("wide", {"chunk_chars": 5}),
], ids=["byte", "byte_chunk7", "byte_chunk1_no_eos", "wide_uint32"])
def test_tokenize_file_equals_jax_byte_for_byte(tmp_path, tokenizer, kw):
    src = tmp_path / "corpus.txt"
    src.write_text(TEXT, encoding="utf-8")
    tok = _WideTokenizer() if tokenizer == "wide" else None
    n = tokenize_file(str(src), str(tmp_path / "port.tadn"), tokenizer=tok,
                      log=False, **kw)
    n_ref = jdata.tokenize_file(str(src), str(tmp_path / "jax.tadn"),
                                tokenizer=tok, log=False, **kw)
    assert n == n_ref
    assert _written(tmp_path / "port.tadn") == _written(tmp_path / "jax.tadn")
    want = (tok or ByteTokenizer()).encode(TEXT, **(
        {"add_special_tokens": False} if tok else {}))
    if kw.get("append_eos", True):
        want = want + [getattr(tok, "eos_token_id", ByteTokenizer.eos_id)]
    # one window of the whole stream reads back every id
    ds = TokenFileDataset(str(tmp_path / "port.tadn"), seq_len=n - 1,
                          batch_size=1, device="cpu")
    np.testing.assert_array_equal(ds.batch(0)["input_ids"][0], want)
    ds.close()


def test_cli_tokenize_equals_jax(tmp_path):
    src = tmp_path / "corpus.txt"
    src.write_text(TEXT, encoding="utf-8")
    assert cli.main(["tokenize", str(src), str(tmp_path / "p.tadn")]) == 0
    assert jcli.main(["tokenize", str(src), str(tmp_path / "j.tadn")]) == 0
    assert _written(tmp_path / "p.tadn") == _written(tmp_path / "j.tadn")
    assert cli.main(["tokenize", str(src), str(tmp_path / "p2.tadn"),
                     "--no-eos", "--tokenizer", "byte"]) == 0
    assert jcli.main(["tokenize", str(src), str(tmp_path / "j2.tadn"),
                      "--no-eos"]) == 0
    assert _written(tmp_path / "p2.tadn") == _written(tmp_path / "j2.tadn")


def test_byte_tokenizer_and_loader():
    tok, ref = load_tokenizer(), jdata.load_tokenizer("byte")
    assert isinstance(load_tokenizer("byte"), ByteTokenizer)
    assert (tok.vocab_size, tok.bos_id, tok.eos_id) == (
        ref.vocab_size, ref.bos_id, ref.eos_id)
    ids = tok.encode(TEXT)
    assert ids == ref.encode(TEXT)
    assert tok.decode(ids + [256, 257]) == ref.decode(ids) == TEXT


def test_exported_names_hold_jax():
    assert set(jmodels.__all__) <= set(pmodels.__all__)
    assert set(jdata.__all__) <= set(pdata.__all__)
    for name in jmodels.__all__:
        assert getattr(pmodels, name) is not None
    for name in jdata.__all__:
        assert getattr(pdata, name) is not None


class _Stop(BaseException):
    """Ends a run after its last recorded step."""


def _record_losses(monkeypatch, cls, stop_after=None):
    """Each step's loss of ``cls.step`` into the returned list; raises
    :class:`_Stop` after ``stop_after`` steps."""
    losses = []
    step = cls.step

    def recording(self, state, batch):
        state, m = step(self, state, batch)
        losses.append(float(m["loss"]))
        if len(losses) == stop_after:
            raise _Stop
        return state, m

    monkeypatch.setattr(cls, "step", recording)
    return losses


@pytest.mark.parametrize("source", ["torch", "hf"])
def test_finetune_example_matches_jax_example(monkeypatch, capsys, source):
    """Three steps of each example on the same weights and batches: the
    port's on the CPU, JAX's as written (its 8-device CPU mesh); the
    HF source draws its checkpoint from torch's global seed, so both run
    from seed 0, and computes in fp32 on both sides (each example's
    import wrapped with the fp32 dtype: its bf16 default rounds the two
    packages apart by ~1e-5 relative, which would hide most faults)."""
    argv = [f"model.source={source}", "run.steps=3", "run.log_every=1"]
    j_import, p_import = jmodels.import_hf_gpt2, pmodels.import_hf_gpt2
    monkeypatch.setattr(jmodels, "import_hf_gpt2", lambda hf, **kw: j_import(
        hf, dtype=jax.numpy.float32, **kw))
    monkeypatch.setattr(finetune_from_torch, "import_hf_gpt2",
                        lambda hf, **kw: p_import(hf, dtype=torch.float32,
                                                  **kw))
    # JAX's run ends after its third step (its generation, op by op on
    # the CPU, would compile hundreds of programs)
    want = _record_losses(monkeypatch, JAutoDistribute, stop_after=3)
    monkeypatch.setattr(sys, "argv", ["finetune_from_torch.py", *argv])
    torch.manual_seed(0)
    with pytest.raises(_Stop):
        runpy.run_path(os.path.join(ROOT, "examples",
                                    "finetune_from_torch.py"),
                       run_name="__main__")
    got = _record_losses(monkeypatch, AutoDistribute)
    torch.manual_seed(0)
    out = finetune_from_torch.main([*argv, "run.device=cpu"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert got[-1] < got[0]
    ad, state = out["ad"], out["state"]
    assert ad.plan.strategy == "dp" and int(state.step) == 3
    gen = out["generated"]
    assert gen.shape == ((1, 16) if source == "torch" else (1, 24))
    text = capsys.readouterr().out
    assert ("bridged hand-written torch LM" in text) == (source == "torch")
    if source == "torch":
        assert isinstance(ad.model, pmodels.TorchBridge)
        assert set(state.model_state) == {"mask"}
