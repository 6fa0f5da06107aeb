"""The zoo's data and examples in the PyTorch port: the synthetic streams
(``SyntheticClassification``, ``SyntheticSeq2Seq``, ``SyntheticMLM``)
and the on-disk array datasets (``data/arrays.py``, the port's own copy)
give the JAX package's batches bit for bit from the same seed and files;
each new example runs on the CPU when asked (``run.device=cpu`` /
``--device cpu``) and raises without a card otherwise.
"""

import gzip
import pickle

import numpy as np
import pytest
import torch

from torch_automatic_distributed_neural_network_tpu.data import arrays as jarrays
from torch_automatic_distributed_neural_network_tpu.data import synthetic as jsynth
from torch_automatic_distributed_neural_network_tpu_torch.data import arrays as tarrays
from torch_automatic_distributed_neural_network_tpu_torch.data import synthetic as tsynth

STREAMS = {
    "classification": dict(image_shape=(8, 8, 3), num_classes=5,
                           batch_size=4),
    "seq2seq": dict(vocab_size=300, src_len=12, tgt_len=9, batch_size=3),
    "mlm": dict(vocab_size=300, seq_len=16, batch_size=3),
}
CLASSES = {"classification": "SyntheticClassification",
           "seq2seq": "SyntheticSeq2Seq", "mlm": "SyntheticMLM"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: a pool of threads a
    process stalls on every op when parallel test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_synthetic_streams_match_jax(stream, seed):
    ours = getattr(tsynth, CLASSES[stream])(seed=seed, **STREAMS[stream])
    theirs = getattr(jsynth, CLASSES[stream])(seed=seed, **STREAMS[stream])
    for step in (0, 1, 7):
        _equal(ours.batch(step), theirs.batch(step))
    _equal(next(iter(ours)), next(iter(theirs)))


def test_array_datasets_match_jax():
    rs = np.random.RandomState(0)
    x, y = rs.rand(20, 4, 4, 1).astype(np.float32), rs.randint(0, 3, 20)
    src, tgt = rs.randint(1, 50, (18, 6)), rs.randint(1, 50, (18, 7))
    for make in (lambda m: m.ArrayClassification(x, y, 6, seed=3),
                 lambda m: m.ArraySeq2Seq(src, tgt, 5, seed=4)):
        ours, theirs = make(tarrays), make(jarrays)
        for step in (0, 2, 3, 9):  # across epochs
            _equal(ours.batch(step), theirs.batch(step))
    with pytest.raises(ValueError, match="batch_size"):
        tarrays.ArrayClassification(x, y, 64)


def _write_mnist(d, n=12):
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    with gzip.open(d / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write((2051).to_bytes(4, "big") + b"".join(
            s.to_bytes(4, "big") for s in (n, 28, 28)) + images.tobytes())
    with open(d / "train-labels-idx1-ubyte", "wb") as f:
        f.write((2049).to_bytes(4, "big") + n.to_bytes(4, "big")
                + labels.tobytes())


def _write_cifar(d):
    root = d / "cifar-10-batches-py"
    root.mkdir()
    rs = np.random.RandomState(2)
    for i in range(1, 6):
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (4, 3072)).astype(
                np.uint8), b"labels": list(rs.randint(0, 10, 4))}, f)


def test_readers_match_jax(tmp_path):
    """MNIST idx (gzipped and not), CIFAR-10 pickles, npy pairs, and an
    empty directory (None: the examples' synthetic fallback)."""
    _write_mnist(tmp_path)
    _write_cifar(tmp_path)
    np.save(tmp_path / "src.npy", np.arange(12).reshape(3, 4))
    np.save(tmp_path / "tgt.npy", np.arange(15).reshape(3, 5))
    for loader in ("load_mnist", "load_cifar10", "load_seq2seq"):
        ours = getattr(tarrays, loader)(str(tmp_path))
        theirs = getattr(jarrays, loader)(str(tmp_path))
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        empty = tmp_path / f"empty_{loader}"
        empty.mkdir()
        assert getattr(tarrays, loader)(str(empty)) is None


def test_classification_dataset_falls_back_like_jax(tmp_path, capsys):
    fallback = lambda: tsynth.SyntheticClassification(batch_size=2)
    data = tarrays.classification_dataset("", tarrays.load_mnist, 2,
                                          fallback=fallback)
    assert isinstance(data, tsynth.SyntheticClassification)
    data = tarrays.classification_dataset(str(tmp_path), tarrays.load_mnist,
                                          2, fallback=fallback)
    assert isinstance(data, tsynth.SyntheticClassification)
    assert "using synthetic" in capsys.readouterr().out
    _write_mnist(tmp_path)
    ours = tarrays.classification_dataset(str(tmp_path), tarrays.load_mnist,
                                          4, fallback=fallback, seed=1)
    theirs = jarrays.classification_dataset(str(tmp_path), jarrays.load_mnist,
                                            4, fallback=fallback, seed=1)
    _equal(ours.batch(2), theirs.batch(2))


# -- the examples ----------------------------------------------------------------

P = "torch_automatic_distributed_neural_network_tpu_torch.examples"
EXAMPLES = {
    "train_bert_mlm": ["model.size=test", "model.seq_len=32",
                       "model.vocab_size=256", "run.batch_size=2"],
    "train_vit": ["run.batch_size=4"],
    "train_transformer_mt": ["model.size=test", "model.src_len=8",
                             "model.tgt_len=9", "run.batch_size=2"],
    "train_moe": ["model.size=test", "model.seq_len=16",
                  "model.vocab_size=128", "run.batch_size=2"],
}


def _example(name):
    import importlib

    return importlib.import_module(f"{P}.{name}")


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_train_on_the_cpu(name, capsys):
    out = _example(name).main(EXAMPLES[name] + ["run.steps=3",
                                                "run.device=cpu"])
    assert int(out["state"].step) == 3
    assert "devices: 1 x cpu" in capsys.readouterr().out


def test_mnist_example_trains_on_the_cpu(tmp_path, capsys):
    out = _example("train_mnist_mlp").main(
        ["--steps", "4", "--batch-size", "16", "--device", "cpu"])
    assert out["state"].step == 4
    out = _example("train_mnist_mlp").main(
        ["--steps", "3", "--batch-size", "16", "--device", "cpu",
         "--out-dir", str(tmp_path)])
    assert int(out["state"].step) == 3
    assert (tmp_path / "metrics.jsonl").exists()


@pytest.mark.parametrize("name", sorted(EXAMPLES) + ["train_mnist_mlp"])
def test_examples_default_to_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [] if name == "train_mnist_mlp" else EXAMPLES[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main(argv)
