"""On-disk array datasets for the classification and MT examples: the
JAX package's ``data/arrays.py``, copied (pure numpy).

The examples train on synthetic streams unless real data is on disk;
then ``--data-dir`` / ``run.data_dir`` / ``data.dir`` loads it through
here:

- **MNIST idx**: the canonical ``train-images-idx3-ubyte`` /
  ``train-labels-idx1-ubyte`` pair (optionally ``.gz``);
- **CIFAR-10 python pickles**: ``data_batch_1..5`` from the official
  ``cifar-10-batches-py`` tarball layout;
- **npy pairs**: generic ``x.npy``/``y.npy`` (classification) or
  ``src.npy``/``tgt.npy`` (seq2seq token ids) for pre-tokenized data.

Datasets are step-indexed (Trainer protocol: ``.batch(i)``): each epoch
draws a fresh deterministic permutation, so a resumed run sees exactly
the batches an uninterrupted run would have.  LM token corpora use
data/loader.py's TADN files instead.
"""

from __future__ import annotations

import gzip
import os
import pickle
from typing import Any

import numpy as np


def _epoch_order(n: int, epoch: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed + epoch).permutation(n)


class ArrayClassification:
    """Step-indexed batches over in-memory (x, y) arrays."""

    step_indexed = True

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 seed: int = 0):
        if len(x) != len(y):
            raise ValueError(f"x/y length mismatch: {len(x)} vs {len(y)}")
        if len(x) < batch_size:
            raise ValueError(
                f"dataset of {len(x)} rows < batch_size {batch_size}"
            )
        self.x = np.asarray(x)
        self.y = np.asarray(y, np.int32)
        self.batch_size = batch_size
        self.seed = seed
        self.batches_per_epoch = len(x) // batch_size

    def batch(self, step: int) -> dict:
        epoch, b = divmod(step, self.batches_per_epoch)
        order = _epoch_order(len(self.x), epoch, self.seed)
        rows = order[b * self.batch_size:(b + 1) * self.batch_size]
        return {"x": self.x[rows], "label": self.y[rows]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class ArraySeq2Seq:
    """Step-indexed batches over (src, tgt) token-id arrays."""

    step_indexed = True

    def __init__(self, src: np.ndarray, tgt: np.ndarray, batch_size: int,
                 seed: int = 0):
        if len(src) != len(tgt):
            raise ValueError(
                f"src/tgt length mismatch: {len(src)} vs {len(tgt)}"
            )
        self.src = np.asarray(src, np.int32)
        self.tgt = np.asarray(tgt, np.int32)
        self.batch_size = batch_size
        self.seed = seed
        self.batches_per_epoch = len(src) // batch_size

    def batch(self, step: int) -> dict:
        epoch, b = divmod(step, self.batches_per_epoch)
        order = _epoch_order(len(self.src), epoch, self.seed)
        rows = order[b * self.batch_size:(b + 1) * self.batch_size]
        return {"src": self.src[rows], "tgt": self.tgt[rows]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _find(data_dir: str, *names: str) -> str | None:
    for name in names:
        for cand in (name, name + ".gz"):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                return p
    return None


def _read_idx(path: str) -> np.ndarray:
    """Parse an MNIST idx file (images magic 2051, labels magic 2049)."""
    with _open_maybe_gz(path) as f:
        raw = f.read()
    magic = int.from_bytes(raw[0:4], "big")
    ndim = magic & 0xFF
    dims = [
        int.from_bytes(raw[4 + 4 * i:8 + 4 * i], "big") for i in range(ndim)
    ]
    data = np.frombuffer(raw, np.uint8, offset=4 + 4 * ndim)
    return data.reshape(dims)


def load_mnist(data_dir: str, *, split: str = "train"):
    """(x [N,28,28,1] float32 in [0,1], y [N] int32) from ``data_dir``.

    Accepts npy pairs (``x_train.npy``/``y_train.npy``) or the canonical
    idx files.  Returns None if neither is present.
    """
    stem = "train" if split == "train" else "t10k"
    npy_x = _find(data_dir, f"x_{split}.npy")
    npy_y = _find(data_dir, f"y_{split}.npy")
    if npy_x and npy_y:
        x = np.load(npy_x).astype(np.float32)
        y = np.load(npy_y).astype(np.int32)
    else:
        ix = _find(data_dir, f"{stem}-images-idx3-ubyte",
                   f"{stem}-images.idx3-ubyte")
        iy = _find(data_dir, f"{stem}-labels-idx1-ubyte",
                   f"{stem}-labels.idx1-ubyte")
        if not (ix and iy):
            return None
        x = _read_idx(ix).astype(np.float32) / 255.0
        y = _read_idx(iy).astype(np.int32)
    if x.ndim == 3:
        x = x[..., None]
    if x.max() > 1.5:  # npy path may be raw 0..255
        x = x / 255.0
    return x.astype(np.float32), y


def load_cifar10(data_dir: str, *, split: str = "train"):
    """(x [N,32,32,3] float32 in [0,1], y [N] int32) from the official
    ``cifar-10-batches-py`` pickle layout (or a dir containing it), or
    npy pairs.  Returns None if absent."""
    npy_x = _find(data_dir, f"x_{split}.npy")
    npy_y = _find(data_dir, f"y_{split}.npy")
    if npy_x and npy_y:
        x = np.load(npy_x).astype(np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        return x, np.load(npy_y).astype(np.int32)
    for root in (data_dir, os.path.join(data_dir, "cifar-10-batches-py")):
        names = (
            [f"data_batch_{i}" for i in range(1, 6)]
            if split == "train" else ["test_batch"]
        )
        if not all(os.path.exists(os.path.join(root, n)) for n in names):
            continue
        xs, ys = [], []
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.append(np.asarray(d[b"labels"], np.int32))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.concatenate(ys)
    return None


def load_seq2seq(data_dir: str, *, split: str = "train"):
    """(src [N,S] int32, tgt [N,T] int32) from pre-tokenized npy pairs
    (``src_train.npy``/``tgt_train.npy`` or ``src.npy``/``tgt.npy``).
    Returns None if absent."""
    s = _find(data_dir, f"src_{split}.npy", "src.npy")
    t = _find(data_dir, f"tgt_{split}.npy", "tgt.npy")
    if not (s and t):
        return None
    return np.load(s).astype(np.int32), np.load(t).astype(np.int32)


def classification_dataset(
    data_dir: str | None,
    loader,
    batch_size: int,
    *,
    fallback,
    seed: int = 0,
) -> Any:
    """``loader(data_dir)`` result as an ArrayClassification, or the
    synthetic ``fallback()`` when ``data_dir`` is empty/absent (with a
    console note either way)."""
    if data_dir:
        loaded = loader(data_dir)
        if loaded is not None:
            x, y = loaded
            print(f"data: {len(x)} examples from {data_dir}")
            return ArrayClassification(x, y, batch_size, seed=seed)
        print(f"data: nothing loadable in {data_dir!r}; using synthetic")
    return fallback()
