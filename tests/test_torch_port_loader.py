"""The port's token-file loader (``data/loader.py``) against the JAX
package's on the same files: the TADN bytes it writes, and every batch
element for element (exact: integer tokens), from either backend, over
two epochs of the shuffle, at two seeds."""

import os

import numpy as np
import pytest

from torch_automatic_distributed_neural_network_tpu.data import loader as jloader
from torch_automatic_distributed_neural_network_tpu_torch.data import (
    TokenFileDataset,
    TokenFileWriter,
    write_token_file,
)
from torch_automatic_distributed_neural_network_tpu_torch.data import (
    loader as tloader,
)

SEQ, BATCH = 16, 4


def _tokens(dtype_bits: int, n: int = 3001) -> np.ndarray:
    hi = 2**15 if dtype_bits == 16 else 2**20
    return np.random.RandomState(dtype_bits).randint(0, hi, size=n)


@pytest.mark.parametrize("dtype_bits", [16, 32])
def test_write_token_file_bytes_match_jax(tmp_path, dtype_bits):
    toks = _tokens(dtype_bits)
    write_token_file(str(tmp_path / "port.bin"), toks)
    jloader.write_token_file(str(tmp_path / "jax.bin"), toks)
    port = (tmp_path / "port.bin").read_bytes()
    assert port == (tmp_path / "jax.bin").read_bytes()
    assert len(port) == 24 + len(toks) * dtype_bits // 8
    # the streaming writer gives the same bytes in pieces
    with TokenFileWriter(str(tmp_path / "chunks.bin"),
                         dtype=np.uint16 if dtype_bits == 16 else np.uint32
                         ) as w:
        for part in np.array_split(toks, 5):
            w.append(part)
    assert (tmp_path / "chunks.bin").read_bytes() == port


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype_bits", [16, 32])
def test_batches_match_jax_over_two_epochs(tmp_path, backend, seed,
                                           dtype_bits):
    path = str(tmp_path / "corpus.bin")
    write_token_file(path, _tokens(dtype_bits))
    port = TokenFileDataset(path, SEQ, BATCH, seed=seed, backend=backend,
                            device="cpu")
    ref = jloader.TokenFileDataset(path, SEQ, BATCH, seed=seed,
                                   backend="numpy")
    assert port.backend == backend
    assert port.n_windows == ref.n_windows == (3001 - 1) // SEQ
    steps = -(-2 * port.n_windows // BATCH) + 1  # past two epochs
    for i in range(steps):
        got = port.batch(i)["input_ids"]
        assert got.dtype == np.int32 and got.shape == (BATCH, SEQ + 1)
        np.testing.assert_array_equal(got, ref.batch(i)["input_ids"])
    # replaying an old step (a resumed run) gives the same batch
    np.testing.assert_array_equal(port.batch(3)["input_ids"],
                                  ref.batch(3)["input_ids"])
    port.close()


def test_each_package_reads_the_others_file(tmp_path):
    toks = _tokens(32, n=999)
    jloader.write_token_file(str(tmp_path / "jax.bin"), toks)
    write_token_file(str(tmp_path / "port.bin"), toks)
    a = TokenFileDataset(str(tmp_path / "jax.bin"), 8, 2, backend="numpy",
                         device="cpu")
    b = jloader.TokenFileDataset(str(tmp_path / "port.bin"), 8, 2,
                                 backend="numpy")
    assert a.n_tokens == b.n_tokens == 999
    for i in range(10):
        np.testing.assert_array_equal(a.batch(i)["input_ids"],
                                      b.batch(i)["input_ids"])


def test_native_library_is_keyed_by_the_source_in_the_build_dir():
    from torch_automatic_distributed_neural_network_tpu_torch.ops.build import (
        BUILD_DIR,
    )

    so = tloader._so_target()
    assert os.path.dirname(so) == str(BUILD_DIR)
    assert os.path.basename(so).startswith("libtadnn_loader_")
    assert "native" not in so.split(os.sep)  # never the JAX package's dir


def test_auto_takes_numpy_when_the_build_fails(tmp_path, monkeypatch):
    """``auto`` quietly falls back to numpy when ``g++`` is missing, as in
    the JAX package; ``native`` raises instead."""
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "_lib_failed", False)
    monkeypatch.setattr(tloader, "_so_target",
                        lambda: str(tmp_path / "lib" / "libloader.so"))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ here
    path = str(tmp_path / "c.bin")
    write_token_file(path, _tokens(16, n=200))
    assert TokenFileDataset(path, 8, 2, device="cpu").backend == "numpy"
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        TokenFileDataset(path, 8, 2, backend="native", device="cpu")


def test_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not a TADN"):
        TokenFileDataset(str(bad), 8, 2, device="cpu")
    short = str(tmp_path / "short.bin")
    write_token_file(short, np.arange(5))
    with pytest.raises(ValueError, match="one window"):
        TokenFileDataset(short, 8, 2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        TokenFileDataset(short, 2, 2, backend="rust", device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        write_token_file(str(tmp_path / "big.bin"), np.array([2**31]))
