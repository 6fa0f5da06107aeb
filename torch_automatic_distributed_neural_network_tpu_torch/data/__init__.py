"""Training data for the port (numpy batches, as in the JAX package):
the synthetic streams, the on-disk array datasets (MNIST idx, CIFAR-10
pickles, npy pairs) with their synthetic fallback, the token-file
loader with its native C++ backend, :func:`shard_for_host` (a
process's rows of a global batch), the text tokenizer that writes
token files (``text.py``) and the adapters over a user's torch
``Dataset`` / ``DataLoader`` (``torch_adapter.py``)."""

from .arrays import (
    ArrayClassification,
    ArraySeq2Seq,
    classification_dataset,
    load_cifar10,
    load_mnist,
    load_seq2seq,
)
from .loader import (
    HostBatch,
    TokenFileDataset,
    TokenFileWriter,
    shard_for_host,
    write_token_file,
)
from .text import ByteTokenizer, load_tokenizer, tokenize_file
from .synthetic import (
    SyntheticClassification,
    SyntheticLM,
    SyntheticMLM,
    SyntheticSeq2Seq,
)
from .torch_adapter import TorchDatasetAdapter, TorchLoaderAdapter

__all__ = ["ArrayClassification", "ArraySeq2Seq", "ByteTokenizer",
           "HostBatch", "SyntheticClassification", "SyntheticLM",
           "SyntheticMLM", "SyntheticSeq2Seq", "TokenFileDataset",
           "TokenFileWriter", "TorchDatasetAdapter", "TorchLoaderAdapter",
           "classification_dataset", "load_cifar10", "load_mnist",
           "load_seq2seq", "load_tokenizer", "shard_for_host",
           "tokenize_file", "write_token_file"]
