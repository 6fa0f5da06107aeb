"""Training data for the port (numpy batches, as in the JAX package):
the synthetic streams, the on-disk array datasets (MNIST idx, CIFAR-10
pickles, npy pairs) with their synthetic fallback, the token-file
loader with its native C++ backend, and :func:`shard_for_host` (a
process's rows of a global batch)."""

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
from .synthetic import (
    SyntheticClassification,
    SyntheticLM,
    SyntheticMLM,
    SyntheticSeq2Seq,
)

__all__ = ["ArrayClassification", "ArraySeq2Seq", "HostBatch",
           "SyntheticClassification", "SyntheticLM", "SyntheticMLM",
           "SyntheticSeq2Seq", "TokenFileDataset", "TokenFileWriter",
           "classification_dataset", "load_cifar10", "load_mnist",
           "load_seq2seq", "shard_for_host", "write_token_file"]
