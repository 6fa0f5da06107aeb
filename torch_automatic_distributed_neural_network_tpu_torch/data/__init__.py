"""Training data for the port (numpy batches, as in the JAX package):
synthetic LM batches and the token-file loader with its native C++
backend, and :func:`shard_for_host` (a process's rows of a global
batch)."""

from .loader import (
    HostBatch,
    TokenFileDataset,
    TokenFileWriter,
    shard_for_host,
    write_token_file,
)
from .synthetic import SyntheticLM

__all__ = ["HostBatch", "SyntheticLM", "TokenFileDataset", "TokenFileWriter",
           "shard_for_host", "write_token_file"]
