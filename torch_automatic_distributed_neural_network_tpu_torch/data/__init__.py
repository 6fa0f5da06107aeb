"""Training data for the port (numpy batches, as in the JAX package):
synthetic LM batches and the token-file loader with its native C++
backend."""

from .loader import TokenFileDataset, TokenFileWriter, write_token_file
from .synthetic import SyntheticLM

__all__ = ["SyntheticLM", "TokenFileDataset", "TokenFileWriter",
           "write_token_file"]
