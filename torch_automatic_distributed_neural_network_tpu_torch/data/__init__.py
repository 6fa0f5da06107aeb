"""Training data for the port (numpy batches, as in the JAX package)."""

from .synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
