"""tadnn on PyTorch and CUDA: the port of the JAX package
``torch_automatic_distributed_neural_network_tpu`` to an NVIDIA H100.

Three slices so far:

- serving: the GPT-2 and Llama decoder families (``models``), KV-cached
  decoding (``inference.decode``), the paged KV pool, scheduler and
  continuous-batching engine (``inference.serve``), and the paged
  decode-attention kernel (``ops.paged_attention``);
  ``python -m torch_automatic_distributed_neural_network_tpu_torch serve``
  runs it;
- training on one device: ``AutoDistribute`` (``core``) with the
  full-sequence forward of ``DecoderLM``, the attention dispatcher and
  the flash-attention forward and backward kernels
  (``ops.attention``, ``ops.flash_attention``), the losses, optimizers
  and precision policies (``training``) and ``SyntheticLM`` (``data``);
- the trainer stack on one device: ``Trainer`` with metrics, goodput and
  the journal, asynchronous checkpoints with integrity manifests and a
  fallback chain, restarts, anomaly rollback and preemption drain
  (``training``), the token-file loader with its native C++ backend
  (``data``), ``doctor`` in the command line, and the ``train_gpt2``
  example (``examples``).

The kernels are CUDA C++ for Hopper (sources in ``csrc/``).  The package
imports torch and numpy, never jax.  Entry points run on the card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead.
"""

from .core import AutoDistribute, ShardPlan, TrainState, mesh_degrees
from .data import SyntheticLM, TokenFileDataset, write_token_file
from .models import GPT2, DecoderLM, Llama, TransformerConfig
from .training import (
    adamw,
    adamw_cosine,
    blockwise_next_token_loss,
    next_token_loss,
)

__version__ = "0.3.0"

__all__ = [
    "GPT2", "AutoDistribute", "DecoderLM", "Llama", "ShardPlan",
    "SyntheticLM", "TokenFileDataset", "TrainState", "TransformerConfig",
    "adamw", "adamw_cosine", "blockwise_next_token_loss", "mesh_degrees",
    "next_token_loss", "write_token_file",
]
