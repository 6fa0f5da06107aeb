"""tadnn on PyTorch and CUDA: the port of the JAX package
``torch_automatic_distributed_neural_network_tpu`` to an NVIDIA H100.

Two slices so far:

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
  and precision policies (``training``) and ``SyntheticLM`` (``data``).

The kernels are CUDA C++ for Hopper (sources in ``csrc/``).  The package
imports torch and numpy, never jax.  Entry points run on the card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead.
"""

from .core import AutoDistribute, TrainState
from .data import SyntheticLM
from .models import GPT2, DecoderLM, Llama, TransformerConfig
from .training import (
    adamw,
    adamw_cosine,
    blockwise_next_token_loss,
    next_token_loss,
)

__version__ = "0.2.0"

__all__ = [
    "GPT2", "AutoDistribute", "DecoderLM", "Llama", "SyntheticLM",
    "TrainState", "TransformerConfig", "adamw", "adamw_cosine",
    "blockwise_next_token_loss", "next_token_loss",
]
