"""tadnn on PyTorch and CUDA: the port of the JAX package
``torch_automatic_distributed_neural_network_tpu`` to an NVIDIA H100.

Its slices:

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
  example (``examples``);
- generation, the serving features and LoRA (``inference``,
  ``training.lora``), and the journal's event schema (``obs.schema``);
- training across processes: the planner and its wrappers over a
  ``torch.distributed`` group (``planner``, ``executor``: DDP, FSDP2,
  tensor parallelism, ZeRO-1 and their hybrids with a data axis), the
  Trainer over a process group, coordinated and per-process sharded
  checkpoints (``training.checkpoint``, ``training.shards``), and the
  launcher (``training.launch``, ``launch`` and ``run`` in the command
  line);
- the rest of the model zoo on one card: BERT (MLM and classifier),
  ViT, the MT Transformer, MoE at expert degree 1 (``parallel.expert``'s
  routing) and the MNIST MLP (``models``), their losses
  (``training.losses``), the synthetic and on-disk datasets (``data``)
  and one example a family (``examples``).

The kernels are CUDA C++ for Hopper (sources in ``csrc/``).  The package
imports torch and numpy, never jax.  Entry points run on the card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead.
"""

from .core import AutoDistribute, ShardPlan, TrainState, mesh_degrees
from . import planner, topology
from .data import (
    SyntheticClassification,
    SyntheticLM,
    SyntheticMLM,
    SyntheticSeq2Seq,
    TokenFileDataset,
    write_token_file,
)
from .models import (
    GPT2,
    MLP,
    Bert,
    DecoderLM,
    Llama,
    MoE,
    TransformerConfig,
    TransformerMT,
    ViT,
)
from .training import (
    adamw,
    adamw_cosine,
    blockwise_next_token_loss,
    masked_lm_loss,
    moe_next_token_loss,
    mse_loss,
    next_token_loss,
    seq2seq_loss,
    softmax_xent_loss,
)

__version__ = "0.3.0"

__all__ = [
    "GPT2", "MLP", "AutoDistribute", "Bert", "DecoderLM", "Llama", "MoE",
    "ShardPlan", "SyntheticClassification", "SyntheticLM", "SyntheticMLM",
    "SyntheticSeq2Seq", "TokenFileDataset", "TrainState",
    "TransformerConfig", "TransformerMT", "ViT", "adamw", "adamw_cosine",
    "blockwise_next_token_loss", "masked_lm_loss", "mesh_degrees",
    "moe_next_token_loss", "mse_loss", "next_token_loss", "seq2seq_loss",
    "softmax_xent_loss", "write_token_file",
]
