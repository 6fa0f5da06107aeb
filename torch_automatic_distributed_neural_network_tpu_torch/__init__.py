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
  tensor parallelism, ZeRO-1 and their hybrids with a data axis, and
  expert parallelism: ``ep``, ``ep_fsdp``, ``ep_tp``), the
  Trainer over a process group, coordinated and per-process sharded
  checkpoints (``training.checkpoint``, ``training.shards``), and the
  launcher (``training.launch``, ``launch`` and ``run`` in the command
  line);
- the rest of the model zoo on one card: BERT (MLM and classifier),
  ViT, the MT Transformer, MoE (``parallel.expert``'s routing; decoded
  by ``generate`` and ``ServeEngine``, densely or routed) and the MNIST
  MLP (``models``), their losses
  (``training.losses``), the synthetic and on-disk datasets (``data``)
  and one example a family (``examples``);
- ResNet with BatchNorm (``models.resnet``): its running statistics as
  ``TrainState.model_state`` through the step, eval, checkpoints and the
  wrappers, global-batch statistics under a plan, SGD with momentum, the
  mutable losses, and the ResNet/CIFAR and Llama FSDP examples;
- serving and decoding across devices: the tensor-parallel and
  disaggregated ``ServeEngine`` (``inference.serve``), the plan-aware
  decode (``inference.decode.generate(mesh=)``,
  ``AutoDistribute.generate``), LoRA on a bare parameter, and
  Megatron-SP (``parallel.context``).

The top-level names are the JAX package's (``AutoDistribute``,
``autodistribute``, the planner's and the topology's, with
``enable_compilation_cache``), but for the ``obs``/``tune``
subpackages, which are imported by their own path.

The kernels are CUDA C++ for Hopper (sources in ``csrc/``).  The package
imports torch and numpy, never jax.  Entry points run on the card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead.
"""

from .core import (
    AutoDistribute,
    ShardPlan,
    TrainState,
    autodistribute,
    mesh_degrees,
)
from . import planner, topology
from .planner import Rule, TRANSFORMER_RULES, make_plan, param_spec_tree
from .topology import (
    MESH_AXES,
    Topology,
    build_mesh,
    detect,
    enable_compilation_cache,
    initialize_distributed,
    single_device_mesh,
)
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
    ResNet18Thin,
    ResNet50,
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
    next_token_loss_mutable,
    seq2seq_loss,
    sgd,
    softmax_xent_loss,
    softmax_xent_loss_mutable,
)

__version__ = "0.3.0"

__all__ = [
    # the JAX package's names
    "AutoDistribute", "TrainState", "autodistribute", "Rule", "ShardPlan",
    "TRANSFORMER_RULES", "make_plan", "param_spec_tree", "MESH_AXES",
    "Topology", "build_mesh", "detect", "enable_compilation_cache",
    "initialize_distributed",
    "mesh_degrees", "single_device_mesh", "__version__",
    # the port's shortcuts to its models, data and losses
    "GPT2", "MLP", "Bert", "DecoderLM", "Llama", "MoE", "ResNet18Thin",
    "ResNet50", "SyntheticClassification", "SyntheticLM", "SyntheticMLM",
    "SyntheticSeq2Seq", "TokenFileDataset", "TransformerConfig",
    "TransformerMT", "ViT", "adamw", "adamw_cosine",
    "blockwise_next_token_loss", "masked_lm_loss", "moe_next_token_loss",
    "mse_loss", "next_token_loss", "next_token_loss_mutable",
    "seq2seq_loss", "sgd", "softmax_xent_loss", "softmax_xent_loss_mutable",
    "write_token_file",
]
