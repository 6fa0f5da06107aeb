"""Training-loop subsystems: losses, optimizers and precision policies,
LoRA, metrics, checkpointing (coordinated and per-process sharded),
resilience, the trainer and the multi-process launcher.

The checkpoint, resilience, elastic, trainer, shards and launch symbols
are lazy (module ``__getattr__``, as in the JAX package): they import
``torch.distributed.checkpoint``, which importing the package for
serving should not pay for.
"""

from .lora import (
    LoraSpec,
    LoraTarget,
    apply_lora,
    init_lora_params,
    lora_init_fn,
    lora_loss,
    lora_optimizer,
    merge_lora,
)
from .losses import (
    blockwise_next_token_loss,
    masked_lm_loss,
    moe_next_token_loss,
    mse_loss,
    next_token_loss,
    next_token_loss_mutable,
    seq2seq_loss,
    softmax_xent_loss,
    softmax_xent_loss_mutable,
)
from .metrics import MetricsLogger, peak_flops_per_chip, transformer_step_flops
from .optim import (
    GradientTransformation,
    adamw,
    adamw_cosine,
    apply_updates,
    chain,
    clip_by_global_norm,
    decay_mask,
    sgd,
    warmup_cosine,
)
from .precision import PRESETS, Precision, cast_floats, resolve, wrap_optimizer

_LAZY = {
    "CheckpointManager": "checkpoint",
    "restore_or_init": "checkpoint",
    "Trainer": "trainer",
    "TrainerConfig": "trainer",
    "FaultInjector": "elastic",
    "Heartbeat": "elastic",
    "InjectedFault": "elastic",
    "PreemptionGuard": "elastic",
    "StepWatchdog": "elastic",
    "run_with_recovery": "elastic",
    "AnomalyConfig": "resilience",
    "ChaosData": "resilience",
    "ChaosFault": "resilience",
    "ChaosInjector": "resilience",
    "ChaosPlan": "resilience",
    "CheckpointCorruptError": "resilience",
    "RestartPolicy": "resilience",
    "StallError": "resilience",
    "tear_checkpoint": "resilience",
    "verify_directory": "resilience",
    "ShardedCheckpoint": "shards",
    "tear_shard": "shards",
    "verify_sharded_directory": "shards",
    "LaunchConfig": "launch",
    "Launcher": "launch",
    "launch_doctor": "launch",
    "format_launch_doctor": "launch",
}

__all__ = [
    "GradientTransformation", "LoraSpec", "LoraTarget", "MetricsLogger",
    "PRESETS", "Precision", "adamw", "adamw_cosine", "apply_lora",
    "apply_updates", "blockwise_next_token_loss", "cast_floats", "chain",
    "clip_by_global_norm", "decay_mask", "init_lora_params",
    "lora_init_fn", "lora_loss", "lora_optimizer", "masked_lm_loss",
    "merge_lora", "moe_next_token_loss", "mse_loss", "next_token_loss",
    "next_token_loss_mutable", "peak_flops_per_chip", "resolve",
    "seq2seq_loss", "sgd", "softmax_xent_loss", "softmax_xent_loss_mutable",
    "transformer_step_flops", "warmup_cosine", "wrap_optimizer", *_LAZY,
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
