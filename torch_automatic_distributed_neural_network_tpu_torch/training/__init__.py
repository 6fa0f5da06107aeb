"""Training-loop subsystems: losses, optimizers and precision policies,
metrics, checkpointing, resilience and the trainer.

The checkpoint, resilience, elastic and trainer symbols are lazy (module
``__getattr__``, as in the JAX package): they import
``torch.distributed.checkpoint``, which importing the package for
serving should not pay for.
"""

from .losses import blockwise_next_token_loss, next_token_loss
from .metrics import MetricsLogger, peak_flops_per_chip, transformer_step_flops
from .optim import (
    GradientTransformation,
    adamw,
    adamw_cosine,
    apply_updates,
    chain,
    clip_by_global_norm,
    decay_mask,
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
}

__all__ = [
    "GradientTransformation", "MetricsLogger", "PRESETS", "Precision",
    "adamw", "adamw_cosine", "apply_updates", "blockwise_next_token_loss",
    "cast_floats", "chain", "clip_by_global_norm", "decay_mask",
    "next_token_loss", "peak_flops_per_chip", "resolve",
    "transformer_step_flops", "warmup_cosine", "wrap_optimizer", *_LAZY,
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
