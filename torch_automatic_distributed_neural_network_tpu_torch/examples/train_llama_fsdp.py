"""Train a Llama-style decoder with FSDP and activation checkpointing:
the JAX package's ``examples/train_llama_fsdp.py`` on the port
(BASELINE.json's "Llama FSDP auto-shard + grad checkpoint").  The
planner's ``fsdp`` strategy shards every parameter over the ``fsdp``
axis (FSDP2 wraps each decoder layer, then the root), the optimizer
state follows the shards, and remat is on.

Usage::

    torchrun --nproc-per-node 8 -m \\
        torch_automatic_distributed_neural_network_tpu_torch.examples.train_llama_fsdp \\
        model.size=8b run.steps=20
    python -m torch.distributed.run --nproc-per-node 1 -m \\
        torch_automatic_distributed_neural_network_tpu_torch.examples.train_llama_fsdp \\
        model.size=1b                        # FSDP2 at degree 1 on one card
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_llama_fsdp \\
        model.size=test run.device=cpu       # the CPU's scale

One field more than the JAX example: ``run.device`` (default ``cuda``,
``cuda:LOCAL_RANK`` under ``torchrun``; ``cpu`` runs the plain PyTorch
path).  Without a process group the plan has one device and the step is
unwrapped, with remat as the plan says.  ``main`` returns the final
state, the trainer and the data source; ``data=`` replaces the
synthetic stream and ``init_fn=`` reaches ``AutoDistribute`` (e.g. to
load carried weights in place of drawing them).
"""

import dataclasses
import sys

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import SyntheticLM
from torch_automatic_distributed_neural_network_tpu_torch.examples.common import device_of
from torch_automatic_distributed_neural_network_tpu_torch.models import Llama, llama_config
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    adamw,
    next_token_loss,
    transformer_step_flops,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "8b"
    seq_len: int = 2048


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 20
    batch_size: int = 8
    lr: float = 3e-4
    log_every: int = 5
    metrics_path: str = ""
    ckpt_dir: str = ""
    ckpt_every: int = 0
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path
    # the static lint before step 0 (TrainerConfig.preflight: the step
    # traced on fake tensors, ~10 s for GPT-2 small); False skips it
    preflight: bool = True


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    strategy: str = "fsdp"


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    run: RunCfg = RunCfg()
    parallel: ParallelCfg = ParallelCfg()


def main(argv=None, *, data=None, init_fn=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    tad.topology.initialize_distributed()  # a no-op outside torchrun
    device = device_of(cfg.run.device)

    mcfg = llama_config(cfg.model.size, max_seq_len=cfg.model.seq_len)
    if data is None:
        data = SyntheticLM(
            vocab_size=mcfg.vocab_size, seq_len=cfg.model.seq_len + 1,
            batch_size=cfg.run.batch_size,
        )
    ad = tad.AutoDistribute(
        Llama(cfg.model.size, max_seq_len=cfg.model.seq_len),
        optimizer=adamw(cfg.run.lr),
        loss_fn=next_token_loss,
        strategy=cfg.parallel.strategy,
        init_fn=init_fn,
        device=device,
    )
    tokens_per_step = cfg.run.batch_size * cfg.model.seq_len
    ad.build_plan(None, data.batch(0))
    # 6ND fwd+bwd; remat recomputes the forward -> 8ND of hardware FLOPs
    flops_mult = 8.0 / 6.0 if ad.plan.remat else 1.0
    metrics = MetricsLogger(
        cfg.run.metrics_path or None,
        items_name="tokens",
        flops_per_step=transformer_step_flops(
            mcfg.num_params(), tokens_per_step) * flops_mult,
        console_every=cfg.run.log_every,
        device=device,
    )
    ckpt = None
    if cfg.run.ckpt_dir:
        from torch_automatic_distributed_neural_network_tpu_torch.training import (
            CheckpointManager,
        )

        ckpt = CheckpointManager(cfg.run.ckpt_dir, device=device)
    trainer = Trainer(
        ad,
        TrainerConfig(steps=cfg.run.steps, log_every=cfg.run.log_every,
                      preflight=cfg.run.preflight,
                      ckpt_every=cfg.run.ckpt_every),
        metrics=metrics,
        ckpt=ckpt,
        items_per_step=tokens_per_step,
        run_config=cfglib.to_dict(cfg),
    )
    state = trainer.fit(data)
    if ckpt is not None:
        ckpt.close()
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)} "
          f"params={mcfg.num_params()/1e9:.2f}B")
    return {"state": state, "trainer": trainer, "data": data}


if __name__ == "__main__":
    main()
