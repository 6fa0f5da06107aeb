"""Train GPT-2 on one card: the JAX package's ``examples/train_gpt2.py``
on the port, line for line.

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_gpt2 \\
        model.size=small run.steps=100
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_gpt2 \\
        model.size=test model.vocab_size=256 run.device=cpu

One field more than the JAX example: ``run.device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  The port plans for one device, so
``parallel.*`` values other than the defaults raise through
``AutoDistribute`` (ROADMAP Queue 1 items 3 and 5).  ``main`` returns
the final state, the trainer and the data source, so a caller can check
the run.
"""

import dataclasses
import sys

import torch

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import SyntheticLM
from torch_automatic_distributed_neural_network_tpu_torch.models import GPT2, gpt2_config
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    adamw,
    next_token_loss,
    transformer_step_flops,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib
from torch_automatic_distributed_neural_network_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "small"
    seq_len: int = 512
    vocab_size: int = 50257


@dataclasses.dataclass(frozen=True)
class DataCfg:
    path: str = ""  # TADN token file (data/loader.py); "" = synthetic


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 50
    batch_size: int = 8
    lr: float = 3e-4
    log_every: int = 10
    metrics_path: str = ""
    ckpt_dir: str = ""
    ckpt_every: int = 0
    # restarts allowed per rolling hour (needs ckpt_dir); <0 = no recovery
    max_restarts: int = -1
    anomaly_rollback: bool = False  # loss NaN/spike -> restore + skip batch
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    strategy: str = "auto"
    seq: int = 1  # context-parallel degree (ring/Ulysses attention)
    pipe: int = 1  # pipeline stages (1 = no pipeline)
    microbatches: int = 8
    schedule: str = "cond"  # cond | dense | 1f1b (parallel/pipeline.py)


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    data: DataCfg = DataCfg()
    run: RunCfg = RunCfg()
    parallel: ParallelCfg = ParallelCfg()


def main(argv=None, *, callbacks=None) -> dict:
    """Run the example on ``argv`` (default ``sys.argv[1:]``) overrides;
    ``callbacks`` go to the Trainer (e.g. a FaultInjector)."""
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    device = resolve_device(cfg.run.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"devices: 1 x {kind}")

    mcfg = gpt2_config(
        cfg.model.size, vocab_size=cfg.model.vocab_size,
        max_seq_len=cfg.model.seq_len,
    )
    if cfg.data.path:
        from torch_automatic_distributed_neural_network_tpu_torch.data import (
            TokenFileDataset,
        )

        data = TokenFileDataset(
            cfg.data.path, seq_len=cfg.model.seq_len,
            batch_size=cfg.run.batch_size, device=device,
        )
        print(f"data: {cfg.data.path} ({data.n_tokens:,} tokens, "
              f"{data.backend} backend)")
    else:
        data = SyntheticLM(
            vocab_size=mcfg.vocab_size, seq_len=cfg.model.seq_len + 1,
            batch_size=cfg.run.batch_size,
        )
    ad = tad.AutoDistribute(
        GPT2(cfg.model.size, vocab_size=cfg.model.vocab_size,
             max_seq_len=cfg.model.seq_len),
        optimizer=adamw(cfg.run.lr),
        loss_fn=next_token_loss,
        strategy=cfg.parallel.strategy,
        seq_parallel=cfg.parallel.seq,
        pipeline_stages=cfg.parallel.pipe,
        device=device,
    )

    tokens_per_step = cfg.run.batch_size * cfg.model.seq_len
    ad.build_plan(None, data.batch(0))
    # 6ND fwd+bwd; remat recomputes the forward -> 8ND of hardware FLOPs
    flops_mult = 8.0 / 6.0 if ad.plan.remat else 1.0
    metrics = MetricsLogger(
        cfg.run.metrics_path or None,
        items_name="tokens",
        flops_per_step=transformer_step_flops(mcfg.num_params(),
                                              tokens_per_step) * flops_mult,
        console_every=cfg.run.log_every,
        device=device,
    )
    ckpt = None
    if cfg.run.ckpt_dir:
        from torch_automatic_distributed_neural_network_tpu_torch.training import (
            CheckpointManager,
        )

        ckpt = CheckpointManager(cfg.run.ckpt_dir, device=device)
    anomaly = None
    if cfg.run.anomaly_rollback:
        from torch_automatic_distributed_neural_network_tpu_torch.training import (
            AnomalyConfig,
        )

        anomaly = AnomalyConfig()
    trainer = Trainer(
        ad,
        TrainerConfig(steps=cfg.run.steps, log_every=cfg.run.log_every,
                      ckpt_every=cfg.run.ckpt_every, anomaly=anomaly),
        metrics=metrics,
        ckpt=ckpt,
        items_per_step=tokens_per_step,
        run_config=cfglib.to_dict(cfg),
        callbacks=callbacks,
    )
    if cfg.run.max_restarts >= 0:
        from torch_automatic_distributed_neural_network_tpu_torch.training import (
            RestartPolicy,
            run_with_recovery,
        )

        # step-indexed data + restore_or_init make fit() re-entrant: each
        # retry resumes from the newest intact checkpoint
        state = run_with_recovery(
            lambda: trainer.fit(data),
            policy=RestartPolicy(max_restarts=cfg.run.max_restarts,
                                 window_s=3600.0),
        )
    else:
        state = trainer.fit(data)  # step-indexed: resume replays batches
    if ckpt is not None:
        ckpt.close()
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)} "
          f"params={mcfg.num_params()/1e6:.0f}M final_step={int(state.step)}")
    return {"state": state, "trainer": trainer, "data": data}


if __name__ == "__main__":
    main()
