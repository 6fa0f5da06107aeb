"""Train a Mixtral-style MoE LM: the JAX package's
``examples/train_moe.py`` on the port, at expert degree 1 (expert
parallelism, ``parallel.strategy=ep*``, raises: not ported yet).

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_moe \\
        model.size=nano run.steps=100
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_moe \\
        model.size=small model.seq_len=1024
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_moe \\
        model.size=test run.device=cpu run.steps=5

One field more than the JAX example: ``run.device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  The MFU takes the active
parameters (top-k of the experts) as its basis.  ``main`` returns the
final state, the ``AutoDistribute``, the data source and the per-step
metrics records; ``data=`` replaces the synthetic stream.
"""

import dataclasses
import sys

import torch

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import SyntheticLM
from torch_automatic_distributed_neural_network_tpu_torch.examples.common import device_of
from torch_automatic_distributed_neural_network_tpu_torch.models import MoE, moe_config
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    MetricsLogger,
    adamw,
    moe_next_token_loss,
    transformer_step_flops,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "nano"
    seq_len: int = 512
    vocab_size: int = 32000


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 50
    batch_size: int = 8
    lr: float = 3e-4
    log_every: int = 10
    metrics_path: str = ""
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    strategy: str = "auto"


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    run: RunCfg = RunCfg()
    parallel: ParallelCfg = ParallelCfg()


def main(argv=None, *, data=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    device = device_of(cfg.run.device)

    mcfg = moe_config(cfg.model.size, vocab_size=cfg.model.vocab_size,
                      max_seq_len=cfg.model.seq_len)
    print(f"MoE {cfg.model.size}: {mcfg.num_params()/1e6:.0f}M total / "
          f"{mcfg.active_params()/1e6:.0f}M active params, "
          f"{mcfg.n_experts} experts top-{mcfg.top_k}")
    if data is None:
        data = SyntheticLM(vocab_size=mcfg.vocab_size,
                           seq_len=cfg.model.seq_len + 1,
                           batch_size=cfg.run.batch_size)
    ad = tad.AutoDistribute(
        MoE(cfg.model.size, vocab_size=cfg.model.vocab_size,
            max_seq_len=cfg.model.seq_len),
        optimizer=adamw(cfg.run.lr),
        loss_fn=moe_next_token_loss,
        strategy=cfg.parallel.strategy,
        device=device,
    )
    state = ad.init(torch.Generator(device=device).manual_seed(0),
                    data.batch(0))
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)}")

    tokens_per_step = cfg.run.batch_size * cfg.model.seq_len
    logger = MetricsLogger(
        cfg.run.metrics_path or None, items_name="tokens",
        flops_per_step=transformer_step_flops(mcfg.active_params(),
                                              tokens_per_step),
        console_every=cfg.run.log_every, device=device,
    )
    records = []
    for i in range(cfg.run.steps):
        logger.start_step()
        state, m = ad.step(state, data.batch(i))
        records.append(logger.log_step(i + 1, m, tokens_per_step))
    logger.close()
    return {"state": state, "ad": ad, "data": data, "records": records}


if __name__ == "__main__":
    main()
