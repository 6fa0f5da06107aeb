"""Pretrain a BERT encoder on masked LM (synthetic stream by default):
the JAX package's ``examples/train_bert_mlm.py`` on the port.

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_bert_mlm \\
        run.steps=100
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_bert_mlm \\
        model.size=base model.seq_len=512 run.batch_size=8
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_bert_mlm \\
        run.device=cpu run.steps=5

Two fields more than the JAX example: ``run.device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path) and ``model.attention_impl``
(``auto``: the flash kernels, non-causal, at S >= 512 on the card;
``xla`` the plain attention).  ``main`` returns the final state, the
trainer and the data source; ``data=`` replaces the synthetic stream
with a step-indexed source of the same batches' shape.
"""

import dataclasses
import sys

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import SyntheticMLM
from torch_automatic_distributed_neural_network_tpu_torch.examples.common import device_of
from torch_automatic_distributed_neural_network_tpu_torch.models import Bert
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    adamw,
    masked_lm_loss,
    transformer_step_flops,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "test"  # test | base | large (models/bert.py)
    seq_len: int = 128
    vocab_size: int = 30522
    attention_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 50
    batch_size: int = 8
    lr: float = 1e-4
    log_every: int = 10
    metrics_path: str = ""
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path
    # the static lint before step 0 (TrainerConfig.preflight: the step
    # traced on fake tensors, ~10 s for GPT-2 small); False skips it
    preflight: bool = True


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

    model = Bert(cfg.model.size, vocab_size=cfg.model.vocab_size,
                 max_seq_len=cfg.model.seq_len,
                 attention_impl=cfg.model.attention_impl)
    mcfg = model.cfg  # one config: reported params/MFU = trained model
    if data is None:
        data = SyntheticMLM(
            vocab_size=cfg.model.vocab_size, seq_len=cfg.model.seq_len,
            batch_size=cfg.run.batch_size,
        )
    ad = tad.AutoDistribute(
        model,
        optimizer=adamw(cfg.run.lr),
        loss_fn=masked_lm_loss,
        strategy=cfg.parallel.strategy,
        device=device,
    )
    tokens_per_step = cfg.run.batch_size * cfg.model.seq_len
    ad.build_plan(None, data.batch(0))
    metrics = MetricsLogger(
        cfg.run.metrics_path or None,
        items_name="tokens",
        flops_per_step=transformer_step_flops(
            mcfg.num_params(), tokens_per_step),
        console_every=cfg.run.log_every,
        device=device,
    )
    trainer = Trainer(
        ad,
        TrainerConfig(steps=cfg.run.steps, log_every=cfg.run.log_every,
                      preflight=cfg.run.preflight),
        metrics=metrics,
        items_per_step=tokens_per_step,
        run_config=cfglib.to_dict(cfg),
    )
    state = trainer.fit(data)
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)} "
          f"params={mcfg.num_params()/1e6:.1f}M final_step={int(state.step)}")
    return {"state": state, "trainer": trainer, "data": data}


if __name__ == "__main__":
    main()
