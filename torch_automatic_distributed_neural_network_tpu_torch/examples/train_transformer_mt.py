"""Train a Transformer-base MT model on synthetic WMT14-shaped data: the
JAX package's ``examples/train_transformer_mt.py`` on the port.

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_transformer_mt \\
        run.steps=50
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_transformer_mt \\
        model.size=test run.device=cpu run.steps=5

One field more than the JAX example: ``run.device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  ``main`` returns the final state,
the trainer and the data source; ``data=`` replaces the configured
source (an iterable of ``src``/``tgt`` batches).
"""

import dataclasses
import sys

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data import (
    ArraySeq2Seq,
    load_seq2seq,
)
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import (
    SyntheticSeq2Seq,
)
from torch_automatic_distributed_neural_network_tpu_torch.examples.common import device_of
from torch_automatic_distributed_neural_network_tpu_torch.models import TransformerMT
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    adamw,
    seq2seq_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "base"
    src_len: int = 64
    tgt_len: int = 64
    vocab_size: int = 32000


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 50
    batch_size: int = 64
    lr: float = 1e-3
    log_every: int = 10
    metrics_path: str = ""
    # dir with src[_train].npy / tgt[_train].npy token ids;
    # synthetic WMT14-shaped fallback when empty/absent
    data_dir: str = ""
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    strategy: str = "dp"


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    run: RunCfg = RunCfg()
    parallel: ParallelCfg = ParallelCfg()


def _dataset(cfg: Cfg, vocab: int):
    loaded = load_seq2seq(cfg.run.data_dir) if cfg.run.data_dir else None
    if loaded is not None:
        src, tgt = loaded
        print(f"data: {len(src)} pairs from {cfg.run.data_dir}")
        return ArraySeq2Seq(src, tgt, cfg.run.batch_size)
    if cfg.run.data_dir:
        print(f"data: nothing loadable in {cfg.run.data_dir!r}; "
              "using synthetic")
    return SyntheticSeq2Seq(
        vocab_size=vocab, src_len=cfg.model.src_len,
        tgt_len=cfg.model.tgt_len, batch_size=cfg.run.batch_size,
    )


def main(argv=None, *, data=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    device = device_of(cfg.run.device)

    vocab = 512 if cfg.model.size == "test" else cfg.model.vocab_size
    model = TransformerMT(cfg.model.size, vocab_size=vocab,
                          max_seq_len=max(cfg.model.src_len, cfg.model.tgt_len))
    if data is None:
        data = _dataset(cfg, vocab)
    ad = tad.AutoDistribute(
        model,
        optimizer=adamw(cfg.run.lr, weight_decay=0.0),  # optax.adam
        loss_fn=seq2seq_loss,
        strategy=cfg.parallel.strategy,
        device=device,
    )
    metrics = MetricsLogger(
        cfg.run.metrics_path or None,
        items_name="tokens",
        console_every=cfg.run.log_every,
        device=device,
    )
    trainer = Trainer(
        ad,
        TrainerConfig(steps=cfg.run.steps, log_every=cfg.run.log_every),
        metrics=metrics,
        items_per_step=cfg.run.batch_size * cfg.model.tgt_len,
        run_config=cfglib.to_dict(cfg),
    )
    state = trainer.fit(iter(data))
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)}")
    return {"state": state, "trainer": trainer, "data": data}


if __name__ == "__main__":
    main()
