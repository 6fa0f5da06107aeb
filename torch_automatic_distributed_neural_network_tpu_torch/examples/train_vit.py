"""Train a Vision Transformer on (synthetic) CIFAR-10-shaped data: the
JAX package's ``examples/train_vit.py`` on the port.

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_vit \\
        run.steps=100
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_vit \\
        model.size=base model.image_size=224 model.patch_size=16 \\
        model.num_classes=1000
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_vit \\
        data.dir=/path/to/cifar-10-batches-py
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_vit \\
        run.device=cpu run.steps=5

Images are [B, H, W, C], as in the JAX package.  One field more than the
JAX example: ``run.device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path).  ``main`` returns the final state, the trainer and the
data source; ``data=`` replaces the configured source.
"""

import dataclasses
import sys

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data import (
    classification_dataset,
    load_cifar10,
)
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import (
    SyntheticClassification,
)
from torch_automatic_distributed_neural_network_tpu_torch.examples.common import device_of
from torch_automatic_distributed_neural_network_tpu_torch.models import ViT
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    adamw,
    softmax_xent_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "test"  # test | base | large (models/vit.py)
    image_size: int = 32
    patch_size: int = 8
    num_classes: int = 10


@dataclasses.dataclass(frozen=True)
class DataCfg:
    dir: str = ""  # cifar-10-batches-py dir; "" = synthetic teacher


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 50
    batch_size: int = 64
    lr: float = 3e-3
    log_every: int = 10
    metrics_path: str = ""
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    strategy: str = "auto"


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    data: DataCfg = DataCfg()
    run: RunCfg = RunCfg()
    parallel: ParallelCfg = ParallelCfg()


def main(argv=None, *, data=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    device = device_of(cfg.run.device)

    model = ViT(cfg.model.size, image_size=cfg.model.image_size,
                patch_size=cfg.model.patch_size,
                num_classes=cfg.model.num_classes)
    shape = (cfg.model.image_size, cfg.model.image_size, 3)
    if data is None:
        data = classification_dataset(
            cfg.data.dir, load_cifar10, cfg.run.batch_size,
            fallback=lambda: SyntheticClassification(
                image_shape=shape, num_classes=cfg.model.num_classes,
                batch_size=cfg.run.batch_size,
            ),
        )
    ad = tad.AutoDistribute(
        model,
        optimizer=adamw(cfg.run.lr),
        loss_fn=softmax_xent_loss,
        strategy=cfg.parallel.strategy,
        device=device,
    )
    ad.build_plan(None, data.batch(0))
    metrics = MetricsLogger(
        cfg.run.metrics_path or None,
        items_name="images",
        console_every=cfg.run.log_every,
        device=device,
    )
    trainer = Trainer(
        ad,
        TrainerConfig(steps=cfg.run.steps, log_every=cfg.run.log_every),
        metrics=metrics,
        items_per_step=cfg.run.batch_size,
        run_config=cfglib.to_dict(cfg),
    )
    state = trainer.fit(data)
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)} "
          f"params={model.cfg.num_params()/1e6:.1f}M "
          f"final_step={int(state.step)}")
    return {"state": state, "trainer": trainer, "data": data}


if __name__ == "__main__":
    main()
