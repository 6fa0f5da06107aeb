"""Train ResNet-50 on (synthetic) CIFAR-10, data-parallel: the JAX
package's ``examples/train_resnet_cifar.py`` on the port
(BASELINE.json's "ResNet-50 / CIFAR-10 data-parallel"; its metric is
images a second).

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_resnet_cifar \\
        run.steps=100 run.batch_size=256
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_resnet_cifar \\
        model.arch=thin run.device=cpu     # the CPU's scale
    torchrun --nproc-per-node 2 -m \\
        torch_automatic_distributed_neural_network_tpu_torch.examples.train_resnet_cifar \\
        model.arch=thin run.device=cpu     # DDP, BatchNorm over the global batch

Images are [B, H, W, C], as in the JAX package.  One field more than the
JAX example: ``run.device`` (default ``cuda``, ``cuda:LOCAL_RANK`` under
``torchrun``; ``cpu`` runs the plain PyTorch path).  ``main`` returns
the final state, the trainer and the data source; ``data=`` replaces
the configured source.
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
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    ResNet18Thin,
    ResNet50,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    sgd,
    softmax_xent_loss_mutable,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    arch: str = "resnet50"  # resnet50 | thin


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 50
    batch_size: int = 128
    lr: float = 0.1
    log_every: int = 10
    metrics_path: str = ""
    # dir with cifar-10-batches-py pickles or x_train/y_train.npy;
    # synthetic fallback when empty/absent
    data_dir: str = ""
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path
    # the static lint before step 0 (TrainerConfig.preflight: the step
    # traced on fake tensors, ~10 s for GPT-2 small); False skips it
    preflight: bool = True


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    strategy: str = "dp"


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    run: RunCfg = RunCfg()
    parallel: ParallelCfg = ParallelCfg()


def main(argv=None, *, data=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    tad.topology.initialize_distributed()  # a no-op outside torchrun
    device = device_of(cfg.run.device)

    if cfg.model.arch == "thin":
        model = ResNet18Thin(num_classes=10)
        image_shape = (16, 16, 3)
    else:
        model = ResNet50(num_classes=10, small_inputs=True)
        image_shape = (32, 32, 3)
    if data is None:
        data = classification_dataset(
            cfg.run.data_dir, load_cifar10, cfg.run.batch_size,
            fallback=lambda: SyntheticClassification(
                image_shape=image_shape, num_classes=10,
                batch_size=cfg.run.batch_size,
            ),
        )
        if not isinstance(data, SyntheticClassification) and (
                data.x.shape[1:] != image_shape):
            raise SystemExit(
                f"loaded images {data.x.shape[1:]} do not match the model's "
                f"expected {image_shape} (arch={cfg.model.arch})")
    ad = tad.AutoDistribute(
        model,
        optimizer=sgd(cfg.run.lr, momentum=0.9),
        loss_fn=softmax_xent_loss_mutable,
        strategy=cfg.parallel.strategy,
        device=device,
    )
    ad.build_plan(None, data.batch(0))
    metrics = MetricsLogger(
        cfg.run.metrics_path or None,
        items_name="images",
        flops_per_step=model.cfg.train_step_flops(image_shape[:2],
                                                  cfg.run.batch_size),
        console_every=cfg.run.log_every,
        device=device,
    )
    trainer = Trainer(
        ad,
        TrainerConfig(steps=cfg.run.steps, log_every=cfg.run.log_every,
                      preflight=cfg.run.preflight),
        metrics=metrics,
        items_per_step=cfg.run.batch_size,
        run_config=cfglib.to_dict(cfg),
    )
    state = trainer.fit(data)
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)} "
          f"final_step={int(state.step)}")
    return {"state": state, "trainer": trainer, "data": data}


if __name__ == "__main__":
    main()
