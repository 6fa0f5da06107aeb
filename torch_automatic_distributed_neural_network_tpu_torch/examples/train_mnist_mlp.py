"""Train the 3-layer MLP on (synthetic) MNIST with AutoDistribute: the
JAX package's ``examples/train_mnist_mlp.py`` on the port.  Run::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_mnist_mlp \\
        --steps 50
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_mnist_mlp \\
        --device cpu --steps 50 --out-dir /tmp/mnist

One flag more than the JAX example: ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  ``main`` returns the final
state, the ``AutoDistribute`` and the data source (and the trainer with
``--out-dir``); ``data=`` replaces the configured source.
"""

import argparse
import os
import time

import torch

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data import (
    classification_dataset,
    load_mnist,
)
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import (
    SyntheticClassification,
)
from torch_automatic_distributed_neural_network_tpu_torch.examples.common import device_of
from torch_automatic_distributed_neural_network_tpu_torch.models import MLP
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    sgd,
    softmax_xent_loss,
)


def main(argv=None, *, data=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--strategy", default="auto",
                   choices=["auto", "tuned", "dp", "fsdp", "tp", "tp_fsdp"])
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data-dir", default="",
                   help="dir with MNIST idx files or x_train/y_train.npy; "
                        "falls back to synthetic when empty/absent")
    p.add_argument("--out-dir", default="",
                   help="write run artifacts (journal.jsonl + "
                        "metrics.jsonl) here and train via Trainer")
    p.add_argument("--device", default="cuda",
                   help="'cpu' runs the plain PyTorch path")
    p.add_argument("--no-preflight", dest="preflight", action="store_false",
                   help="skip the Trainer's static lint before step 0")
    args = p.parse_args(argv)

    device = device_of(args.device)
    if data is None:
        data = classification_dataset(
            args.data_dir, load_mnist, args.batch_size,
            fallback=lambda: SyntheticClassification(
                batch_size=args.batch_size),
        )
    ad = tad.AutoDistribute(
        MLP(features=(512, 256, 10)),
        optimizer=sgd(args.lr),
        loss_fn=softmax_xent_loss,
        strategy=args.strategy,
        device=device,
    )
    if args.out_dir:
        return run_observed(args, data, ad, device)
    state = ad.init(torch.Generator(device=device).manual_seed(0),
                    data.batch(0))
    print(f"plan: strategy={ad.plan.strategy} "
          f"mesh={tad.mesh_degrees(ad.plan.mesh)}")

    t0 = time.perf_counter()
    for i in range(args.steps):
        state, metrics = ad.step(state, data.batch(i))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(
                f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                f"acc {float(metrics['accuracy']):.3f}"
            )
    dt = time.perf_counter() - t0
    imgs = args.steps * args.batch_size
    print(f"{imgs / dt:.0f} images/sec total "
          f"({imgs / dt / tad.topology.detect().num_devices:.0f} /chip "
          f"incl. the first step)")
    return {"state": state, "ad": ad, "data": data}


def run_observed(args, data, ad, device) -> dict:
    """--out-dir path: the same training via Trainer, leaving
    journal.jsonl + metrics.jsonl behind."""
    from torch_automatic_distributed_neural_network_tpu_torch.obs import Journal
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        MetricsLogger,
        Trainer,
        TrainerConfig,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    journal = Journal(os.path.join(args.out_dir, "journal.jsonl"))
    metrics = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"),
                            items_name="images", device=device)
    trainer = Trainer(
        ad,
        TrainerConfig(steps=args.steps, log_every=args.log_every,
                      preflight=args.preflight),
        metrics=metrics,
        items_per_step=args.batch_size,
        journal=journal,
    )
    state = trainer.fit(data)
    journal.close()
    gp = trainer.goodput or {}
    if gp.get("fractions"):
        print("goodput: " + "  ".join(
            f"{k} {v:.1%}" for k, v in gp["fractions"].items()))
    print(f"artifacts in {args.out_dir}")
    return {"state": state, "ad": ad, "data": data, "trainer": trainer}


if __name__ == "__main__":
    main()
