"""LoRA fine-tuning: adapt a frozen checkpoint with low-rank factors —
the JAX package's ``examples/finetune_lora.py`` on the port.

Bring weights, freeze them, train rank-r factors on the attention and
MLP weights: optimizer state exists ONLY for the factors (no Adam
moments for the base), and ``merge_lora`` folds the result back into
plain weights that a ``DecoderLM`` loads.  Without a checkpoint at hand,
the script stands one up by briefly pretraining on the synthetic stream,
then fine-tunes from it.

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.finetune_lora \\
        run.steps=50 lora.rank=16
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.finetune_lora \\
        run.device=cpu run.pretrain_steps=5 run.steps=5

One field more than the JAX example: ``run.device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  ``main`` returns the fine-tuned
state, the ``AutoDistribute``, the merged weights and the counts, so a
caller can check the run.
"""

import dataclasses
import sys

import torch

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data.synthetic import SyntheticLM
from torch_automatic_distributed_neural_network_tpu_torch.models import GPT2
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    adamw,
    next_token_loss,
)
from torch_automatic_distributed_neural_network_tpu_torch.training.lora import (
    LoraSpec,
    LoraTarget,
    is_lora_name,
    lora_init_fn,
    lora_loss,
    lora_optimizer,
    lora_state,
    merge_lora,
)
from torch_automatic_distributed_neural_network_tpu_torch.training.optim import tree_map
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib
from torch_automatic_distributed_neural_network_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "test"
    seq_len: int = 64
    vocab_size: int = 512


@dataclasses.dataclass(frozen=True)
class LoraCfg:
    rank: int = 16
    alpha: float = 32.0


@dataclasses.dataclass(frozen=True)
class RunCfg:
    pretrain_steps: int = 30  # stand-in for "load a checkpoint"
    steps: int = 40
    batch_size: int = 16
    lr: float = 3e-3
    log_every: int = 10
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    strategy: str = "auto"


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    lora: LoraCfg = LoraCfg()
    run: RunCfg = RunCfg()
    parallel: ParallelCfg = ParallelCfg()


def _elements(tree) -> int:
    """Tensor elements in a nested optimizer state."""
    count = [0]

    def add(x):
        if isinstance(x, torch.Tensor):
            count[0] += x.numel()

    tree_map(add, tree)
    return count[0]


def main(argv=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    device = resolve_device(None if cfg.run.device == "cuda"
                            else cfg.run.device)

    def model():
        return GPT2(cfg.model.size, vocab_size=cfg.model.vocab_size,
                    max_seq_len=cfg.model.seq_len)

    data = SyntheticLM(vocab_size=cfg.model.vocab_size,
                       seq_len=cfg.model.seq_len + 1,
                       batch_size=cfg.run.batch_size)

    # "the checkpoint": a briefly full-trained base
    ad0 = tad.AutoDistribute(model(), optimizer=adamw(cfg.run.lr),
                             loss_fn=next_token_loss, strategy="dp",
                             device=device)
    state = ad0.init(torch.Generator(device).manual_seed(0), data.batch(0))
    m = {}
    for i in range(cfg.run.pretrain_steps):
        state, m = ad0.step(state, data.batch(i))
    if m:
        print(f"base checkpoint ready: loss {float(m['loss']):.4f}")
    base = {n: t.detach().clone() for n, t in state.params.items()}

    spec = LoraSpec(rank=cfg.lora.rank, alpha=cfg.lora.alpha,
                    targets=(LoraTarget(r"q_proj\.weight$", 1, 1, True),
                             LoraTarget(r"v_proj\.weight$", 1, 1, True),
                             LoraTarget(r"up_proj\.weight$", 1, 1, True)))
    ad = tad.AutoDistribute(
        model(),
        optimizer=lora_optimizer(adamw(cfg.run.lr)),
        loss_fn=lora_loss(next_token_loss, spec),
        init_fn=lora_init_fn(base, spec),
        strategy=cfg.parallel.strategy,
        device=device,
    )
    st = ad.init(torch.Generator(device).manual_seed(2), data.batch(0))
    n_base = sum(t.numel() for n, t in st.params.items()
                 if not is_lora_name(n))
    n_lora = sum(t.numel() for n, t in st.params.items() if is_lora_name(n))
    n_opt = _elements(st.opt_state)
    print(f"base {n_base:,} params (frozen)  adapters {n_lora:,} "
          f"({100 * n_lora / n_base:.2f}%)  opt state {n_opt:,} elements "
          "(adapters only)")
    start = cfg.run.pretrain_steps
    for i in range(start, start + cfg.run.steps):
        st, m = ad.step(st, data.batch(i))
        if (i - start) % cfg.run.log_every == 0:
            print(f"step {i - start:4d}  loss {float(m['loss']):.4f}")
    if m:
        print(f"final loss {float(m['loss']):.4f}  "
              f"plan={ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)}")
    merged = merge_lora(base, lora_state(ad.model), spec)
    print("adapters merged back into plain weights (export-ready)")
    return {"state": st, "ad": ad, "merged": merged, "n_base": n_base,
            "n_lora": n_lora, "n_opt": n_opt}


if __name__ == "__main__":
    main()
