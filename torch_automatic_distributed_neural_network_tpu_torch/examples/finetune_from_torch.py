"""Migrate from the torch reference in one script: HF or torch weights in,
fine-tuning and generation out — the JAX package's
``examples/finetune_from_torch.py`` on the port.

The workflow a user of the reference follows to switch: build or load a
model (an HF GPT-2 checkpoint, or their own ``nn.Module``), bring its
weights over, keep the torch ``Dataset`` too
(``data/torch_adapter.py``), and hand both to ``AutoDistribute``.  Two
sources:

- ``model.source=hf`` (default): an HF checkpoint through
  ``import_hf_gpt2`` (needs ``transformers``); without ``model.path`` a
  small random one is built offline;
- ``model.source=torch``: the HAND-WRITTEN ``nn.Module`` below (attention
  and all) through ``models.from_torch``: "AutoDistribute(model) runs an
  unmodified nn.Module", with no HF involvement.

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.finetune_from_torch \\
        run.steps=30
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.finetune_from_torch \\
        model.source=torch run.device=cpu
    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.finetune_from_torch \\
        model.path=/path/to/hf_gpt2

One field more than the JAX example: ``run.device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  ``main`` returns the final
state, the ``AutoDistribute``, the trainer and the generated ids.
"""

import dataclasses
import sys

import numpy as np
import torch

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.data import TorchDatasetAdapter
from torch_automatic_distributed_neural_network_tpu_torch.examples.common import device_of
from torch_automatic_distributed_neural_network_tpu_torch.models import (
    from_torch,
    import_hf_gpt2,
)
from torch_automatic_distributed_neural_network_tpu_torch.training import (
    Trainer,
    TrainerConfig,
    adamw,
    next_token_loss,
    next_token_loss_mutable,
)
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    source: str = "hf"  # 'hf' | 'torch' (the hand-written nn.Module below)
    path: str = ""  # HF checkpoint dir; "" = build a small random one
    seq_len: int = 64


@dataclasses.dataclass(frozen=True)
class RunCfg:
    steps: int = 30
    batch_size: int = 16
    lr: float = 1e-4
    log_every: int = 10
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


class TokenDataset:
    """A torch-style map Dataset of token windows (stands in for the
    user's own torch.utils.data pipeline)."""

    def __init__(self, vocab: int, seq_len: int, n: int = 2048):
        rng = np.random.RandomState(0)
        first = rng.randint(0, vocab, (n, 1))
        steps = rng.randint(0, 7, (n, seq_len))
        self._tok = (np.concatenate([first, np.cumsum(steps, -1) + first], -1)
                     % vocab).astype(np.int32)

    def __len__(self):
        return len(self._tok)

    def __getitem__(self, i):
        return {"tokens": self._tok[i]}


def build_handwritten_torch_lm(vocab: int, seq: int, d: int = 128,
                               heads: int = 4):
    """An ordinary from-scratch torch LM, nothing framework-specific:
    ``from_torch`` traces it (attention, the mask buffer, the weight
    plumbing) and carries its weights over."""
    import torch.nn as tnn

    class HandWrittenLM(tnn.Module):
        def __init__(self):
            super().__init__()
            self.emb = tnn.Embedding(vocab, d)
            self.pos = tnn.Parameter(torch.randn(1, seq, d) * 0.02)
            self.ln1 = tnn.LayerNorm(d)
            self.qkv = tnn.Linear(d, 3 * d)
            self.proj = tnn.Linear(d, d)
            self.ln2 = tnn.LayerNorm(d)
            self.mlp_up = tnn.Linear(d, 4 * d)
            self.mlp_down = tnn.Linear(4 * d, d)
            self.ln_f = tnn.LayerNorm(d)
            self.head = tnn.Linear(d, vocab, bias=False)
            self.heads = heads
            self.register_buffer("mask", torch.tril(torch.ones(seq, seq)))

        def forward(self, idx):
            b, t = idx.size(0), idx.size(1)
            x = self.emb(idx) + self.pos[:, :t]
            h = self.ln1(x)
            q, k, v = self.qkv(h).chunk(3, dim=-1)
            hd = q.size(-1) // self.heads
            q = q.view(b, t, self.heads, hd).transpose(1, 2)
            k = k.view(b, t, self.heads, hd).transpose(1, 2)
            v = v.view(b, t, self.heads, hd).transpose(1, 2)
            att = torch.matmul(q, k.transpose(-2, -1)) / (hd ** 0.5)
            att = att.masked_fill(self.mask[:t, :t] == 0, float("-inf"))
            att = torch.softmax(att, dim=-1)
            o = torch.matmul(att, v).transpose(1, 2).contiguous()
            x = x + self.proj(o.view(b, t, -1))
            h = self.ln2(x)
            x = x + self.mlp_down(torch.nn.functional.gelu(self.mlp_up(h)))
            return self.head(self.ln_f(x))

    torch.manual_seed(0)
    return HandWrittenLM()


def main(argv=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    device = device_of(cfg.run.device)

    bridged = cfg.model.source == "torch"
    if bridged:
        net = build_handwritten_torch_lm(512, cfg.model.seq_len)
        model, params = from_torch(net)
        n_params = sum(p.numel() for p in net.parameters())
        print(f"bridged hand-written torch LM: {n_params/1e6:.1f}M params")
    else:
        import transformers

        if cfg.model.path:
            hf = transformers.GPT2LMHeadModel.from_pretrained(cfg.model.path)
        else:
            # offline stand-in for a real checkpoint
            hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
                vocab_size=512, n_positions=cfg.model.seq_len, n_embd=128,
                n_layer=4, n_head=2))
        model, params = import_hf_gpt2(hf, device=device)
        print(f"imported: {model.cfg.n_layers}L d={model.cfg.d_model} "
              f"vocab={model.cfg.vocab_size}")

    data = TorchDatasetAdapter(
        TokenDataset(512 if bridged else model.cfg.vocab_size,
                     cfg.model.seq_len),
        batch_size=cfg.run.batch_size)
    ad = tad.AutoDistribute(
        model,
        optimizer=adamw(cfg.run.lr),
        loss_fn=next_token_loss_mutable if bridged else next_token_loss,
        strategy=cfg.parallel.strategy,
        init_fn=lambda m, generator: m.load_state_dict(params),
        device=device,
    )
    trainer = Trainer(ad, TrainerConfig(steps=cfg.run.steps,
                                        log_every=cfg.run.log_every,
                                        preflight=cfg.run.preflight))
    state = trainer.fit(data)
    print(f"plan: {ad.plan.strategy} mesh={tad.mesh_degrees(ad.plan.mesh)} "
          f"final_step={int(state.step)}")

    if bridged:
        # the bridged graph re-executes the torch forward and has no
        # decode cache: sample by full-context argmax
        toks = torch.as_tensor(data.batch(0)["tokens"][:1, :8],
                               device=ad.device)
        for _ in range(8):
            nxt = ad(state, toks)[:, -1].argmax(-1)[:, None].to(toks.dtype)
            toks = torch.cat([toks, nxt], dim=1)
        generated = toks.cpu().numpy()
    else:
        # greedy decoding from the fine-tuned weights
        prompt = data.batch(0)["tokens"][:1, :8]
        generated = np.asarray(ad.generate(state, prompt, max_new_tokens=16)
                               .cpu())
    print("generated ids:", generated[0].tolist())
    return {"state": state, "ad": ad, "trainer": trainer,
            "generated": generated}


if __name__ == "__main__":
    main()
