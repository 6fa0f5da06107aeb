"""Autoregressive generation: the JAX package's
``examples/generate_text.py`` on the port.

With random weights the output is noise; the point is the decode path
and its throughput: one prefill pass, then one-token steps
(``inference/decode.py``).

Usage::

    python -m torch_automatic_distributed_neural_network_tpu_torch.examples.generate_text \\
        model.size=small run.new_tokens=64
    ... run.quant=int8          # int8 weights
    ... run.speculative=1       # a draft proposes, the model verifies
    ... model.size=test model.vocab_size=256 run.device=cpu
    # the plan-aware sharded decode, one process a device:
    torchrun --nproc-per-node 2 -m torch_automatic_distributed_neural_network_tpu_torch.examples.generate_text \
        run.strategy=tp

The one field beyond the JAX example's is ``run.device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path and, under ``torchrun``,
a gloo group).  ``run.strategy`` other than ``none`` decodes through
``AutoDistribute.generate`` under that strategy's plan: the weights
sharded as the plan shards them, each rank its rows and kv heads.
``main`` returns the output tokens, the model, the prompt and the timed
run's tokens/s.
"""

import dataclasses
import sys
import time

import numpy as np
import torch

from torch_automatic_distributed_neural_network_tpu_torch.inference.decode import (
    SampleConfig,
    generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.quant import (
    quantize_for_decode,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.speculative import (
    speculative_generate,
)
from torch_automatic_distributed_neural_network_tpu_torch.models import GPT2
from torch_automatic_distributed_neural_network_tpu_torch.utils import config as cfglib
from torch_automatic_distributed_neural_network_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    size: str = "small"
    vocab_size: int = 50257


@dataclasses.dataclass(frozen=True)
class RunCfg:
    batch_size: int = 4
    prompt_len: int = 32
    new_tokens: int = 64
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 1.0  # nucleus sampling; 1.0 = off
    eos_id: int = -1  # >= 0: rows finalize after emitting this token
    # 'none' -> plain decode on one device; a planner strategy ('tp',
    # 'tp_fsdp', 'fsdp', 'dp') -> the plan-aware sharded decode
    # (AutoDistribute.generate)
    strategy: str = "none"
    quant: str = "none"  # 'int8': weight-only quantized decode
    # 1: greedy speculative decoding (batch 1, temperature ignored) — a
    # 1-layer draft proposes, the full model verifies; the output is
    # plain greedy decoding of the full model
    speculative: int = 0
    spec_k: int = 4
    device: str = "cuda"  # 'cpu' runs the plain PyTorch path


@dataclasses.dataclass(frozen=True)
class Cfg:
    model: ModelCfg = ModelCfg()
    run: RunCfg = RunCfg()


def main(argv=None) -> dict:
    cfg: Cfg = cfglib.apply_overrides(
        Cfg(), sys.argv[1:] if argv is None else argv)
    print(cfglib.to_json(cfg))
    r = cfg.run
    if r.quant not in ("none", "int8"):
        raise SystemExit(f"unknown run.quant={r.quant!r}; "
                         "supported: none, int8")
    if r.speculative and (r.strategy != "none" or r.quant != "none"
                          or r.eos_id >= 0):
        # a silently dropped flag would attribute the tok/s line to a
        # config that never ran
        raise SystemExit("run.speculative=1 is plain greedy decode: it "
                         "does not compose with run.strategy / run.quant "
                         "/ run.eos_id")
    if r.strategy != "none":
        from torch_automatic_distributed_neural_network_tpu_torch import topology

        topology.initialize_distributed()  # a no-op outside torchrun
    device = resolve_device(None if r.device == "cuda" else r.device)
    # speculative rounds need k+1 positions of headroom past the last
    # emitted token; build the model once with the right table size
    seq_budget = r.prompt_len + r.new_tokens + (
        r.spec_k + 1 if r.speculative else 0)
    batch = 1 if r.speculative else r.batch_size
    with torch.device(device):
        model = GPT2(cfg.model.size, vocab_size=cfg.model.vocab_size,
                     max_seq_len=seq_budget)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.model.vocab_size, size=(batch, r.prompt_len))).to(device)
    eos = r.eos_id if r.eos_id >= 0 else None
    sample = SampleConfig(temperature=r.temperature, top_k=r.top_k,
                          top_p=r.top_p)

    if r.speculative:
        with torch.device(device):
            draft = GPT2(cfg.model.size, vocab_size=cfg.model.vocab_size,
                         max_seq_len=seq_budget, n_layers=1)
        draft.init_weights(torch.Generator(device=device).manual_seed(7))

        def gen(seed):
            return speculative_generate(model, draft, prompt,
                                        max_new_tokens=r.new_tokens,
                                        k=r.spec_k)
    elif r.strategy != "none":
        from torch_automatic_distributed_neural_network_tpu_torch import (
            AutoDistribute,
            next_token_loss,
            sgd,
        )

        ad = AutoDistribute(model, optimizer=sgd(0.1),
                            loss_fn=next_token_loss, strategy=r.strategy,
                            device=device)
        state = ad.init(None, {"input_ids": np.zeros(
            (batch, r.prompt_len + 1), np.int64)})
        print(f"plan: strategy={ad.plan.strategy} mesh={ad.plan.degrees}")

        def gen(seed):
            g = torch.Generator(device=device).manual_seed(seed)
            return ad.generate(state, prompt, max_new_tokens=r.new_tokens,
                               sample=sample, generator=g, eos_id=eos,
                               quant=None if r.quant == "none" else r.quant)
    else:
        if r.quant == "int8":
            model = quantize_for_decode(model)

        def gen(seed):
            g = torch.Generator(device=device).manual_seed(seed)
            return generate(model, prompt, max_new_tokens=r.new_tokens,
                            sample=sample, generator=g, eos_id=eos)

    def timed(seed):
        t0 = time.perf_counter()
        out = gen(seed).cpu().numpy()  # the copy waits for the device
        return out, time.perf_counter() - t0

    _, dt = timed(1)
    print(f"first generate: {dt:.1f}s")
    out, dt = timed(2)
    total_new = batch * r.new_tokens
    print(f"generated {total_new} tokens in {dt*1e3:.0f}ms "
          f"({total_new/dt:,.0f} tok/s)")
    print("sample token ids:", out[0, r.prompt_len:][:16])
    return {"tokens": out, "model": model, "prompt": prompt,
            "tokens_per_s": total_new / dt}


if __name__ == "__main__":
    main()
