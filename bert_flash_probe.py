#!/usr/bin/env python3
"""How well ``chip_smoke.py``'s BERT checks see a faulty flash kernel, and
how far each bf16 attention path's q/k/v gradients sit from fp32.

    python3 bert_flash_probe.py      # from the root of a checkout, one card

BERT base MLM at B 8 x S 512 (bf16, random weights from a seed, one
batch of ``SyntheticMLM``, as in the smoke's ``zoo`` phase), through
``examples/train_bert_mlm.py``.  One JSON line a part:

1. ``calls``: at the weights after 10 steps, one step's K1-K3 calls, each
   also made by its plain version on the very same tensors (the smoke's
   gate), sound and with a fault patched into one wrapper's output: a
   lost dq tile (the last 64 query rows), one lost dq row, dq doubled, a
   lost dk/dv tile (the last 64 keys), one lost o row;
2. ``gradients``: at the same weights, each layer's q, k and v projection
   weight gradient through the kernels, through their plain versions in
   the same algorithm, and through the plain attention in bf16, each as
   ``|g - g_fp32| / |g_fp32|`` against the plain attention in fp32;
3. ``losses``: 3 steps from the seed's weights through the kernels,
   sound and with a fault patched into the autograd backward (the lost
   dq tile, the lost dk/dv tile, dq doubled), against the plain
   attention's 3 losses; and, at the weights of part 2, each fault's q,
   k and v gradients against the plain attention's in bf16.

The patches live in this process only; no file changes.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import re
import sys

import chip_smoke as cs

_ARGV = ["model.size=base", "model.seq_len=512", "run.batch_size=8"]
_QKV = re.compile(r"\.attn\.[qkv]_proj\.weight$")


def _output_fault(which, kernel):
    """``kernel`` (a flash wrapper) with ``which`` done to its output."""
    def call(*args, **kw):
        out = kernel(*args, **kw)
        if which == "dq_tile":
            out = out.clone()
            out[:, 448:] = 0
        elif which == "dq_row":
            out = out.clone()
            out[:, 511:] = 0
        elif which == "dq_x2":
            out = 2 * out
        elif which == "dkv_tile":
            dk, dv = out[0].clone(), out[1].clone()
            dk[:, 448:] = 0
            dv[:, 448:] = 0
            out = (dk, dv)
        elif which == "o_row":
            o, lse = out
            o = o.clone()
            o[:, 511:] = 0
            out = (o, lse)
        return out
    return call


def _backward_fault(which, backward):
    """The flash autograd backward with ``which`` done to (dq, dk, dv)."""
    def call(ctx, do, dlse):
        dq, dk, dv = backward(ctx, do, dlse)
        if which == "dq_tile":
            dq = dq.clone()
            dq[:, 448:] = 0
        elif which == "dkv_tile":
            dk, dv = dk.clone(), dv.clone()
            dk[:, 448:] = 0
            dv[:, 448:] = 0
        elif which == "dq_x2":
            dq = 2 * dq
        return dq, dk, dv
    return call


def _qkv_grads(torch, model, batch) -> dict:
    """Each q, k and v projection weight gradient of the MLM loss on
    ``batch`` at ``model``'s weights, fp32 on the host."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import \
        masked_lm_loss

    names, params = zip(*model.named_parameters())
    loss, _ = masked_lm_loss(model, batch, None)
    grads = torch.autograd.grad(loss, params)
    return {n: g.float().cpu() for n, g in zip(names, grads)
            if _QKV.search(n)}


def _rel(got: dict, want: dict) -> dict:
    return {n: float((got[n] - w).norm() / w.norm()) for n, w in want.items()}


def _by_projection(rel: dict) -> dict:
    """The smallest and largest of ``rel`` over the layers, per q, k, v."""
    out = {}
    for p in "qkv":
        vals = [v for n, v in rel.items() if f".{p}_proj." in n]
        out[p] = [min(vals), max(vals)]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bert_flash_probe: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA device", file=sys.stderr)
        return 1
    from torch_automatic_distributed_neural_network_tpu_torch.data import \
        SyntheticMLM
    from torch_automatic_distributed_neural_network_tpu_torch.models.bert \
        import BertEncoder
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mlm = cs._OneBatch(SyntheticMLM(vocab_size=30522, seq_len=512,
                                    batch_size=8).batch(0))
    kernels = {name: getattr(fa, name) for name in cs._FLASH_NAMES}

    _, out = cs._zoo_run(torch, "bert-base-mlm", "train_bert_mlm", _ARGV,
                         mlm, steps=10, items=8 * 512, keep=True)
    ad = out["trainer"].ad
    batch = ad._to_device(mlm.batch(0))

    # 1. every call against its plain version, sound and with faults
    calls = {}
    for which, name in (("none", None), ("dq_tile", "flash_dq"),
                        ("dq_row", "flash_dq"), ("dq_x2", "flash_dq"),
                        ("dkv_tile", "flash_dkv"),
                        ("o_row", "flash_forward")):
        if name:
            setattr(fa, name, _output_fault(which, kernels[name]))
        try:
            _, n, errs = cs._checked_calls(
                lambda: ad._value_and_grad(batch, None))
        finally:
            for key, kernel in kernels.items():
                setattr(fa, key, kernel)
        calls[which] = {"calls": n, "rel_err": errs}
    cs.emit({"part": "calls", "bound": cs._PATH_CALL_BOUND, **calls})

    # 2. gradients against fp32 at the same weights
    state = ad.model.state_dict()

    def model_with(**kw):
        m = BertEncoder(dataclasses.replace(ad.model.cfg, **kw)).cuda()
        m.load_state_dict(state)
        return m

    grads = {"kernels": _qkv_grads(torch, ad.model, batch)}
    for name in cs._FLASH_NAMES:
        setattr(fa, name, getattr(fa, f"{name}_reference"))
    try:
        grads["plain_versions"] = _qkv_grads(torch, ad.model, batch)
    finally:
        for key, kernel in kernels.items():
            setattr(fa, key, kernel)
    grads["xla_bf16"] = _qkv_grads(torch, model_with(attention_impl="xla"),
                                   batch)
    fp32 = _qkv_grads(torch, model_with(attention_impl="xla",
                                        dtype=torch.float32), batch)
    cs.emit({"part": "gradients",
             "norm_fp32": {n: float(g.norm()) for n, g in fp32.items()},
             **{k: _rel(g, fp32) for k, g in grads.items()},
             "kernels_vs_plain_versions": _rel(grads["kernels"],
                                               grads["plain_versions"]),
             "kernels_vs_xla_bf16": _rel(grads["kernels"],
                                         grads["xla_bf16"])})

    # 3. losses of 3 steps and gradients under a faulty backward
    plain = cs._zoo_run(torch, "bert-base-mlm-xla", "train_bert_mlm",
                        _ARGV + ["model.attention_impl=xla"], mlm, steps=3,
                        items=8 * 512)
    backward = fa._backward
    losses = {}
    for which in ("none", "dq_tile", "dkv_tile", "dq_x2"):
        if which != "none":
            fa._backward = _backward_fault(which, backward)
        try:
            rec = cs._zoo_run(torch, f"bert-{which}", "train_bert_mlm",
                              _ARGV, mlm, steps=3, items=8 * 512)
            g = _qkv_grads(torch, ad.model, batch)
        finally:
            fa._backward = backward
        losses[which] = {
            "losses": rec["losses"],
            "diffs": [abs(a - b) for a, b in zip(rec["losses"],
                                                 plain["losses"])],
            "grad_vs_xla_bf16": _by_projection(
                _rel(g, grads["xla_bf16"]))}
    cs.emit({"part": "losses", "plain": plain["losses"],
             "bound": cs._BERT_LOSS_BOUND, **losses})
    return 0


if __name__ == "__main__":
    sys.exit(main())
