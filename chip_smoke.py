#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (one NVIDIA Hopper GPU).

    python3 chip_smoke.py        # from the root of a checkout

Drives ``torch_automatic_distributed_neural_network_tpu_torch`` on the
card, in phases, one JSON line each; any failure exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), its
   compute capability (sm_90 required);
2. build: compiles every CUDA kernel from ``csrc/`` with ``nvcc`` for
   sm_90a, all three sources at once, and counts the tensor-core
   (HGMMA) and TMA (UTMALDG) instructions in the tensor-core flash
   library's SASS (``cuobjdump``), in all and in each of K1-K3's
   kernels, every one of which must hold HGMMA;
3. kernel vs plain version: the paged-attention kernel against
   ``paged_attention_reference`` on the same inputs, at the GPT-2 small,
   Llama 1b and Llama 8b attention geometries and GPT-2 small's width in
   8 heads (head dim 96), block sizes 8 and 16,
   fp32/bf16/int8 pools, with and without a sliding window, fp32 and
   bf16 queries; bounds 1e-4 (fp32 q) and 2e-2 (bf16 q); then its split
   context where the splits outnumber the attended pages (ctx 0, short
   contexts, windows that empty whole splits) at the wrapper's split
   count and at 2, 7 and 16, each launched twice and bitwise equal, and
   a slot with no attended key giving zeros; then aliased block tables,
   as prefix-cache hits make them (8 slots sharing 12 blocks at
   refcount 8, two of them 2 more, bf16 and int8 pools), under the same
   bounds;
4. timing at the GPT-2 small decode shape (8 slots at ctx 1023, bf16
   pool): median of many launches with the L2 cache flushed before
   each, beside the plain version and the least time the card could
   take (bytes over the HBM rate, flops over the fp32 rate), the split
   count, the achieved GB/s and a sweep of split counts 2 to 16; beside
   them the same launches after an L2 flush that leaves no dirty line,
   the floor of this way of timing (a one-element add) and PyTorch's sum
   over as many bytes, timed the same way;
5. the main path: GPT-2 small at full width and depth (random weights
   from a seed) serves 16 requests of 256 prompt tokens and 64 new
   tokens on 8 slots with chunked prefill and the paged kernel; every
   request must finish, with the kernel's launch count read around this
   run alone (one launch a layer a decode step: the splits merge inside
   the launch); then a teacher-forced check (one decode step, paged vs
   dense, on one pool state: logits within 1e-3), a dense run whose
   greedy tokens must all agree, and where a decode step's time goes
   (host-clock step time beside device time by kernel from
   ``torch.profiler``);
6. a short int8 / GQA serve: Llama 1b width at 2 layers, int8 KV, 4
   requests, with its own launch count, teacher-forced check and dense
   agreement;
7. the tile check: one 64-row tile through the bf16 flash kernels'
   TMA loads, wgmma descriptors and register fragments against
   ``torch.matmul`` at hd 32, 64 and 128 (relative 1e-5); then the
   flash-attention kernels vs plain versions: K1 (forward: o and lse)
   against ``flash_forward_reference``, K2 (dk, dv) and K3 (dq) against
   ``flash_dkv_reference`` / ``flash_dq_reference`` on the same inputs,
   at the GPT-2 small (12 heads, hd 64), Llama 1b (32 / 8 heads, GQA
   repeated by the wrapper), hd-128 and hd-96 (zero-padded to 128 by the
   wrapper) geometries, S in {1, 100, 129,
   512, 1000, 1024}, causal or not, window None or 256, fp32 and bf16,
   and at the local heads of a tensor degree of 4 (GPT-2 small's 3,
   Llama 1b's 8 / 2), and at two training paths' own shapes in bf16:
   BERT base's (B 8, 12 heads, hd 64, S 512, not causal) and Llama 1b's
   (B 8, S 2048, 32 / 8 heads repeated by the wrapper, hd 64, causal);
   bounds 1e-4 (fp32: sums in another order) and 2e-2 (bf16: one ulp at
   |x| in [2, 4)), and bf16 dv differing from its plain version in at
   most 2 % of its elements (K2 keeps p in fp32 for dv; rounding p to
   bf16 once would move far more, shown beside it on the same inputs);
   bf16 K1, K2 and K3 launched twice on the same inputs, bitwise equal;
   then the ``autograd.Function`` on the card against autograd of
   ``xla_attention`` in fp32 (1e-4);
8. flash timing at the training shape (B 8, S 1024, 12 heads, hd 64,
   causal, bf16) and at BERT base's (B 8, S 512, not causal), L2 flushed
   before each launch: K1, K2 and K3 beside
   their plain versions, their bounds, their achieved TFLOP/s and PyTorch's
   ``scaled_dot_product_attention`` (forward for K1, its backward for K2
   and K3 together; beside it the kernel time ``torch.profiler`` sees);
   every time here is device time, the host's enqueue kept off the
   clock; then flash
   against ``xla`` attention at S 128 to 1024 (the evidence for the
   dispatcher's 512 floor);
9. the training main path: ``AutoDistribute`` on GPT-2 small at full
   width and depth (random weights from a seed, the JAX defaults: bf16
   compute, fp32 params, remat "dots", attention "auto"),
   ``next_token_loss`` and ``adamw(1e-3)`` on one ``SyntheticLM`` batch
   of 8 x 1025 tokens, 12 steps: finite and falling loss, and the K1-K3
   launches per step that remat implies; then a one-step parity,
   ``attention_impl="flash"`` against ``"xla"`` on one set of weights
   and one batch (loss within 1e-2, relative grad-norm difference
   within 2e-2: bf16 compute, and the xla path rounds its scores to
   bf16 while the kernels keep them fp32), and where a step's time goes
   (``torch.profiler``, with K1-K3's device ms per step);
10. the trainer stack: the port's ``examples/train_gpt2.py`` ``main`` at
   the same width and depth through ``Trainer.fit``, on a seeded
   2048-token sequence tiled to 2**20 tokens (a TADN file read by the
   native C++ loader), checkpoints every 10 steps: run 1 takes 30 steps;
   step 30 is torn; run 2 (to step 40, two restarts allowed, a
   ``FaultInjector`` at step 33) must print "resumed from step 20",
   quarantine ``30.corrupt``, give steps 21-30 the losses of run 1 within
   1e-4 relative, restart once from the step 30 it saved again and end at
   40; then ``doctor`` must exit 0.  It prints the median step ms,
   tokens/s, the MFU ``MetricsLogger`` took against the card's peak, the
   goodput buckets, the checkpoint bytes, save-dispatch, write and
   restore ms, and K1-K3's launches over both runs, which must be the
   steps run times 12 layers times 2, 1 and 1;
11. generation: ``AutoDistribute.generate`` at GPT-2 small's width,
   ``CUT_LAYERS`` of its 12 layers (B 4 x 128
   prompt + 64 new, greedy), bf16 weights and ``quant="int8"``: tokens/s,
   int8/bf16 token agreement, weight bytes; each one's tokens (each
   prompt alone, 128 new) equal to those of a one-slot
   ``ServeEngine(attention_impl="dense")`` on the same weights (the same
   shapes and rounding points on both sides), the paged engine's
   agreement reported beside them; then ``speculative_generate``
   with a 2-layer draft in fp32, equal to plain greedy decoding, and the
   port's ``examples/generate_text.py`` with ``run.speculative=1`` at its
   bf16 defaults, its agreement with plain greedy reported;
12. the prefix cache: GPT-2 small, 16 requests of a shared 192-token
   prefix and 64 tokens of their own, 64 new, 8 slots, block 16, chunk
   32, paged, with and without ``prefix_cache``, on a bf16 and an int8 KV
   pool: identical tokens, hits, one K4 launch a layer a decode step;
   hit rate, saved chunks, copy-on-write forks, TTFT p50/p99;
13. speculative serving: phase 5's request set with ``speculative=4``
   against ``speculative=0``: identical tokens; accept rate, decode
   steps of each, and the steps by route (K4 for one-token steps, the
   dense gather for every T = 5 verify step, as in the JAX engine);
14. the planner and the sharded step (``dist_plan``): ``topology.detect``
   on the card (1 device, its name) and ``make_plan`` for GPT-2 small
   (``dp`` on one device); the plans for hypothetical fleets of 1, 4 and
   8 H100s (GPT-2 ``1p3b``, Llama 3.2 1B), equal to ``FLEET_PLANS``,
   which the CPU tests hold too; then GPT-2 small (B 8 x S 1024, bf16
   compute, fp32 params, per-layer remat "dots", no loss-level
   checkpoint) for 5 steps unwrapped, and in a world of one NCCL rank
   wrapped by each strategy at degree 1 (DDP, FSDP2, tensor parallelism,
   TP x FSDP, and ZeRO-1 on dp, which one card makes a no-op): each
   run's losses within 1e-3 relative of the unwrapped run's, K1-K3
   launched 24/12/12 times a step, the median step ms printed beside the
   unwrapped one and the card;
15. head dim 96 (GPT-2 small width, 8 heads): one training step, whose
   ``attention(impl="auto")`` takes the flash kernels on operands
   zero-padded to head dim 128 (K1-K3's launches counted, no plain
   attention), and a few tokens from ``ServeEngine()`` with its
   defaults, on K4's head-dim-96 instance once a layer a decode step,
   equal to the dense path's;
16. LoRA fine-tuning (``lora_train``): GPT-2 small, B 8 x S 1024, the
   JAX defaults (bf16 compute, fp32 params, remat "dots", flash),
   ``LoraSpec(rank=16, alpha=32)`` on q/v/up via
   ``AutoDistribute(init_fn=lora_init_fn)``, ``lora_optimizer(adamw(3e-3))``,
   one batch stepped 12 times: the first loss equals the base model's
   (1e-6 relative), the loss falls, the base stays bitwise, the
   optimizer state is the factors' two moments, K1/K2/K3 launch
   24/12/12 a step, and the merged weights give the adapted loss; median
   step ms, peak memory, optimizer-state bytes and kernels a step beside
   the full fine-tune in the same call;
17. multi-tenant LoRA serving (``serve_lora``): GPT-2 small's width at
   ``CUT_LAYERS`` layers, fp32
   compute, bf16 KV, 8 slots, 16 requests of 256 + 64 tokens, four
   rank-16 tenants and every fifth request on the base model; pools of
   5 slots (fp32, then int8 factors) and of 3 (stalls and requeues):
   one K4 launch a layer a decode step, no pin left, each request's
   tokens equal to its own in a one-slot engine; agreement with
   ``generate`` on merged weights, hit rate, tokens/s and p99 with
   adapters on and off, kernels a decode step with and without;
18. the launcher (``launch``): ``launch --smoke --hosts 1`` (NCCL),
   one NCCL worker on the card training the JAX package's launcher
   workload (GPT-2 ``test``, vocab 512, seq 33, batch 16, SGD 0.1) for
   8 steps with a ``ShardedCheckpoint`` every 2, a clean run and a run
   SIGKILLed right after step 3: per-step losses bitwise equal, one
   restart, resumed from step 2, the merged journal valid against the
   event schema, ``doctor --launch-dir`` healthy; spawn to first
   heartbeat, each round's seconds and the resume time (no kernel: S 32
   is below the flash floor);
19. sharded checkpoints at full width (``sharded_trainer``): GPT-2 small
   (B 8 x S 1024, bf16 compute, flash) under ``Trainer.fit`` with a
   ``ShardedCheckpoint`` every 5 steps for 20 steps; step 20's shard
   torn, a resumed fit quarantines it (``ckpt.corrupt``), falls back to
   step 15 and replays steps 16-20 bitwise; the newest intact step
   restored into fresh ``AutoDistribute``s under fsdp, tp and tp_fsdp in
   a world of one NCCL rank, parameters and Adam moments bitwise equal
   to the saved ones and one more step's loss bitwise equal to the
   unwrapped continuation's; K1/K2/K3 24/12/12 a step; save dispatch,
   write to durable, restore seconds and bytes, beside the same four of
   ``CheckpointManager`` (DCP, the coordinated save) on the same state;
20. the model zoo (``zoo``): the port's examples ``train_bert_mlm``,
   ``train_moe``, ``train_vit``, ``train_transformer_mt`` and
   ``train_mnist_mlp`` at full width (random weights from a seed), each
   stepping on one batch of its synthetic stream: BERT base MLM at B 8 x
   S 512 (bf16; K1-K3 non-causal, 24/12/12 a step) and again with
   ``model.attention_impl=xla`` (no flash launch; the losses of steps
   1-3 within 2e-3), and one more step at the run's last weights with
   every K1-K3 call held against its plain version on the same tensors
   (within 2e-2 of the output's largest magnitude), MoE ``small`` at B 8 x S 1024 (8 experts, top-2,
   capacity factor 1.25; K1-K3 causal, 24/12/12 a step; the first step's
   dropped fraction, aux and z losses), ViT-B/16 at B 64 x 224^2, the MT
   Transformer base at B 64 x 64 + 64 and the MNIST MLP at B 128 (no
   flash launch: below the flash floor or no attention); every loss
   finite and falling; step ms (median after one warm-up), items a
   second, MFU where the logger has one, peak memory;
21. ResNet-50 with BatchNorm (``resnet``): the port's
   ``examples/train_resnet_cifar.py`` at its own config (CIFAR stem,
   32^2, B 128, bf16, ``sgd(0.1, momentum=0.9)``, ``dp``) through
   ``Trainer.fit``, 20 steps on one batch; ``bench.py``'s cell (ImageNet
   stem, 224^2, B 256, 1000 classes, one synthetic batch drawn once);
   each with step ms, images/s, MFU against 989.4 TFLOP/s, peak memory,
   falling losses and every running mean moved, no flash launch; then
   ResNet-50 in fp32 with TF32 off, one step from seeded weights on the
   card and on the CPU: the running statistics and ``ad(state, x,
   train=False)`` within 1e-3 of the CPU's (of its largest magnitude);
   then the CIFAR cell's step under ``dp`` in a world of one NCCL rank
   (DDP, the BatchNorm statistics all-reduced on NCCL): losses within
   1e-6 relative of the unwrapped step's;
22. the Llama FSDP example (``llama_fsdp``): the port's
   ``examples/train_llama_fsdp.py`` at ``model.size=1b`` (Llama 3.2 1B,
   1.24B parameters), S 2048, B 8 (halved while it does not fit), 6
   steps on one batch under ``python -m torch.distributed.run
   --nproc-per-node 1`` (FSDP2 at degree 1, remat on): a falling loss,
   K1/K2/K3 48/16/16 a step (the forward and two nested recomputes of
   every layer's GQA attention, K and V repeated by the wrapper), step
   ms, tokens/s, MFU, peak memory, and the device ms a step of the K/V
   repeat (``aten::repeat_interleave``) and of its gradient
   (``ExpandBackward0``) from ``torch.profiler``;
23. MoE past expert degree 1 (``moe``), MoE ``small`` (``CUT_LAYERS`` of
   its 12 layers, d 768,
   8 experts top-2, vocab 32000, random weights from a seed): (a)
   ``ServeEngine(moe_decode="dense")`` on phase 5's request set (fp32
   compute, bf16 KV, 16 x (256 + 64), 8 slots): K4 once a layer a
   decode step, tokens equal to the dense engine's, one decode step's
   logits within 1e-3 of the dense path's, the agreement with
   ``generate`` one request at a time reported; tokens/s, p99, the mean
   decode-step ms, and a decode step's busy ms and launches; (b)
   ``AutoDistribute.generate`` at B 4 x (128 + 64) in bf16, dense,
   routed and ``quant="int8"`` (the banks and the router left whole):
   tokens/s; in fp32 at capacity factor 8, routed within 1e-3 of the
   dense logits (of their largest magnitude) at >= 99 % of the
   positions, teacher-forced; (c) B 8 x S 1024, 5 steps on one batch,
   unwrapped and under ``ep``, ``ep_fsdp`` and ``ep_tp`` in a world of
   one NCCL rank (the dispatch exchanged by NCCL's all-to-all): losses
   bitwise equal, the all-to-all and K1-K3 launches a step that the
   remats imply, step ms and peak memory; (d) the first step's dropped
   fraction, per layer, over the batch and on row 0 alone;
24. pipeline and context parallelism (``pipeline_cp``), GPT-2 small at B
   8 x S 1024, bf16 compute, 5 steps on one batch: the unsharded step in
   this process, then two processes on the one card in a gloo group (NCCL
   refuses two ranks on one device; sends, rotations and all-to-alls go
   through host buffers, counted): pipe 2 with microbatches 4 under
   ``cond``, ``1f1b`` and ``interleaved_1f1b`` (V 2), and seq 2 under
   ``ring`` and ``ulysses``, each rank's losses within 5e-2 of the
   unsharded step's, its K1-K3 launches a step equal to what the schedule
   implies, 1f1b's peak memory below cond's on each rank; step ms, peak
   memory and the bytes each rank sends; then ``ring_attention`` alone on
   [8, 1024, 12, 64] bf16 (each rank half the sequence): o, dq, dk, dv
   within 2e-2 of their largest magnitude of flash on the whole sequence
   and of fp32 plain attention.

Phases 5 (``serve``), 10 (``trainer``), 16, 17, 19 and 23 write their
journals with schema validation on (``Journal(validate=True)``): a record that
breaks the event schema fails the run; phase 18 checks every record
of its merged journal the same way.

Then, on lines of their own: a summary (the number of kernels, K4's
launches per decode step, the prefix hit rates), the per-kernel JSON record, the
``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is visible or the package is missing.
``--phases a,b,...`` runs only the named phases (for a short first
check of a new kernel) and prints no result.  The ``done`` record holds
each phase's start and seconds.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the depth of three host-bound paths, `generate`, `serve_lora` and `moe`
# (each at its model's full width): with every phase at full depth the
# whole smoke reached 1,151 s of its 1,200 s on a slow host
CUT_LAYERS = 6
FP32_FLOPS_PER_S = 67e12   # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
PAGED_SOURCE = ("torch_automatic_distributed_neural_network_tpu_torch/"
                "csrc/paged_attention.cu")
PAGED_REPLACES = ("torch_automatic_distributed_neural_network_tpu/ops/"
                  "paged_attention.py:72")
_CSRC = "torch_automatic_distributed_neural_network_tpu_torch/csrc"
FLASH_SOURCES = {"flash_forward": f"{_CSRC}/flash_attention_sm90.cu",  # bf16
                 "flash_dkv": f"{_CSRC}/flash_attention_sm90.cu",
                 "flash_dq": f"{_CSRC}/flash_attention_sm90.cu"}
_JAX_FLASH = "torch_automatic_distributed_neural_network_tpu/ops/flash_attention.py"
FLASH_REPLACES = {"flash_forward": f"{_JAX_FLASH}:99",   # _fwd_kernel
                  "flash_dkv": f"{_JAX_FLASH}:214",      # _dkv_kernel
                  "flash_dq": f"{_JAX_FLASH}:254"}       # _dq_kernel

def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 1 ----------------------------------------------------------------


def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "environment", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "capability": f"sm_{cap[0]}{cap[1]}",
          "torch": torch.__version__, "cuda": torch.version.cuda})
    require(cap == (9, 0), f"needs an sm_90 card, found sm_{cap[0]}{cap[1]}")
    return card


# -- phase 2 ----------------------------------------------------------------


def _sass_counts(lib) -> dict:
    """Tensor-core (HGMMA) and TMA (UTMALDG) instructions in a built
    library's SASS, from ``cuobjdump``, which ships with ``nvcc``: in
    all, and in each kernel whose demangled name starts with one of
    ``_SASS_KERNELS``."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    require(os.path.exists(tool), "cuobjdump not found beside nvcc: the "
                                  "tensor-core check cannot count HGMMA")
    dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    require(dump.returncode == 0, f"cuobjdump -sass failed: {dump.stderr}")
    ops = ("HGMMA", "UTMALDG")
    counts = {op: 0 for op in ops}
    counts.update({k: {op: 0 for op in ops} for k in _SASS_KERNELS})
    kernel = None
    for ln in dump.stdout.splitlines():
        if "Function :" in ln:
            name = _demangle(ln.split("Function :", 1)[1].strip())
            kernel = next((k for k in _SASS_KERNELS if name.startswith(k)),
                          None)
        for op in ops:
            if op in ln:
                counts[op] += 1
                if kernel:
                    counts[kernel][op] += 1
    return counts


# kernels whose tensor-core and TMA instructions the build counts apart
_SASS_KERNELS = ("flash_fwd_sm90", "flash_dkv_sm90", "flash_dq_sm90")


def _demangle(symbol: str) -> str:
    """A kernel's name and template arguments, ``flash_fwd_sm90<64>``
    (the mangled symbol where ``c++filt`` is missing)."""
    try:
        name = subprocess.run(["c++filt", symbol], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except OSError:
        return symbol
    return name.split("::", 1)[-1].split("(")[0] if "::" in name else symbol


def phase_build() -> None:
    from torch_automatic_distributed_neural_network_tpu_torch.ops import build

    names = ["paged_attention", "flash_attention", "flash_attention_sm90"]
    t0 = time.monotonic()
    logs = build.build(names, ptxas_verbose=True)
    seconds = time.monotonic() - t0
    # registers and spill bytes of each kernel, from ptxas -v
    ptxas, entry = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = _demangle(ln.split("'")[1])
            elif entry and ("registers" in ln or "spill stores" in ln):
                ptxas[entry] = (ptxas.get(entry, "") + " " + ln.split(
                    ":", 1)[-1].strip()).strip()
    warnings = [ln.strip() for log in logs.values()
                for ln in log.splitlines() if "arning" in ln]
    sass = _sass_counts(build.library_path("flash_attention_sm90"))
    emit({"phase": "build", "kernels": sorted(logs), "seconds": seconds,
          "sm90_sass": sass, "ptxas": ptxas, "warnings": warnings[:20]})
    for kernel in (None, *_SASS_KERNELS):
        n = (sass if kernel is None else sass[kernel])["HGMMA"]
        require(n > 0, f"flash_attention_sm90: no HGMMA in the built SASS"
                       f"{'' if kernel is None else ' of ' + kernel}")


# -- phases 3 and 4 ---------------------------------------------------------


def _pool_case(torch, *, S, Hq, kvH, hd, bs, ctx_lens, pool_dtype, q_dtype,
               null_slot, seed):
    """Random pool and block tables with the engine's layout: block 0 is
    the null block, slot s owns ctx_s // bs + 1 blocks, rows null-padded;
    ``null_slot`` gets an all-null table (an inactive slot)."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference.quant \
        import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    max_len = 1024
    MB = max_len // bs
    n_owned = [c // bs + 1 for c in ctx_lens]
    NB = 1 + sum(n_owned)
    dev = "cuda"
    k = torch.randn(NB, bs, kvH, hd, generator=g, device=dev)
    v = torch.randn(NB, bs, kvH, hd, generator=g, device=dev)
    if pool_dtype == torch.int8:
        k, v = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(pool_dtype), v.to(pool_dtype)
    tables = torch.zeros(S, MB, dtype=torch.int32)
    nxt = 1
    for s, n in enumerate(n_owned):
        if s == null_slot:
            continue
        tables[s, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    q = torch.randn(S, Hq, hd, generator=g, device=dev).to(q_dtype)
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device=dev)
    return q, k, v, tables.to(dev), ctx


def phase_kernel_cases(torch) -> dict:
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention, paged_attention_reference

    # gpt2-small-h8: GPT-2 small's width in 8 heads, head dim 96
    geoms = {"gpt2-small": (12, 12, 64), "llama-1b": (32, 8, 64),
             "llama-8b": (32, 8, 128), "gpt2-small-h8": (8, 8, 96)}
    ctx_lens = [0, 1, 17, 100, 255, 511, 777, 1023]
    bounds = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {}
    n = 0
    for gname, (Hq, kvH, hd) in geoms.items():
        for bs in (8, 16):
            for pool_dtype in (torch.float32, torch.bfloat16, torch.int8):
                for window in (None, 256):
                    for q_dtype in (torch.float32, torch.bfloat16):
                        n += 1
                        q, k, v, tables, ctx = _pool_case(
                            torch, S=8, Hq=Hq, kvH=kvH, hd=hd, bs=bs,
                            ctx_lens=ctx_lens, pool_dtype=pool_dtype,
                            q_dtype=q_dtype, null_slot=0, seed=n)
                        got = paged_attention(q, k, v, tables, ctx,
                                              window=window)
                        want = paged_attention_reference(
                            q, k, v, tables, ctx, window=window)
                        torch.cuda.synchronize()
                        finite = bool(torch.isfinite(got).all())
                        err = float((got.float() - want.float()).abs().max())
                        bound = bounds[q_dtype]
                        emit({"phase": "kernel_case", "kernel":
                              "paged_attention", "geometry": gname,
                              "block_size": bs,
                              "pool": str(pool_dtype).replace("torch.", ""),
                              "window": window,
                              "q": str(q_dtype).replace("torch.", ""),
                              "max_abs_err": err, "bound": bound,
                              "finite": finite})
                        require(finite, f"non-finite kernel output in case "
                                        f"{n}")
                        require(err <= bound,
                                f"paged_attention case {n} ({gname} bs={bs}"
                                f" {pool_dtype} w={window} {q_dtype}): "
                                f"max_abs_err {err} > {bound}")
                        key = str(q_dtype)
                        worst[key] = max(worst.get(key, 0.0), err)
    n += _split_cases(torch, bounds, worst)
    n += _aliased_cases(torch, bounds, worst)
    emit({"phase": "kernel_cases", "kernel": "paged_attention", "cases": n,
          "worst_abs_err": worst})
    return worst


def _aliased_cases(torch, bounds, worst) -> int:
    """K4 over block tables that share physical blocks, as prefix-cache
    hits make them: 8 slots at the GPT-2 small geometry whose tables all
    start with the same 12 blocks (a 192-token prefix, refcount 8 in the
    port's ``BlockAllocator``), slots 6 and 7 sharing two more, each slot
    then going on in blocks of its own; bf16 and int8 pools, fp32 and
    bf16 queries, with and without a window; against the plain version
    on the same inputs, under the bounds of the other cases."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference.quant \
        import quantize_kv
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import BlockAllocator
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention, paged_attention_reference

    S, Hq, kvH, hd, bs, MB = 8, 12, 12, 64, 16, 64
    ctx_lens = [192, 200, 255, 256, 300, 319, 230, 240]
    alloc = BlockAllocator(1 + 12 + 2 + 8 * 8)
    shared = alloc.acquire(12)
    pair = alloc.acquire(2)
    tables = torch.zeros(S, MB, dtype=torch.int32)
    for s, c in enumerate(ctx_lens):
        if s:  # every slot after the first is one more holder
            for b in shared:
                alloc.ref(b)
        row = list(shared)
        if s >= 6:
            if s == 7:
                for b in pair:
                    alloc.ref(b)
            row += pair
        row += alloc.acquire(c // bs + 1 - len(row))
        tables[s, :len(row)] = torch.tensor(row, dtype=torch.int32)
    require(alloc.refcount(shared[0]) == S and alloc.refcount(pair[0]) == 2,
            "aliased case: the shared blocks' refcounts are not 8 and 2")
    NB = alloc.num_blocks
    n = 0
    for pool_dtype in (torch.bfloat16, torch.int8):
        for q_dtype in (torch.float32, torch.bfloat16):
            for window in (None, 256):
                n += 1
                g = torch.Generator(device="cuda").manual_seed(300 + n)
                k = torch.randn(NB, bs, kvH, hd, generator=g, device="cuda")
                v = torch.randn(NB, bs, kvH, hd, generator=g, device="cuda")
                if pool_dtype == torch.int8:
                    k, v = quantize_kv(k), quantize_kv(v)
                else:
                    k, v = k.to(pool_dtype), v.to(pool_dtype)
                q = torch.randn(S, Hq, hd, generator=g,
                                device="cuda").to(q_dtype)
                tab = tables.cuda()
                ctx = torch.tensor(ctx_lens, dtype=torch.int32, device="cuda")
                got = paged_attention(q, k, v, tab, ctx, window=window)
                want = paged_attention_reference(q, k, v, tab, ctx,
                                                 window=window)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                bound = bounds[q_dtype]
                emit({"phase": "kernel_aliased_case",
                      "kernel": "paged_attention", "geometry": "gpt2-small",
                      "block_size": bs, "shared_blocks": len(shared),
                      "refcount": alloc.refcount(shared[0]),
                      "pool": str(pool_dtype).replace("torch.", ""),
                      "window": window,
                      "q": str(q_dtype).replace("torch.", ""),
                      "max_abs_err": err, "bound": bound})
                require(bool(torch.isfinite(got).all()) and err <= bound,
                        f"aliased case {n} ({pool_dtype} {q_dtype} "
                        f"w={window}): max_abs_err {err} > {bound}")
                worst["aliased"] = max(worst.get("aliased", 0.0), err)
    return n


def _split_cases(torch, bounds, worst) -> int:
    """K4's split context where the splits outnumber the attended pages:
    ctx 0, contexts shorter than one chunk, windows that leave chunks
    empty, at the wrapper's split count and at 2, 7 and 16; a slot with no
    attended key (ctx -1) gives zeros; two launches are bitwise equal."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        paged_attention as pa

    ctx_lens = [0, 5, 15, 16, 17, 40, 63, 1023]
    n = 0
    for gname, (Hq, kvH, hd) in {"gpt2-small": (12, 12, 64),
                                 "llama-1b": (32, 8, 64),
                                 "gpt2-small-h8": (8, 8, 96)}.items():
        for bs in (8, 16):
            for pool_dtype in (torch.bfloat16, torch.int8):
                n += 1
                q, k, v, tables, ctx = _pool_case(
                    torch, S=8, Hq=Hq, kvH=kvH, hd=hd, bs=bs,
                    ctx_lens=ctx_lens, pool_dtype=pool_dtype,
                    q_dtype=torch.float32, null_slot=-1, seed=100 + n)
                errs = {}
                for window in (None, 8, 20):
                    want = pa.paged_attention_reference(q, k, v, tables, ctx,
                                                        window=window)
                    for splits in (None, 2, 7, 16):
                        got = pa._paged_attention_cuda(
                            q, k, v, tables, ctx, window=window,
                            splits=splits)
                        again = pa._paged_attention_cuda(
                            q, k, v, tables, ctx, window=window,
                            splits=splits)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        errs[f"w{window}/s{splits}"] = err
                        require(bool(torch.isfinite(got).all()) and
                                err <= bounds[torch.float32],
                                f"split case {gname} bs={bs} {pool_dtype} "
                                f"w={window} splits={splits}: max_abs_err "
                                f"{err} > {bounds[torch.float32]}")
                        require(torch.equal(got, again),
                                f"split case {gname} bs={bs} {pool_dtype} "
                                f"w={window} splits={splits}: two launches "
                                f"differ")
                empty = ctx.clone()
                empty[3] = -1  # no attended key at all
                got = pa.paged_attention(q, k, v, tables, empty)
                torch.cuda.synchronize()
                require(bool((got[3] == 0).all()),
                        f"split case {gname} bs={bs}: a slot with no key "
                        f"gives {got[3].abs().max()} not zeros")
                worst["split"] = max(worst.get("split", 0.0), *errs.values())
                emit({"phase": "kernel_split_cases", "geometry": gname,
                      "block_size": bs,
                      "pool": str(pool_dtype).replace("torch.", ""),
                      "ctx": ctx_lens, "max_abs_err": errs,
                      "bound": bounds[torch.float32], "bitwise_repeat": True,
                      "empty_slot_zeros": True})
    return n


def _time_ms(torch, fn, n: int, flush, *, clean_l2=False) -> float:
    """Median device time of ``fn`` over ``n`` launches, the L2 cache
    flushed before each (the decode step finds each layer's pages cold:
    the other layers' pages pass through L2 in between): by writing the
    256 MB ``flush``, which leaves L2 full of dirty lines that the timed
    kernel's reads must first write back, or with ``clean_l2`` by reading
    it.  The card spins ~5 ms before each start event, so a call whose
    host side takes longer than its kernels (a wrapper's checks,
    autograd's backward) has queued all of them by the time the clock
    starts: device time alone, however slow the host."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        if clean_l2:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(10_000_000)  # clock cycles
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase_timing(torch) -> dict:
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        paged_attention as pa

    S, Hq, kvH, hd, bs = 8, 12, 12, 64, 16
    ctx_lens = [1023] * S
    q, k, v, tables, ctx = _pool_case(
        torch, S=S, Hq=Hq, kvH=kvH, hd=hd, bs=bs, ctx_lens=ctx_lens,
        pool_dtype=torch.bfloat16, q_dtype=torch.float32, null_slot=-1,
        seed=1234)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    err = float((pa.paged_attention(q, k, v, tables, ctx)
                 - pa.paged_attention_reference(q, k, v, tables, ctx))
                .abs().max())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = pa.split_count(S * kvH, tables.shape[1], bs, n_sm)
    ms = _time_ms(torch, lambda: pa.paged_attention(q, k, v, tables, ctx),
                  100, flush)
    plain_ms = _time_ms(
        torch, lambda: pa.paged_attention_reference(q, k, v, tables, ctx),
        50, flush)
    # the same launches after an L2 flush that leaves no dirty line, and
    # the floor of this way of timing: one launch of a one-element add
    clean_ms = _time_ms(torch, lambda: pa.paged_attention(q, k, v, tables,
                                                          ctx),
                        100, flush, clean_l2=True)
    one = torch.zeros(1, device="cuda")
    floor_ms = _time_ms(torch, lambda: one.add_(1), 100, flush)
    # the split count at this shape, each in turn, there and back
    sweep = {}
    for n in (2, 3, 4, 6, 8, 16, 16, 8, 6, 4, 3, 2):
        sweep.setdefault(n, []).append(_time_ms(
            torch, lambda: pa._paged_attention_cuda(
                q, k, v, tables, ctx, window=None, splits=n), 100, flush))
    keys = sum(c + 1 for c in ctx_lens)
    kv_bytes = keys * kvH * hd * 2 * k.element_size()
    io_bytes = (2 * q.numel() * q.element_size() + tables.numel() * 4
                + ctx.numel() * 4)
    # a yardstick of the same bytes read the same way: PyTorch's sum over
    # a bf16 tensor of that size (it computes nothing of K4's function)
    same = torch.ones((kv_bytes + io_bytes) // 2, dtype=torch.bfloat16,
                      device="cuda")
    same_bytes_ms = _time_ms(torch, same.sum, 100, flush)
    del same
    flops = 4 * keys * Hq * hd
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    rec = {"ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "max_abs_err": err}
    emit({"phase": "timing", "kernel": "paged_attention",
          "shape": {"slots": S, "ctx": 1023, "Hq": Hq, "kvH": kvH, "hd": hd,
                    "block_size": bs, "pool": "bfloat16", "q": "float32"},
          "splits": splits, "blocks": S * kvH * splits,
          "bytes": kv_bytes + io_bytes, "flops": flops,
          "kv_floor_ms": kv_bytes / HBM_BYTES_PER_S * 1e3, **rec,
          "achieved_gb_per_s": (kv_bytes + io_bytes) / (ms * 1e-3) / 1e9,
          "roofline_share": rec["bound_ms"] / ms,
          "ms_clean_l2": clean_ms, "timing_floor_ms": floor_ms,
          "same_bytes_sum_ms": same_bytes_ms,
          "split_sweep_ms": {str(n): t for n, t in sorted(sweep.items())}})
    require(err <= 1e-4, f"timing-shape kernel error {err} > 1e-4")
    return rec


# -- phases 5 and 6 ---------------------------------------------------------


def _serve(torch, model, prompts, *, max_new, impl, journal, **kw):
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import ServeEngine

    eng = ServeEngine(model, attention_impl=impl, journal=journal,
                      device="cuda", **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new, eos_id=None)
            for p in prompts]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return eng, reqs, done, wall


def _teacher_forced(torch, model, prompts, **kw) -> float:
    """One identical pool state: admit and prefill every slot, then run
    one decode step with the paged kernel and, on the restored pool, one
    with the dense path; returns the max abs logit difference."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import ServeEngine
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve.engine import _decode_logits

    eng = ServeEngine(model, prefill_chunks_per_step=len(prompts),
                      device="cuda", **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=8, eos_id=None)
    while eng.scheduler.n_decoding < len(prompts):
        eng.step()
    tables, ctx, tok, _, _ = eng._decode_inputs()
    leaves = list(eng.pool._leaves())
    saved = [t.clone() for t in leaves]
    paged = _decode_logits(model, eng.pool, tables, ctx, tok,
                           attention_impl="paged")
    for t, s in zip(leaves, saved):
        t.copy_(s)
    dense = _decode_logits(model, eng.pool, tables, ctx, tok,
                           attention_impl="dense")
    torch.cuda.synchronize()
    return float((paged - dense).abs().max())


def _agreement(a, b) -> float:
    same = total = 0
    for x, y in zip(a, b):
        total += max(len(x), len(y))
        same += sum(int(i == j) for i, j in zip(x, y))
    return same / max(total, 1)


def _pct(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, max(0, math.ceil(q * len(vals)) - 1))]


def phase_serve(torch, *, name, model, n_requests, prompt_len, max_new,
                n_slots, max_len, block_size, quant_kv,
                seed) -> tuple[int, int]:
    import numpy as np

    from torch_automatic_distributed_neural_network_tpu_torch.obs.journal \
        import Journal
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention

    rs = np.random.RandomState(seed)
    vocab = model.cfg.vocab_size
    prompts = [[int(t) for t in rs.randint(1, vocab, size=(prompt_len,))]
               for _ in range(n_requests)]
    kw = dict(n_slots=n_slots, max_len=max_len, block_size=block_size,
              quant_kv=quant_kv, prefill_chunk=32)
    # warm-up: first-call costs (library loads, allocator) stay out
    _serve(torch, model, prompts[:1], max_new=2, impl="paged", journal=None,
           **kw)

    jnl = Journal(None, host0_only=False, validate=True,
                  meta={"tool": "chip_smoke"})
    paged_attention.launches = 0
    eng, reqs, done, wall = _serve(torch, model, prompts, max_new=max_new,
                                   impl="paged", journal=jnl, **kw)
    launches = paged_attention.launches
    require(len(done) == n_requests and all(
        r.n_generated == max_new for r in reqs),
        f"{name}: {len(done)}/{n_requests} requests finished")
    require(launches > 0, f"{name}: the paged kernel never launched")
    steps = [r for r in jnl.records if r.get("name") == "serve.step"]
    decode_ms = [1e3 * r["decode_s"] for r in steps if r["decode_s"] > 0]
    # one launch a layer a decode step: the splits merge inside the launch
    require(launches == model.cfg.n_layers * len(decode_ms),
            f"{name}: {launches} paged launches over {len(decode_ms)} "
            f"decode steps of {model.cfg.n_layers} layers")
    totals = [(r.t_done or 0.0) - r.t_submit for r in done]
    ttfts = [r.t_first_token - r.t_submit for r in done]
    new_tokens = sum(r.n_generated for r in done)
    vocab_ok = all(0 <= t < vocab for r in reqs for t in r.out_tokens)
    require(vocab_ok, f"{name}: token id out of range")

    _, dense_reqs, _, _ = _serve(torch, model, prompts, max_new=max_new,
                                 impl="dense", journal=None, **kw)
    agree = _agreement([r.out_tokens for r in reqs],
                       [r.out_tokens for r in dense_reqs])
    tf_err = _teacher_forced(torch, model, prompts[:n_slots], **kw)
    emit({"phase": "serve", "name": name,
          "model": {"layers": model.cfg.n_layers,
                    "d_model": model.cfg.d_model,
                    "heads": model.cfg.n_heads,
                    "kv_heads": model.cfg.kv_heads, "vocab": vocab,
                    "max_len": max_len},
          "requests": n_requests, "finished": len(done),
          "prompt_len": prompt_len, "max_new": max_new, "slots": n_slots,
          "block_size": block_size, "quant_kv": quant_kv,
          "attention_impl": "paged", "prefill_chunk": eng.prefill_chunk,
          "new_tokens": new_tokens, "wall_s": wall,
          "tokens_per_s": new_tokens / wall,
          "p50_latency_s": _pct(totals, 0.50),
          "p99_latency_s": _pct(totals, 0.99),
          "ttft_p50_s": _pct(ttfts, 0.50), "ttft_p99_s": _pct(ttfts, 0.99),
          "decode_steps": len(decode_ms),
          "mean_decode_step_ms": statistics.fmean(decode_ms),
          "paged_kernel_launches": launches,
          "launches_per_decode_step": launches / max(len(decode_ms), 1),
          "greedy_agreement_vs_dense": agree,
          "teacher_forced_max_abs_logit_diff": tf_err})
    require(tf_err <= 1e-3,
            f"{name}: paged vs dense logits differ by {tf_err} > 1e-3")
    # the teacher-forced check sees one step at the prompt's length; this
    # one sees every decode step up to prompt + max_new.  Fixed seeds and
    # logit gaps ~1e-6 between the two paths leave no room for a tie, so
    # any diverging token is a fault
    require(agree == 1.0,
            f"{name}: greedy tokens agree with the dense path on only "
            f"{agree:.4f} of positions")
    return launches, len(decode_ms)


def _device_time(prof, steps: int, top_n: int) -> dict | None:
    """Device time per step from a ``torch.profiler`` run over ``steps``
    steps: the union of kernel intervals, the kernel count and the
    ``top_n`` kernels by time; None when the trace holds no kernel."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"device_busy_ms_per_step": busy_us / steps / 1e3,
            "kernels_per_step": len(kernels) / steps,
            "top_kernels": [{"name": k[:80], "ms_per_step": t / steps / 1e3,
                             "launches_per_step": n / steps}
                            for k, (t, n) in top]}


def phase_profile(torch, *, name, model, n_slots, prompt_len, max_len,
                  block_size, seed, steps=16) -> None:
    """Where a decode step's time goes: the host-clock step time of
    ``steps`` pure decode steps (every slot decoding, nothing queued),
    then the same number of steps under ``torch.profiler`` for the device
    time by kernel.  Device busy share = kernel time per step (the union
    of kernel intervals) over the unprofiled step time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import ServeEngine

    rs = np.random.RandomState(seed)
    eng = ServeEngine(model, n_slots=n_slots, max_len=max_len,
                      block_size=block_size, prefill_chunks_per_step=n_slots,
                      device="cuda")
    for _ in range(n_slots):
        eng.submit([int(t) for t in rs.randint(
            1, model.cfg.vocab_size, size=(prompt_len,))],
            max_new_tokens=3 * steps, eos_id=None)
    while eng.scheduler.n_decoding < n_slots:
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    rec = {"phase": "profile", "name": name, "decode_step_ms": step_ms,
           "steps": steps}
    dev = _device_time(prof, steps, 8)
    if dev is None:
        emit({**rec, "device_busy_ms_per_step": "not measured"})
        return
    emit({**rec, **dev, "device_busy_share":
          dev["device_busy_ms_per_step"] / step_ms})


# -- phases 7 and 8: the flash-attention kernels ----------------------------


def _flash_inputs(torch, *, B, S, H, kvH, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(h):
        return torch.randn(B, S, h, hd, generator=g, device="cuda").to(dtype)

    return rand(H), rand(kvH), rand(kvH), rand(H)


def _max_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


FLASH_CASE_SEQS = (1, 100, 129, 512, 1000, 1024)
# bf16 dv: the share of elements that differ from the plain version's.
# K2 keeps p in fp32 for dv += p^T . do (hi + lo bf16 terms), so only sums
# in another order can move a value across a rounding boundary; rounding
# p to bf16 once moves ~40 % of them (CPU: tests/test_torch_port_flash_bf16.py)
DV_DIFF_SHARE_BOUND = 0.02


def _diff_share(got, want) -> float:
    return float((got != want).float().mean())


def _dv_single_rounding(torch, fa, q, k, v, do, lse, delta, causal, window,
                        scale):
    """dv as a kernel that rounds p to bf16 once would give it: what the
    share bound must tell apart from K2."""
    p, _ = fa._backward_terms(q, k, v, do, lse, delta, causal, window,
                              scale)
    return torch.einsum("bhqk,bqhd->bkhd", p.to(torch.bfloat16).float(),
                        do.float()).to(torch.bfloat16)


def phase_tile_check(torch) -> None:
    """One 64-row tile through the bf16 kernels' TMA loads, wgmma
    descriptors and register fragments, against ``torch.matmul``: s = q
    k^T (SS, K-major) and o = bf16(s) v (RS, v MN-major), at hd 32, 64 and
    128, at a tile that runs past the end of the sequence (zero fill)."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    for hd in (32, 64, 128):
        q, k, v, _ = _flash_inputs(torch, B=2, S=100, H=3, kvH=3, hd=hd,
                                   dtype=torch.bfloat16, seed=hd)
        errs = {}
        for s0, h, b in ((0, 0, 0), (64, 2, 1)):
            s, o = fa.sm90_tile_check(q, k, v, s0=s0, h=h, b=b)
            torch.cuda.synchronize()

            def tile(x):
                t = torch.zeros(64, hd, device="cuda")
                rows = x[b, s0:s0 + 64, h].float()
                t[:rows.shape[0]] = rows
                return t

            s_ref = tile(q) @ tile(k).T
            # the kernel's own s, rounded as it rounds it, so a tie in the
            # rounding cannot flip between the two sides
            o_ref = s.to(torch.bfloat16).float() @ tile(v)
            for name, got, ref in (("s", s, s_ref), ("o", o, o_ref)):
                rel = _max_err(got, ref) / max(float(ref.abs().max()), 1e-30)
                errs[f"{name}@{s0},{h},{b}"] = rel
                require(rel <= 1e-5, f"tile check hd {hd} {name} at "
                                     f"(s0={s0}, h={h}, b={b}): relative "
                                     f"error {rel} > 1e-5")
        emit({"phase": "tile_check", "hd": hd, "rel_err": errs,
              "bound": 1e-5})


def phase_flash_kernel_cases(torch) -> dict:
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    # hd96: the kernels take it zero-padded to 128 (``_prep_bshd``), the
    # scores scaled by 1/sqrt(96)
    # "-tp4": the local heads of one rank of a tensor degree of 4 (the
    # port's column split takes whole heads)
    geoms = {"gpt2-small": (12, 12, 64), "llama-1b": (32, 8, 64),
             "hd128": (16, 16, 128), "hd96": (8, 8, 96),
             "gpt2-small-tp4": (3, 3, 64), "llama-1b-tp4": (8, 2, 64)}
    # fp32: the same fp32 products summed in another order; bf16: the
    # outputs are rounded to bf16 on both sides, one ulp at |x| in [2, 4)
    bounds = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    masks = ((False, None), (True, None), (True, 256))
    worst, n, dv_shares = {}, 0, []
    for gname, (H, kvH, hd) in geoms.items():
        for dtype in (torch.float32, torch.bfloat16):
            errs, shares = {}, {"kernel": 0.0, "single_rounding": 0.0}
            for S in FLASH_CASE_SEQS:
                for causal, window in masks:
                    n += 1
                    q, k, v, do = _flash_inputs(torch, B=2, S=S, H=H,
                                                kvH=kvH, hd=hd, dtype=dtype,
                                                seed=n)
                    # the GQA repeat and head-dim padding of the public
                    # entry point
                    q, k, v, _, scale = fa._prep_bshd(q, k, v, causal,
                                                      window)
                    do = torch.nn.functional.pad(
                        do, (0, q.shape[-1] - do.shape[-1]))
                    kw = dict(causal=causal, window=window, scale=scale)
                    o, lse = fa.flash_forward(q, k, v, **kw)
                    o_ref, lse_ref = fa.flash_forward_reference(
                        q, k, v, causal, window, scale)
                    delta = fa._delta(o_ref, do)
                    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
                    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, **kw)
                    dk_ref, dv_ref = fa.flash_dkv_reference(
                        q, k, v, do, lse_ref, delta, causal, window, scale)
                    dq_ref = fa.flash_dq_reference(q, k, v, do, lse_ref,
                                                   delta, causal, window,
                                                   scale)
                    torch.cuda.synchronize()
                    got = {"o": (o, o_ref), "lse": (lse, lse_ref),
                           "dk": (dk, dk_ref), "dv": (dv, dv_ref),
                           "dq": (dq, dq_ref)}
                    for name, (a, b) in got.items():
                        require(bool(torch.isfinite(a).all()),
                                f"flash case {n}: non-finite {name}")
                        require(a.dtype == b.dtype,
                                f"flash case {n}: {name} dtype {a.dtype}")
                        err = _max_err(a, b)
                        require(err <= bounds[dtype],
                                f"flash case {n} ({gname} {dtype} S={S} "
                                f"causal={causal} window={window}): {name} "
                                f"max_abs_err {err} > {bounds[dtype]}")
                        errs[name] = max(errs.get(name, 0.0), err)
                    if dtype == torch.bfloat16:
                        single = _dv_single_rounding(
                            torch, fa, q, k, v, do, lse_ref, delta, causal,
                            window, scale)
                        share = _diff_share(dv, dv_ref)
                        dv_shares.append((share, n, gname, S, causal,
                                          window))
                        shares["kernel"] = max(shares["kernel"], share)
                        shares["single_rounding"] = max(
                            shares["single_rounding"],
                            _diff_share(single, dv_ref))
            emit({"phase": "flash_kernel_cases", "geometry": gname,
                  "heads": H, "kv_heads": kvH, "hd": hd,
                  "dtype": str(dtype).replace("torch.", ""),
                  "S": list(FLASH_CASE_SEQS),
                  "masks": ["full", "causal", "causal+window256"],
                  "max_abs_err": errs, "bound": bounds[dtype],
                  **({"dv_diff_share": shares}
                     if dtype == torch.bfloat16 else {})})
            key = str(dtype).replace("torch.", "")
            worst[key] = max(worst.get(key, 0.0), *errs.values())
    # the training paths' own shapes, bf16, through the public entry
    # point's preparation: BERT base as phase zoo trains it (B 8, 12
    # heads, hd 64, S 512, not causal) and Llama 1b as phase llama_fsdp
    # trains it (B 8, S 2048, 32 q heads over 8 kv heads repeated by
    # ``_prep_bshd``, hd 64, causal): S 2048 is twice the K/V tiles of
    # every case above
    path_shapes = {"bert-base": (8, 512, 12, 12, False),
                   "llama-1b-train": (8, 2048, 32, 8, True)}
    for gname, (B, S, H, kvH, causal) in path_shapes.items():
        n += 1
        q, k, v, do = _flash_inputs(torch, B=B, S=S, H=H, kvH=kvH, hd=64,
                                    dtype=torch.bfloat16, seed=n)
        q, k, v, _, scale = fa._prep_bshd(q, k, v, causal, None)
        kw = dict(causal=causal, scale=scale)
        o, lse = fa.flash_forward(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal, None,
                                                    scale)
        delta = fa._delta(o_ref, do)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, **kw)
        want = {"o": o_ref, "lse": lse_ref, "dq": fa.flash_dq_reference(
            q, k, v, do, lse_ref, delta, causal, None, scale)}
        want["dk"], want["dv"] = fa.flash_dkv_reference(
            q, k, v, do, lse_ref, delta, causal, None, scale)
        torch.cuda.synchronize()
        errs = {}
        for name, a in {"o": o, "lse": lse, "dk": dk, "dv": dv,
                        "dq": dq}.items():
            require(bool(torch.isfinite(a).all()),
                    f"{gname} flash case: non-finite {name}")
            errs[name] = _max_err(a, want[name])
            require(errs[name] <= bounds[torch.bfloat16],
                    f"{gname} flash case: {name} max_abs_err {errs[name]} > "
                    f"{bounds[torch.bfloat16]}")
        share = _diff_share(dv, want["dv"])
        dv_shares.append((share, n, gname, S, causal, None))
        worst["bfloat16"] = max(worst["bfloat16"], *errs.values())
        emit({"phase": "flash_kernel_cases", "geometry": gname,
              "B": B, "heads": H, "kv_heads": kvH, "hd": 64,
              "dtype": "bfloat16", "S": [S],
              "masks": ["causal" if causal else "full"], "max_abs_err": errs,
              "bound": bounds[torch.bfloat16],
              "dv_diff_share": {"kernel": share}})
        del q, k, v, do, o, lse, dk, dv, dq, want, o_ref, lse_ref, delta
        torch.cuda.empty_cache()
    share, *case = max(dv_shares)
    emit({"phase": "flash_kernel_cases_done", "cases": n,
          "worst_abs_err": worst, "worst_dv_diff_share": share,
          "dv_diff_share_bound": DV_DIFF_SHARE_BOUND})
    require(share <= DV_DIFF_SHARE_BOUND,
            f"bf16 dv differs from the plain version in {share:.4f} of its "
            f"elements > {DV_DIFF_SHARE_BOUND} (case, geometry, S, causal, "
            f"window: {case}): is p rounded to bf16 before p^T . do?")
    return worst


def phase_flash_autograd(torch) -> float:
    """The ``autograd.Function`` (K1 forward, K2 and K3 backward) against
    autograd of ``xla_attention``, fp32: o and dq, dk, dv within 1e-4."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops.attention \
        import xla_attention
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .flash_attention import flash_attention

    cases = [dict(H=12, kvH=12, hd=64, S=512, causal=True, window=None),
             dict(H=32, kvH=8, hd=64, S=600, causal=True, window=256),
             dict(H=4, kvH=4, hd=128, S=300, causal=False, window=None),
             dict(H=8, kvH=8, hd=96, S=512, causal=True, window=None)]
    worst = 0.0
    for i, c in enumerate(cases):
        q, k, v, do = _flash_inputs(torch, B=2, S=c["S"], H=c["H"],
                                    kvH=c["kvH"], hd=c["hd"],
                                    dtype=torch.float32, seed=500 + i)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        kw = dict(causal=c["causal"], window=c["window"])
        outs = []
        for fn in (flash_attention, xla_attention):
            o = fn(q, k, v, **kw)
            outs.append((o, *torch.autograd.grad(o, (q, k, v), do)))
        torch.cuda.synchronize()
        errs = [_max_err(a, b) for a, b in zip(*outs)]
        emit({"phase": "flash_autograd", **c,
              "max_abs_err": dict(zip(("o", "dq", "dk", "dv"), errs)),
              "bound": 1e-4})
        require(max(errs) <= 1e-4,
                f"flash autograd case {c}: max_abs_err {max(errs)} > 1e-4")
        worst = max(worst, *errs)
    return worst


def phase_flash_determinism(torch) -> None:
    """bf16 K1, K2 and K3 launched twice on the same inputs give
    bitwise-equal outputs (no atomics; a fixed order of sums)."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    cases = [dict(H=12, hd=64, S=1024, causal=True, window=None),
             dict(H=16, hd=128, S=1000, causal=True, window=256),
             dict(H=4, hd=32, S=129, causal=False, window=None)]
    for i, c in enumerate(cases):
        q, k, v, do = _flash_inputs(torch, B=2, S=c["S"], H=c["H"],
                                    kvH=c["H"], hd=c["hd"],
                                    dtype=torch.bfloat16, seed=700 + i)
        kw = dict(causal=c["causal"], window=c["window"])
        runs = []
        for _ in range(2):
            o, lse = fa.flash_forward(q, k, v, **kw)
            delta = fa._delta(o, do)
            runs.append((o, lse, *fa.flash_dkv(q, k, v, do, lse, delta,
                                                **kw),
                         fa.flash_dq(q, k, v, do, lse, delta, **kw)))
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
        emit({"phase": "flash_determinism", **c, "bitwise_equal":
              dict(zip(("o", "lse", "dk", "dv", "dq"), same))})
        require(all(same), f"bf16 K1-K3 differ between two launches: {c}")


def _profiled_ms(torch, fn, n: int) -> float | None:
    """Device time of one call of ``fn`` from ``torch.profiler``: the
    union of its kernels' intervals over ``n`` calls in a row (L2 warm),
    per call; None when the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = _device_time(prof, n, 1)
    return None if dev is None else dev["device_busy_ms_per_step"]


def _flash_bound_ms(*, pairs, hd, n_products, bytes_moved):
    """The least time for the work: bytes over the HBM rate or the
    products' flops (2 per multiply-add) over the dense bf16 rate."""
    flops = 2 * n_products * pairs * hd
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return {"flops": flops, "bytes": bytes_moved,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _flash_timing_at(torch, flush, *, B, S, H, hd, causal, seed) -> dict:
    """K1, K2 and K3 at one bf16 shape: each against its plain version
    (2e-2), then timed beside the plain version, the bound and PyTorch's
    ``scaled_dot_product_attention`` (its backward for K2 and K3)."""
    import torch.nn.functional as F

    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    q, k, v, do = _flash_inputs(torch, B=B, S=S, H=H, kvH=H, hd=hd,
                                dtype=torch.bfloat16, seed=seed)
    kw = dict(causal=causal)
    o, lse = fa.flash_forward(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal)
    delta = fa._delta(o_ref, do)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse_ref, delta,
                                            causal)
    dq_ref = fa.flash_dq_reference(q, k, v, do, lse_ref, delta, causal)
    errs = {"flash_forward": max(_max_err(o, o_ref), _max_err(lse, lse_ref)),
            "flash_dkv": max(_max_err(dk, dk_ref), _max_err(dv, dv_ref)),
            "flash_dq": _max_err(dq, dq_ref)}
    for name, err in errs.items():
        require(err <= 2e-2, f"timing-shape {name} error {err} > 2e-2 "
                f"(B {B}, S {S}, causal {causal})")

    # the library yardstick: one PyTorch call for the same function
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))  # BHSD
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), dot,
                                   retain_graph=True)

    runs = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, **kw),
            lambda: fa.flash_forward_reference(q, k, v, causal),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)),
        "flash_dkv": (
            lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw),
            lambda: fa.flash_dkv_reference(q, k, v, do, lse_ref, delta,
                                           causal),
            sdpa_bwd),
        "flash_dq": (
            lambda: fa.flash_dq(q, k, v, do, lse_ref, delta, **kw),
            lambda: fa.flash_dq_reference(q, k, v, do, lse_ref, delta,
                                          causal),
            sdpa_bwd),
    }
    # the library calls' device time, timed once each: the cold-L2 median,
    # and beside it the kernel time that torch.profiler sees with a warm L2
    library_ms = {fn: (_time_ms(torch, fn, 20, flush),
                       _profiled_ms(torch, fn, 10))
                  for fn in dict.fromkeys(r[2] for r in runs.values())}
    # the (q, k) pairs the function needs: q >= k when causal, all if not
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    t_bytes = B * S * H * hd * q.element_size()  # one [B, S, H, hd] tensor
    row_bytes = B * H * S * 4                    # lse or delta, fp32
    work = {"flash_forward": dict(n_products=2,
                                  bytes_moved=4 * t_bytes + row_bytes),
            "flash_dkv": dict(n_products=4,
                              bytes_moved=6 * t_bytes + 2 * row_bytes),
            "flash_dq": dict(n_products=3,
                             bytes_moved=5 * t_bytes + 2 * row_bytes)}
    out = {}
    for name, (kernel, plain, library) in runs.items():
        ms = _time_ms(torch, kernel, 20, flush)
        plain_ms = _time_ms(torch, plain, 10, flush)
        rec = {"ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms[library][0],
               "library_profiler_ms": library_ms[library][1],
               "max_abs_err": errs[name],
               **_flash_bound_ms(pairs=pairs, hd=hd, **work[name])}
        rec["roofline_share"] = rec["bound_ms"] / ms
        rec["tflops"] = rec["flops"] / (ms * 1e-3) / 1e12
        emit({"phase": "flash_timing", "kernel": name,
              "shape": {"B": B, "S": S, "H": H, "hd": hd, "causal": causal,
                        "dtype": "bfloat16"},
              "library": ("scaled_dot_product_attention backward (dq, dk "
                          "and dv together)" if library is sdpa_bwd else
                          "scaled_dot_product_attention"), **rec})
        out[name] = rec
    return out


def phase_flash_timing(torch) -> tuple[dict, dict]:
    """K1-K3 timed at GPT-2 small's training shape (causal) and at BERT
    base's (B 8, S 512, not causal), then flash against ``xla`` through
    the dispatcher."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops.attention \
        import attention

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    out = _flash_timing_at(torch, flush, B=8, S=1024, H=12, hd=64,
                           causal=True, seed=1001)
    bert = _flash_timing_at(torch, flush, B=8, S=512, H=12, hd=64,
                            causal=False, seed=1002)
    B, H, hd = 8, 12, 64

    # flash against the einsum path through the dispatcher, forward and
    # forward + backward, from below the floor (512) to the training length
    for seq in (128, 256, 512, 1024):
        q, k, v, do = _flash_inputs(torch, B=B, S=seq, H=H, kvH=H, hd=hd,
                                    dtype=torch.bfloat16, seed=seq)
        qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
        rec = {}
        for impl in ("flash", "xla"):
            with torch.no_grad():
                rec[f"{impl}_fwd_ms"] = _time_ms(
                    torch, lambda: attention(q, k, v, causal=True,
                                             impl=impl), 10, flush)

            def fwd_bwd():
                o = attention(qg, kg, vg, causal=True, impl=impl)
                return torch.autograd.grad(o, (qg, kg, vg), do)

            rec[f"{impl}_fwd_bwd_ms"] = _time_ms(torch, fwd_bwd, 10, flush)
        emit({"phase": "flash_vs_xla", "S": seq, "B": B, "H": H, "hd": hd,
              "causal": True, "dtype": "bfloat16", **rec})
    return out, bert


# -- phase 9: the training main path ---------------------------------------


def _train_setup(torch, *, seed, **model_kw):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2, AutoDistribute, adamw, next_token_loss)

    # GPT2()'s defaults are the JAX package's: bf16 compute, fp32 params,
    # remat with policy "dots", attention_impl "auto"
    ad = AutoDistribute(GPT2("small", **model_kw), optimizer=adamw(1e-3),
                        loss_fn=next_token_loss)
    state = ad.init(torch.Generator(device="cuda").manual_seed(seed))
    return ad, state


def phase_train(torch, data, *, steps=12) -> dict[str, int]:
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    ad, state = _train_setup(torch, seed=0)
    cfg = ad.model.cfg
    wrappers = (fa.flash_forward, fa.flash_dkv, fa.flash_dq)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    # one batch for every step: at vocab 50257 a dozen fresh batches teach
    # the copy task nothing (each token id turns up ~0.16 times a batch;
    # the JAX package's loss stays flat the same way), while one batch
    # seen again must be learnt, so a falling loss shows the steps train
    batch = data.batch(0)
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = ad.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = {w.__name__: w.launches for w in wrappers}
    # remat "dots" recomputes each layer's attention in the backward: K1
    # runs twice per layer (forward and recompute), K2 and K3 once
    per_layer = {"flash_forward": 2 if cfg.remat else 1, "flash_dkv": 1,
                 "flash_dq": 1}
    expected = {n: steps * cfg.n_layers * c for n, c in per_layer.items()}
    median_ms = statistics.median(step_ms[1:])  # after one warm-up step
    seq = data.seq_len - 1  # inputs and shifted targets of seq_len tokens
    tokens = data.batch_size * seq
    n_params = sum(p.numel() for p in ad.model.parameters())
    emit({"phase": "train", "model": {
              "family": "gpt2", "layers": cfg.n_layers,
              "d_model": cfg.d_model, "heads": cfg.n_heads,
              "vocab": cfg.vocab_size, "seq": seq, "params": n_params,
              "compute_dtype": str(cfg.dtype).replace("torch.", ""),
              "remat": cfg.remat, "remat_policy": cfg.remat_policy,
              "attention_impl": cfg.attention_impl},
          "batch": data.batch_size, "steps": steps,
          "optimizer": "adamw(1e-3)",
          "precision": ad.precision.name, "loss_level_remat": ad.remat,
          "step_ms": step_ms, "median_step_ms": median_ms,
          "tokens_per_s": tokens / (median_ms / 1e3),
          "model_flop_share_of_bf16_dense_peak":
              6 * n_params * tokens / (median_ms / 1e3) / BF16_FLOPS_PER_S,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "losses": losses,
          "launches": launches,
          "launches_per_step": {n: c / steps for n, c in launches.items()},
          "expected_launches": expected})
    require(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, count in launches.items():
        require(count > 0, f"{name} never launched on the training path")
        require(count == expected[name],
                f"{name}: {count} launches, remat implies {expected[name]}")
    del ad, state
    return launches


def phase_train_parity(torch, data) -> dict:
    """One step on one set of weights and one batch, flash against xla
    attention: the step's loss, and the gradient it applies."""
    batch = data.batch(100)
    res = {}
    for impl in ("flash", "xla"):
        ad, state = _train_setup(torch, seed=5, attention_impl=impl)
        _, _, grads = ad._value_and_grad(ad._to_device(batch), None)
        flat = torch.cat([g.float().flatten() for g in grads.values()])
        state, metrics = ad.step(state, batch)
        res[impl] = (float(metrics["loss"]), flat)
        del ad, state, grads
    (lf, gf), (lx, gx) = res["flash"], res["xla"]
    norm_f, norm_x = float(gf.norm()), float(gx.norm())
    rec = {"loss_flash": lf, "loss_xla": lx, "loss_diff": abs(lf - lx),
           "grad_norm_flash": norm_f, "grad_norm_xla": norm_x,
           "grad_norm_rel_diff": abs(norm_f - norm_x) / norm_x,
           "grad_diff_rel_norm": float((gf - gx).norm()) / norm_x,
           "bounds": {"loss_diff": 1e-2, "grad_norm_rel_diff": 2e-2}}
    emit({"phase": "train_parity", **rec})
    require(math.isfinite(lf) and math.isfinite(lx), "non-finite loss")
    require(rec["loss_diff"] <= 1e-2,
            f"flash vs xla loss differs by {rec['loss_diff']} > 1e-2")
    require(rec["grad_norm_rel_diff"] <= 2e-2,
            f"flash vs xla grad norm differs by {rec['grad_norm_rel_diff']}"
            f" > 2e-2 (relative)")
    return rec


def phase_train_profile(torch, data, *, steps=5) -> None:
    """Where a training step's time goes: the host-clock time of
    ``steps`` steps, then the same number of steps under
    ``torch.profiler`` for the device time by kernel.  Device busy share
    = kernel time per step (the union of kernel intervals) over the
    unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    ad, state = _train_setup(torch, seed=0)
    batch = data.batch(0)
    state, _ = ad.step(state, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        state, _ = ad.step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = ad.step(state, batch)
        torch.cuda.synchronize()
    del ad, state
    rec = {"phase": "train_profile", "steps": steps, "step_ms": step_ms}
    dev = _device_time(prof, steps, 12)
    if dev is None:
        emit({**rec, "device_busy_ms_per_step": "not measured"})
        return
    # the flash kernels' device time per step, by kernel symbol
    from torch.autograd import DeviceType
    symbols = {"flash_forward": "flash_fwd_sm90",
               "flash_dkv": "flash_dkv_sm90", "flash_dq": "flash_dq_sm90"}
    flash_us = dict.fromkeys(symbols, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name, symbol in symbols.items():
                if symbol in e.name:
                    flash_us[name] += e.time_range.elapsed_us()
    emit({**rec, **dev, "device_busy_share":
          dev["device_busy_ms_per_step"] / step_ms,
          "flash_ms_per_step": {n: us / steps / 1e3
                                for n, us in flash_us.items()}})


# -- phase 10: the trainer stack --------------------------------------------


def _run_example(argv, callbacks):
    """The port's ``examples/train_gpt2.py`` ``main`` on ``argv``, its
    printout captured (and returned beside its result)."""
    import contextlib
    import io

    from torch_automatic_distributed_neural_network_tpu_torch.examples import \
        train_gpt2

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_gpt2.main(argv, callbacks=callbacks)
    return out, buf.getvalue()


def _recorder(into: list):
    """A Trainer callback keeping each step's number and loss tensor
    (read after the run, so it adds no host sync)."""
    def record(step, state, metrics):
        into.append((step, metrics["loss"]))
    return record


# what ``fleet_plans`` gives on any machine: (strategy, degrees above 1,
# loss-level remat, expected collective wire bytes a device a step with
# fp32 gradients); tests/test_torch_port_planner.py holds the CPU to it
FLEET_PLANS = {
    "gpt2-1p3b@1/auto": ["dp", {}, False, 0],
    "gpt2-1p3b@4/auto": ["dp", {"data": 4}, False, 7881756672],
    "gpt2-1p3b@4/fsdp": ["fsdp", {"fsdp": 4}, True, 11822635008],
    "gpt2-1p3b@4/tp_fsdp": ["tp_fsdp", {"fsdp": 2, "tensor": 2}, True,
                            4256649216],
    "gpt2-1p3b@8/auto": ["dp", {"data": 8}, False, 9195382784],
    "gpt2-1p3b@8/fsdp": ["fsdp", {"fsdp": 8}, True, 13793074176],
    "gpt2-1p3b@8/tp_fsdp": ["tp_fsdp", {"fsdp": 2, "tensor": 4}, True,
                            2444292096],
    "llama-3.2-1b@1/auto": ["dp", {}, False, 0],
    "llama-3.2-1b@4/auto": ["dp", {"data": 4}, False, 8990896128],
    "llama-3.2-1b@4/fsdp": ["fsdp", {"fsdp": 4}, True, 13486344192],
    "llama-3.2-1b@4/tp_fsdp": ["tp_fsdp", {"fsdp": 2, "tensor": 2}, True,
                               4495650816],
    "llama-3.2-1b@8/auto": ["dp", {"data": 8}, False, 10489378816],
    "llama-3.2-1b@8/fsdp": ["fsdp", {"fsdp": 8}, True, 15734068224],
    "llama-3.2-1b@8/tp_fsdp": ["tp_fsdp", {"fsdp": 2, "tensor": 4}, True,
                               2248028160],
}


def fleet_plans(torch) -> dict:
    """Plans for hypothetical fleets of 1, 4 and 8 H100s
    (``topology.parse_topology``), pure shape math on meta tensors:
    GPT-2 ``1p3b`` and Llama 3.2 1B at full width and depth, the auto
    strategy and, on several cards, ``fsdp`` and ``tp_fsdp``."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        planner, topology)
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        DecoderLM, gpt2_config, llama_config)

    out = {}
    for name, cfg in (("gpt2-1p3b", gpt2_config("1p3b")),
                      ("llama-3.2-1b", llama_config("1b"))):
        with torch.device("meta"):
            abstract = planner.abstract_params(DecoderLM(cfg))
        for n in (1, 4, 8):
            for strategy in ("auto", "fsdp", "tp_fsdp")[:1 if n == 1 else 3]:
                plan = planner.make_plan(
                    abstract, strategy=strategy, heads=(cfg.n_heads,
                                                        cfg.kv_heads),
                    topology=topology.parse_topology(f"h100-{n}"))
                est = planner.expected_collective_bytes(plan, abstract)
                out[f"{name}@{n}/{strategy}"] = [
                    plan.strategy,
                    {a: d for a, d in plan.degrees.items() if d > 1},
                    plan.remat, est["total_wire_bytes"]]
    return out


# the wrapped runs of phase dist_plan: AutoDistribute's options
DIST_RUNS = {"dp": dict(strategy="dp"), "fsdp": dict(strategy="fsdp"),
             "tp": dict(strategy="tp"), "tp_fsdp": dict(strategy="tp_fsdp"),
             "dp+zero1": dict(strategy="dp", zero1=True)}


def phase_dist_plan(torch, data, card, *, steps=5) -> dict[str, int]:
    """The planner on the card's topology and on hypothetical fleets, then
    the step wrapped by each strategy in a world of one NCCL rank, against
    the unwrapped step on the same weights and batch."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2, AutoDistribute, adamw, next_token_loss, planner, topology)
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    name = torch.cuda.get_device_name(0)
    topo = topology.detect()
    with torch.device("meta"):
        small = GPT2("small")
    cfg = small.cfg
    plan = planner.make_plan(planner.abstract_params(small), topology=topo,
                             heads=(cfg.n_heads, cfg.kv_heads))
    emit({"phase": "dist_plan_topology", "card": card,
          "topology": {"num_devices": topo.num_devices,
                       "platform": topo.platform,
                       "device_kind": topo.device_kind,
                       "hbm_bytes": topo.chip.hbm_bytes},
          "gpt2_small_plan": {"strategy": plan.strategy,
                              "degrees": plan.degrees, "remat": plan.remat}})
    require((topo.num_devices, topo.platform, topo.device_kind)
            == (1, "gpu", name), f"topology.detect() gave {topo}")
    require(plan.strategy == "dp" and plan.degrees["data"] == 1
            and math.prod(plan.degrees.values()) == 1,
            f"one card's plan is {plan.strategy} {plan.degrees}")
    fleets = fleet_plans(torch)
    emit({"phase": "dist_plan_fleets", "plans": fleets})
    require(fleets == FLEET_PLANS, "the fleet plans differ from the CPU's "
                                   "(FLEET_PLANS)")

    wrappers = (fa.flash_forward, fa.flash_dkv, fa.flash_dq)
    # remat "dots" in each layer: K1 forward and recompute, K2, K3 once;
    # no loss-level checkpoint on any run (remat=False), so each step
    # launches what phase train's does
    per_step = {"flash_forward": 2 * cfg.n_layers,
                "flash_dkv": cfg.n_layers, "flash_dq": cfg.n_layers}
    batch = data.batch(0)
    total = {w.__name__: 0 for w in wrappers}

    def run(**kw):
        ad = AutoDistribute(GPT2("small"), optimizer=adamw(1e-3),
                            loss_fn=next_token_loss, remat=False, **kw)
        state = ad.init(torch.Generator(device="cuda").manual_seed(0))
        for w in wrappers:
            w.launches = 0
        losses, step_ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, metrics = ad.step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
        launches = {w.__name__: w.launches for w in wrappers}
        for k, v in launches.items():
            total[k] += v
        rec = {"strategy": ad.plan.strategy, "degrees": ad.plan.degrees,
               "zero1": ad.plan.zero1, "loss_level_remat": ad.remat,
               "world_size": dist.get_world_size() if dist.is_initialized()
               else 1, "losses": losses, "step_ms": step_ms,
               "median_step_ms": statistics.median(step_ms[1:]),
               "launches_per_step": {k: v / steps
                                     for k, v in launches.items()}}
        del ad, state
        torch.cuda.empty_cache()
        return rec

    runs = {"unwrapped": run()}
    pg_dir = tempfile.mkdtemp()
    topology.initialize_distributed(
        backend="nccl", init_method=f"file://{os.path.join(pg_dir, 'pg')}",
        world_size=1, rank=0)
    try:
        for label, kw in DIST_RUNS.items():
            runs[label] = run(**kw)
    finally:
        dist.destroy_process_group()
    base = runs["unwrapped"]
    for label, rec in runs.items():
        rec["max_rel_loss_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(rec["losses"], base["losses"]))
        emit({"phase": "dist_plan", "run": label, "card": card, **rec,
              "unwrapped_median_step_ms": base["median_step_ms"],
              "expected_launches_per_step": per_step,
              "bounds": {"rel_loss_diff": 1e-3}})
    for label, rec in runs.items():
        require(all(math.isfinite(x) for x in rec["losses"]),
                f"{label}: non-finite loss {rec['losses']}")
        require(rec["max_rel_loss_diff"] <= 1e-3,
                f"{label}: losses {rec['losses']} differ from the unwrapped "
                f"{base['losses']} by {rec['max_rel_loss_diff']} > 1e-3")
        require(rec["launches_per_step"] == per_step,
                f"{label}: K1-K3 launches a step "
                f"{rec['launches_per_step']} != {per_step}")
        # ZeRO-1 on a data axis of 1 is the planner's no-op (as in JAX):
        # its run steps under DDP
        if label != "unwrapped":
            require(rec["strategy"] == DIST_RUNS[label]["strategy"]
                    and not rec["zero1"],
                    f"{label}: the plan is {rec['strategy']} "
                    f"zero1={rec['zero1']}")
    return total


def phase_trainer(torch) -> dict[str, int]:
    """The train_gpt2 example at full width through Trainer.fit: two runs
    over one checkpoint directory, a torn step between them, a fault
    inside the second, and the doctor on what is left."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import numpy as np

    from torch_automatic_distributed_neural_network_tpu_torch import cli
    from torch_automatic_distributed_neural_network_tpu_torch.data import (
        loader, write_token_file)
    from torch_automatic_distributed_neural_network_tpu_torch.obs import (
        Journal, as_default)
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        FaultInjector, tear_checkpoint)

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="tadnn_trainer_")
    try:
        # a seeded 2048-token sequence tiled to 2**20 tokens: the 1024-token
        # windows repeat, so the loss must fall within a few dozen steps
        corpus = os.path.join(tmp, "corpus.bin")
        base = np.random.RandomState(0).randint(0, 50257, size=2048)
        write_token_file(corpus, np.tile(base, 2**20 // 2048))
        require(loader._native_lib() is not None,
                "the native loader did not build with g++")
        ckpt = os.path.join(tmp, "ckpt")
        common = ["model.size=small", "model.seq_len=1024",
                  "run.batch_size=8", "run.log_every=1", "run.ckpt_every=10",
                  f"run.ckpt_dir={ckpt}", f"data.path={corpus}"]
        wrappers = (fa.flash_forward, fa.flash_dkv, fa.flash_dq)
        for w in wrappers:
            w.launches = 0
        journal = Journal(validate=True)
        run1, run2 = [], []
        with as_default(journal):
            out1, text1 = _run_example(
                common + ["run.steps=30",
                          f"run.metrics_path={tmp}/metrics1.jsonl"],
                [_recorder(run1)])
            backend = out1["data"].backend
            trainer1 = out1["trainer"]
            del out1
            torch.cuda.empty_cache()
            torn = tear_checkpoint(ckpt, 30)
            out2, text2 = _run_example(
                common + ["run.steps=40", "run.max_restarts=2",
                          f"run.metrics_path={tmp}/metrics2.jsonl"],
                [_recorder(run2), FaultInjector(33)])
        launches = {w.__name__: w.launches for w in wrappers}
        final_step = out2["state"].step
        goodput = {"run1": trainer1.goodput, "run2": out2["trainer"].goodput}
        del out2, trainer1
        torch.cuda.empty_cache()

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            doctor_rc = cli.main(["doctor", ckpt])
        doctor = buf.getvalue().splitlines()
        listing = sorted(os.listdir(ckpt))

        losses1 = {s: float(x) for s, x in run1}
        losses2 = [(s, float(x)) for s, x in run2]
        first_pass = dict(losses2[:13])  # steps 21-33, before the fault
        replay = {s: losses1[s] for s in range(21, 31)}
        rel = [abs(first_pass[s] - v) / abs(v) for s, v in replay.items()]
        with open(f"{tmp}/metrics1.jsonl") as fh:
            recs = [json.loads(ln) for ln in fh]
        steady = [r for r in recs if r["step"] >= 1]
        step_ms = statistics.median(r["step_time_s"] for r in steady) * 1e3
        names = [r["name"] for r in journal.records]
        saves = [r for r in journal.records if r["name"] == "ckpt.save"]
        writes = [r for r in journal.records
                  if r["name"] == "ckpt.async_save"]
        restores = [r for r in journal.records
                    if r["name"] == "ckpt.restore"]
        starts = [r["start_step"] for r in journal.records
                  if r["name"] == "run_start"]
        corrupt = [r for r in journal.records if r["name"] == "ckpt.corrupt"]
        restarts_used = names.count("elastic.restart")
        steps_run = len(run1) + len(run2)
        per_layer = {"flash_forward": 2, "flash_dkv": 1, "flash_dq": 1}
        expected = {n: steps_run * 12 * c for n, c in per_layer.items()}
        rec = {
            "phase": "trainer", "model": "gpt2-small", "seq": 1024,
            "batch": 8, "loader_backend": backend,
            "steps_run": {"run1": len(run1), "run2": len(run2)},
            "median_step_ms": step_ms,
            "tokens_per_s": 8 * 1024 / (step_ms / 1e3),
            "mfu": statistics.median(r["mfu"] for r in steady)
            if all("mfu" in r for r in steady) else None,
            "losses_run1": [losses1[s] for s in sorted(losses1)],
            "losses_run2": losses2,
            "replay_max_rel_diff": max(rel),
            "replay_bitwise_equal": all(first_pass[s] == v
                                        for s, v in replay.items()),
            "resumed_from_20": "resumed from step 20" in text2,
            "torn_files": torn, "corrupt_events": [
                {k: r[k] for k in ("step", "reason", "quarantined")}
                for r in corrupt],
            "run_starts": starts, "restarts_used": restarts_used,
            "final_step": final_step,
            "goodput": {run: {"seconds": g["seconds"],
                              "fractions": g["fractions"],
                              "goodput": g["goodput"]}
                        for run, g in goodput.items()},
            "checkpoint_bytes": writes[0]["bytes"] if writes else None,
            "save_dispatch_ms": [r["dur_s"] * 1e3 for r in saves],
            "write_to_durable_ms": [r["off_thread_s"] * 1e3 for r in writes],
            "restore_ms": [r["dur_s"] * 1e3 for r in restores
                           if "error" not in r],
            "failed_restore_ms": [r["dur_s"] * 1e3 for r in restores
                                  if "error" in r],
            "doctor_rc": doctor_rc, "doctor": doctor, "ckpt_dir": listing,
            "launches": launches, "expected_launches": expected,
            "seconds": time.monotonic() - t_phase,
        }
        emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(backend == "native", f"loader backend {backend}, not native")
    require(len(run1) == 30 and len(run2) == 23,
            f"steps run {len(run1)} + {len(run2)}, expected 30 + 23")
    require(all(math.isfinite(x) for x in losses1.values()),
            "non-finite loss in run 1")
    require(rec["losses_run1"][-1] < rec["losses_run1"][0],
            f"loss did not fall: {rec['losses_run1']}")
    require(rec["resumed_from_20"], "run 2 did not print 'resumed from "
                                    "step 20'")
    require("30.corrupt" in listing and any(r["step"] == 30 for r in corrupt),
            f"step 30 not quarantined: {listing}, {corrupt}")
    require(rec["replay_max_rel_diff"] <= 1e-4,
            f"replayed losses differ by {rec['replay_max_rel_diff']} > 1e-4 "
            "relative")
    require(restarts_used == 1, f"{restarts_used} restarts, expected 1")
    require(starts == [0, 20, 30], f"run starts {starts}, expected "
                                   "[0, 20, 30]")
    require(final_step == 40, f"final step {final_step}, expected 40")
    require(doctor_rc == 0, f"doctor exited {doctor_rc}")
    for name, count in launches.items():
        require(count == expected[name],
                f"{name}: {count} launches in the trainer runs, expected "
                f"{expected[name]}")
    return launches


# -- phases 18 and 19: training across processes ----------------------------


def phase_launch(card) -> dict:
    """``launch --smoke`` on the card: one NCCL worker (the default
    backend, one host) on the JAX package's launcher workload, a clean
    run and a run SIGKILLed right after step 3 (``ckpt_every`` 2, 8
    steps); the losses bitwise equal, one restart, the merged journal
    valid against the event schema, ``doctor --launch-dir`` healthy on
    the chaos run."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from torch_automatic_distributed_neural_network_tpu_torch import cli
    from torch_automatic_distributed_neural_network_tpu_torch.obs import (
        Journal, schema)

    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="tadnn_launch_")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["launch", "--smoke",
                           "--hosts", "1", "--steps", "8",
                           "--ckpt-every", "2", "--launch-dir", tmp])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        merged = Journal.read(out["merged_journal"])
        problems = [(r.get("name"), p) for r in merged
                    for p in schema.validate_record(r)]
        chaos = os.path.join(tmp, "chaos")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            doctor_rc = cli.main(["doctor", "--launch-dir", chaos])
        doctor = buf.getvalue().splitlines()
        with open(os.path.join(chaos, "worker_0.log")) as f:
            resumed = "resumed from step 2" in f.read()
        rec = {"phase": "launch", "card": card, "rc": rc,
               "parity": out["parity"], "restarts_used": out["restarts_used"],
               "final_loss": out["final_loss"], "world": out["world"],
               "spawn_to_first_heartbeat_s": {
                   "clean": [r["first_beat_s"] for r in out["clean_rounds_s"]],
                   "chaos": [r["first_beat_s"] for r in out["chaos_rounds_s"]]},
               "round_s": {
                   "clean": [r["seconds"] for r in out["clean_rounds_s"]],
                   "chaos": [r["seconds"] for r in out["chaos_rounds_s"]]},
               "resume_s": out["resume_s"], "resumed_from_2": resumed,
               "merged_records": len(merged),
               "schema_problems": problems[:5], "doctor_rc": doctor_rc,
               "doctor": doctor, "seconds": time.monotonic() - t0}
        emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(rc == 0 and out["parity"], f"launch --smoke: rc {rc}, {out}")
    require(out["restarts_used"] == 1,
            f"{out['restarts_used']} restarts, expected 1")
    require(resumed, "the restarted worker did not resume from step 2")
    require(not problems, f"merged journal breaks the schema: {problems[:5]}")
    require(doctor_rc == 0 and any("COMPLETED ok" in ln for ln in doctor),
            f"doctor --launch-dir: rc {doctor_rc}, {doctor}")
    return rec


class _OneBatch:
    """Step-indexed source giving one batch at every step (phase train's
    reason: fresh batches at vocab 50257 teach the copy task nothing)."""

    step_indexed = True

    def __init__(self, batch):
        self._batch = batch

    def batch(self, i):
        return self._batch

    def __iter__(self):
        while True:
            yield self._batch


def _ckpt_timing(journal) -> dict:
    """Save dispatch, write-to-durable and restore times and the bytes,
    from a journal's ``ckpt.*`` records."""
    recs = journal.records
    saves = [r for r in recs if r["name"] == "ckpt.save"]
    writes = [r for r in recs if r["name"] == "ckpt.async_save"]
    restores = [r for r in recs if r["name"] == "ckpt.restore"
                and "error" not in r]
    return {"save_dispatch_ms": [r["dur_s"] * 1e3 for r in saves],
            "write_to_durable_s": [r["off_thread_s"] for r in writes],
            "restore_s": [r["dur_s"] for r in restores],
            "bytes": writes[0]["bytes"] if writes else None}


def phase_sharded_trainer(torch, data, card, *, steps=20,
                          every=5) -> dict[str, int]:
    """GPT-2 small at full width and depth (B 8 x S 1024, bf16 compute)
    under the Trainer with a ``ShardedCheckpoint`` every ``every`` steps
    for ``steps`` steps; the newest step torn, a resumed fit falls back
    one interval (``ckpt.corrupt``) and replays bitwise; the newest
    intact step restored into fresh ``AutoDistribute``s under fsdp, tp
    and tp_fsdp in a world of one NCCL rank: parameters and moments
    bitwise equal to the saved ones, one more step's loss equal to the
    unwrapped continuation's; ``CheckpointManager`` (DCP) timed on the
    same state beside it.  Under the NCCL group the host-side agreements
    (the restores' verdicts, ``host_allgather``) run on the gloo side
    group ``topology.initialize_distributed`` made."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2, AutoDistribute, adamw, next_token_loss, topology)
    from torch_automatic_distributed_neural_network_tpu_torch.models \
        .transformer_core import gathered
    from torch_automatic_distributed_neural_network_tpu_torch.obs import (
        Journal, as_default)
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        CheckpointManager, Trainer, TrainerConfig, resilience)
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards \
        import ShardedCheckpoint, tear_shard
    from torch_automatic_distributed_neural_network_tpu_torch.utils.device \
        import host_allgather, host_group

    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="tadnn_sharded_")
    ckdir = os.path.join(tmp, "ckpt")
    src = _OneBatch(data.batch(0))
    wrappers = (fa.flash_forward, fa.flash_dkv, fa.flash_dq)

    def make_ad(**kw):
        # remat=False on every run: each launches what phase train's does
        return AutoDistribute(GPT2("small"), optimizer=adamw(1e-3),
                              loss_fn=next_token_loss, remat=False, **kw)

    stamps: dict[int, float] = {}

    def stamp(step, state, metrics):
        torch.cuda.synchronize()  # as MetricsLogger's log_every=1 does
        stamps[step] = time.monotonic()

    def fit(journal):
        losses = []
        trainer = Trainer(
            make_ad(), TrainerConfig(steps=steps, log_every=0,
                                     ckpt_every=every, preflight=False),
            ckpt=ShardedCheckpoint(ckdir),
            callbacks=[_recorder(losses), stamp], journal=journal)
        t = time.monotonic()
        state = trainer.fit(src)
        torch.cuda.synchronize()
        trainer.ckpt.close()
        return trainer, state, {s: float(x) for s, x in losses}, (
            time.monotonic() - t)

    def leaves(state):
        return {k: gathered(resilience.as_tensor(v)).detach().to(
            "cpu", copy=True) for k, v in resilience.flatten_state(
                state).items()}

    try:
        for w in wrappers:
            w.launches = 0
        j1, j2 = Journal(validate=True), Journal(validate=True)
        trainer1, state1, losses1, fit1_s = fit(j1)
        # a step's host ms (synchronized) from one callback to the next:
        # a plain step, and one that also dispatched a save (the save
        # runs before the step's callbacks)
        gaps = {s: (stamps[s] - stamps[s - 1]) * 1e3
                for s in range(2, steps + 1)}
        step_ms = statistics.median(
            v for s, v in gaps.items() if s % every)
        save_step_ms = [v for s, v in gaps.items() if s % every == 0]
        del trainer1, state1
        torch.cuda.empty_cache()
        saved = sorted(int(n) for n in os.listdir(ckdir) if n.isdigit())
        torn = tear_shard(ckdir, steps)
        trainer2, state2, losses2, fit2_s = fit(j2)
        launches = {w.__name__: w.launches for w in wrappers}
        corrupt = [r for r in j2.records if r["name"] == "ckpt.corrupt"]
        ad2 = trainer2.ad
        want = leaves(state2)  # step `steps`, as saved again by run 2

        # CheckpointManager (DCP) on the same state, in the same call
        topology.initialize_distributed(
            backend="nccl",
            init_method=f"file://{os.path.join(tmp, 'pg')}",
            world_size=1, rank=0)
        side = host_group()
        host_side = {"default": dist.get_backend(),
                     "host_group": dist.get_backend(side),
                     "separate": side is not None,
                     "allgather": host_allgather({"rank": 0})}
        jd = Journal(validate=True)
        with as_default(jd):
            cm = CheckpointManager(os.path.join(tmp, "dcp"))
            for s in (steps, steps + 1):
                cm.save(s, state2)
                cm.wait()
            state2 = cm.restore(state2, step=steps + 1)
            cm.close()
        got = leaves(state2)
        dcp_bitwise = all(torch.equal(got[k], v) for k, v in want.items())
        del got

        state2, m = ad2.step(state2, src.batch(steps))
        base_loss = float(m["loss"])
        del trainer2, ad2, state2
        torch.cuda.empty_cache()
        runs = {}
        for label in ("fsdp", "tp", "tp_fsdp"):
            ad = make_ad(strategy=label)
            state = ad.init(torch.Generator(device="cuda").manual_seed(1))
            jr = Journal(validate=True)
            with as_default(jr):
                state = ShardedCheckpoint(ckdir).restore(state)
            ad.adopt_state(state)
            got = leaves(state)
            for w in wrappers:
                w.launches = 0
            state, m = ad.step(state, src.batch(steps))
            runs[label] = {
                "strategy": ad.plan.strategy,
                "restored_bitwise": sorted(got) == sorted(want) and all(
                    torch.equal(got[k], want[k]) for k in want),
                "next_loss": float(m["loss"]),
                "restore_s": _ckpt_timing(jr)["restore_s"],
                "launches": {w.__name__: w.launches for w in wrappers}}
            del ad, state, got
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        per_step = {"flash_forward": 24, "flash_dkv": 12, "flash_dq": 12}
        steps_run = len(losses1) + len(losses2)
        rec = {
            "phase": "sharded_trainer", "card": card, "model": "gpt2-small",
            "batch": 8, "seq": 1024, "steps": steps, "ckpt_every": every,
            "saved_steps": saved, "torn_step": steps, "torn": torn,
            "losses_run1": [losses1[s] for s in sorted(losses1)],
            "run2_steps": sorted(losses2),
            "replay_bitwise": all(losses2[s] == losses1[s] for s in losses2),
            "corrupt_events": [{k: r[k] for k in ("step", "quarantined")}
                               for r in corrupt],
            "fit_s": {"run1": fit1_s, "run2": fit2_s},
            "median_step_ms": step_ms, "step_after_save_ms": save_step_ms,
            "sharded": {"run1": _ckpt_timing(j1), "run2": _ckpt_timing(j2)},
            "dcp": {**_ckpt_timing(jd), "restored_bitwise": dcp_bitwise},
            "unwrapped_next_loss": base_loss, "resharded": runs,
            "host_side": host_side,
            "launches": launches,
            "launches_per_step": {k: v / steps_run
                                  for k, v in launches.items()},
            "seconds": time.monotonic() - t0}
        emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(saved == list(range(every, steps + 1, every))[-3:],
            f"committed steps {saved}")
    require(torn and [r["step"] for r in corrupt] == [steps],
            f"torn step {steps} not quarantined: {corrupt}")
    require(sorted(losses2) == list(range(steps - every + 1, steps + 1)),
            f"run 2 ran steps {sorted(losses2)}: it did not fall back one "
            f"interval")
    require(rec["replay_bitwise"], "the resumed steps' losses differ")
    require(rec["losses_run1"][-1] < rec["losses_run1"][0],
            f"loss did not fall: {rec['losses_run1']}")
    require(dcp_bitwise, "the DCP round trip is not bitwise")
    require(host_side == {"default": "nccl", "host_group": "gloo",
                          "separate": True, "allgather": [{"rank": 0}]},
            f"host-side agreement group under NCCL: {host_side}")
    for label, r in runs.items():
        require(r["restored_bitwise"] and r["strategy"] == label,
                f"{label}: restore not bitwise ({r})")
        require(r["next_loss"] == base_loss,
                f"{label}: next loss {r['next_loss']} != unwrapped "
                f"{base_loss}")
        require(r["launches"] == per_step,
                f"{label}: K1-K3 a step {r['launches']}")
    require(rec["launches_per_step"] == per_step,
            f"K1-K3 a step {rec['launches_per_step']} != {per_step}")
    return launches


# -- phases 11 to 14: generation and the serving features -------------------


def _weight_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _engine_tokens(torch, model, prompts, *, max_new, **kw):
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import ServeEngine

    eng = ServeEngine(model, device="cuda", **kw)
    reqs = [eng.submit([int(t) for t in p], max_new_tokens=max_new,
                       eos_id=None) for p in prompts]
    eng.run()
    return [r.out_tokens for r in reqs]


def _divergences(torch, model, prompts, a_rows, b_rows) -> list[dict]:
    """Where two greedy decodes of one model first differ, row by row:
    the logit gap between the two tokens chosen there (fp32 cache over
    the common prefix), so a failed gate shows whether it fell on a near
    tie.  For an MoE model also the router's margin, the top-k-th
    expert probability less the next one's: the least over the layers at
    the diverging token, and the least over every layer and position of
    its context (a choice flipped there changes the keys and values the
    token reads), with that layer and position."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .decode import KVCache, forward_cached

    routers = [layer.mlp.router for layer in model.layers
               if hasattr(layer.mlp, "router")]
    out = []
    for row, (p, a, b) in enumerate(zip(prompts, a_rows, b_rows)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        toks = torch.tensor([list(p) + list(a[:j])], device="cuda")
        cache = KVCache.init(model.cfg, 1, toks.shape[1],
                             dtype=torch.float32, device="cuda")
        probs = []
        hooks = [r.register_forward_hook(
            lambda mod, inp, o: probs.append(torch.softmax(o.float(), -1)))
            for r in routers]
        try:
            lg = forward_cached(model, toks, cache)[0][0]
        finally:
            for h in hooks:
                h.remove()
        rec = {"row": row, "position": j, "tokens": [a[j], b[j]],
               "gap": float((lg[a[j]] - lg[b[j]]).abs())}
        if probs:
            k = model.cfg.top_k
            top = torch.stack(probs)[:, 0].topk(k + 1, dim=-1).values
            margin = top[..., k - 1] - top[..., k]  # [layers, positions]
            at = divmod(int(margin.argmin()), margin.shape[1])
            rec.update(router_margin_at_token=float(margin[:, -1].min()),
                       router_margin_min=float(margin.min()),
                       router_margin_min_layer=at[0],
                       router_margin_min_position=at[1])
        out.append(rec)
    return out


def phase_generate(torch) -> None:
    """``AutoDistribute.generate`` at GPT-2 small, B 4 x prompt 128 + 64
    new, greedy, bf16 weights and then ``quant="int8"``, as users run
    them: (1) tokens/s, the int8 / bf16 token agreement and the weight
    bytes of each; (2) each one's greedy tokens, 128 new a prompt, equal
    token for token to ``ServeEngine(attention_impl="dense")``'s on the
    same weights and prompts, like with like (see below), and, reported
    beside them, the agreement with the paged-kernel engine, whose
    decode keeps the probabilities fp32 (phase 5 holds K4 to the dense
    path); (3) ``speculative_generate`` with a 2-layer draft, fp32
    compute and cache, equal to plain greedy ``generate`` of its model;
    (4) the port's ``examples/generate_text.py`` with ``run.speculative=1``
    at its defaults (bf16, the JAX example's 1-layer draft): tokens/s and
    its agreement with plain greedy decoding, reported, not gated (bf16
    rounding that differs between a verify chunk and a one-token step
    flips argmax near-ties of a random model)."""
    import contextlib
    import io

    import numpy as np

    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2, AutoDistribute, next_token_loss)
    from torch_automatic_distributed_neural_network_tpu_torch.examples import \
        generate_text
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .decode import generate
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .quant import quantize_for_decode
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .speculative import speculative_generate

    B, P, N = 4, 128, 64
    f32 = torch.float32
    rs = np.random.RandomState(3)
    prompt = torch.from_numpy(rs.randint(1, 50257, size=(B, P))).cuda()

    def gpt2(dtype, seed, **kw):
        with torch.device("cuda"):
            m = GPT2("small", max_seq_len=1024, dtype=dtype,
                     **{"n_layers": CUT_LAYERS, **kw})
        return m.init_weights(torch.Generator(device="cuda").manual_seed(seed))

    m16 = gpt2(torch.bfloat16, 5).to(torch.bfloat16)
    ad = AutoDistribute(m16, loss_fn=next_token_loss, precision="bf16",
                        device="cuda")
    state = ad.init(None)
    q16 = quantize_for_decode(m16)
    modes = {
        "bf16": lambda: ad.generate(state, prompt, max_new_tokens=N),
        # quantized anew on each call, as the JAX package's jitted program
        "int8": lambda: ad.generate(state, prompt, max_new_tokens=N,
                                    quant="int8"),
        "int8_prequantized": lambda: generate(q16, prompt, max_new_tokens=N)}
    for fn in modes.values():
        fn()  # warm-up
    # three rounds in turn: host-clock times vary between calls and hosts
    secs = {name: [] for name in modes}
    runs = {}
    for _ in range(3):
        for name, fn in modes.items():
            out, sec = _timed(torch, fn)
            secs[name].append(sec)
            runs[name] = {"tokens": out[:, P:].tolist()}
    for name, r in runs.items():
        r.update(seconds=statistics.median(secs[name]),
                 seconds_all=secs[name],
                 tokens_per_s=B * N / statistics.median(secs[name]))
    # where a generate's time goes: device time per token step (prefill
    # included, spread over the N steps) against the host-clock step
    from torch.profiler import ProfilerActivity, profile

    device = {}
    for name in ("bf16", "int8_prequantized"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            modes[name]()
            torch.cuda.synchronize()
        dev = _device_time(prof, N, 5)
        host_ms = runs[name]["seconds"] / N * 1e3
        device[name] = ("not measured" if dev is None else
                        {**dev, "host_ms_per_step": host_ms,
                         "device_busy_share":
                             dev["device_busy_ms_per_step"] / host_ms})
    # generate against the engine, like with like: each prompt alone
    # (generate at B 1) through an engine of one slot, so that every
    # product has the same shape on both sides (one 128-row prefill
    # against a [1, 256] cache, then one-token steps over 256 keys); on
    # the dense path xla_attention rounds the probabilities to bf16 as
    # generate's does, and the paged engine, whose kernel keeps them
    # fp32, is reported beside it.  Batched generate's agreement with
    # the per-prompt runs is reported too (a [4, 128] prefill rounds its
    # bf16 products apart from [1, 128] ones).
    NG = 128
    vs_engine, diverged = {}, {}
    for name, model in (("bf16", m16), ("int8", q16)):
        alone = [generate(model, prompt[i:i + 1], max_new_tokens=NG)[
            0, P:].tolist() for i in range(B)]
        vs_engine[f"{name}_batched_vs_alone"] = _agreement(
            runs[name]["tokens"], [row[:N] for row in alone])
        for impl in ("dense", "paged"):
            eng = _engine_tokens(torch, model, prompt.tolist(), max_new=NG,
                                 n_slots=1, max_len=P + NG, block_size=16,
                                 prefill_chunk=P, attention_impl=impl)
            vs_engine[f"{name}_vs_{impl}"] = _agreement(alone, eng)
            diverged[f"{name}_vs_{impl}"] = _divergences(
                torch, model, prompt.tolist(), alone, eng)
    int8_agree = _agreement(runs["bf16"]["tokens"], runs["int8"]["tokens"])
    prequant_same = runs["int8"]["tokens"] == \
        runs["int8_prequantized"]["tokens"]
    vocab_ok = all(0 <= t < 50257 for r in runs.values()
                   for row in r["tokens"] for t in row)
    weight_bytes = {"bf16": _weight_bytes(m16), "int8": _weight_bytes(q16)}
    del ad, state, m16, q16

    # speculative decoding, fp32 throughout: equal to plain greedy
    m32 = gpt2(f32, 4)
    draft = gpt2(f32, 8, n_layers=2)
    sp_prompt = prompt[:1, :32]
    spec, spec_s = _timed(torch, lambda: speculative_generate(
        m32, draft, sp_prompt, max_new_tokens=N, k=4, cache_dtype=f32))
    greedy, greedy_s = _timed(torch, lambda: generate(
        m32, sp_prompt, max_new_tokens=N, cache_dtype=f32))
    spec_same = torch.equal(spec, greedy)
    del m32, draft

    buf = io.StringIO()
    argv = ["model.size=small", "run.speculative=1", "run.new_tokens=64",
            "run.device=cuda"]
    with contextlib.redirect_stdout(buf):
        res = generate_text.main(argv)
    plain, plain_s = _timed(torch, lambda: generate(
        res["model"], res["prompt"], max_new_tokens=64))
    ex_rows = res["tokens"][:, 32:].tolist()
    ex_agree = _agreement(ex_rows, plain[:, 32:].tolist())
    emit({"phase": "generate", "model": "gpt2-small", "batch": B,
          "prompt_len": P, "max_new": N,
          "generate_vs_engine_agreement": vs_engine,
          "generate_vs_engine_divergences": diverged,
          **{f"{k}_tokens_per_s": r["tokens_per_s"] for k, r in runs.items()},
          **{f"{k}_seconds": r["seconds_all"] for k, r in runs.items()},
          "int8_vs_bf16_token_agreement": int8_agree,
          "device_per_token_step": device,
          "weight_bytes": weight_bytes,
          "speculative_fp32_2layer_draft": {
              "prompt_len": 32, "max_new": N, "k": 4,
              "tokens_per_s": N / spec_s,
              "plain_greedy_tokens_per_s": N / greedy_s,
              "equals_plain_greedy": spec_same},
          "example_speculative": {
              "argv": argv, "tokens_per_s": res["tokens_per_s"],
              "plain_greedy_tokens_per_s": 64 / plain_s,
              "agreement_with_plain_greedy": ex_agree}})
    require(vs_engine["bf16_vs_dense"] == vs_engine["int8_vs_dense"] == 1.0,
            f"generate vs ServeEngine(dense) tokens agree on only "
            f"{vs_engine} (first divergences: {diverged})")
    require(spec_same, "speculative_generate (2-layer draft, fp32) "
                       "differs from plain greedy decoding")
    require(prequant_same, "int8 generate differs between quantizing per "
                           "call and quantizing once")
    require(vocab_ok, "generate: token id out of range")
    require(weight_bytes["int8"] < 0.6 * weight_bytes["bf16"],
            f"int8 weights {weight_bytes} not about half of bf16")
    require(res["tokens"].shape == (1, 96) and all(
        0 <= t < 50257 for row in ex_rows for t in row),
        f"generate_text run.speculative=1: tokens of shape "
        f"{res['tokens'].shape} or out of range")


def _serve_run(torch, model, prompts, *, max_new, **kw) -> dict:
    """One ServeEngine run with K4's launch count read around it alone."""
    from torch_automatic_distributed_neural_network_tpu_torch.obs.journal \
        import Journal
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention

    jnl = Journal(None, host0_only=False, meta={"tool": "chip_smoke"})
    paged_attention.launches = 0
    eng, reqs, done, wall = _serve(torch, model, prompts, max_new=max_new,
                                   impl="paged", journal=jnl, **kw)
    launches = paged_attention.launches
    require(len(done) == len(prompts) and all(
        r.n_generated == max_new for r in reqs),
        f"{len(done)}/{len(prompts)} requests finished")
    steps = [r for r in jnl.records if r.get("name") == "serve.step"]
    n_decode = sum(r["decode_s"] > 0 for r in steps)
    ttfts = [r.t_first_token - r.t_submit for r in done]
    return {"eng": eng, "tokens": [r.out_tokens for r in reqs],
            "launches": launches, "decode_steps": n_decode,
            "wall_s": wall,
            "tokens_per_s": sum(r.n_generated for r in done) / wall,
            "ttft_p50_s": _pct(ttfts, 0.50), "ttft_p99_s": _pct(ttfts, 0.99),
            "n_prompt_tokens": sum(r.n_prompt for r in done)}


def phase_serve_prefix(torch, model) -> dict:
    """The prefix cache at GPT-2 small: 16 requests, each a shared
    192-token prefix and 64 tokens of its own (prompt 256), 64 new, 8
    slots, block 16, chunk 32, the paged kernel; with and without
    ``prefix_cache``, for a bf16 and an int8 KV pool.  Gates: identical
    tokens with and without the cache, hits, and one K4 launch a layer a
    decode step in every run."""
    import numpy as np

    rs = np.random.RandomState(11)
    vocab = model.cfg.vocab_size
    shared = [int(t) for t in rs.randint(1, vocab, size=(192,))]
    prompts = [shared + [int(t) for t in rs.randint(1, vocab, size=(64,))]
               for _ in range(16)]
    base = dict(n_slots=8, max_len=1024, block_size=16, prefill_chunk=32)
    out = {}
    for pool in ("bf16", "int8"):
        runs = {}
        for cache in (False, True):
            r = _serve_run(torch, model, prompts, max_new=64,
                           quant_kv=pool == "int8", prefix_cache=cache,
                           **base)
            eng = r.pop("eng")
            require(r["launches"] == model.cfg.n_layers * r["decode_steps"],
                    f"serve_prefix {pool} cache={cache}: {r['launches']} K4 "
                    f"launches over {r['decode_steps']} decode steps")
            if cache:
                r.update(prefix_hits=eng.prefix_hits,
                         prefix_hit_rate=(eng.prefix_cached_tokens
                                          / r["n_prompt_tokens"]),
                         prefix_saved_chunks=eng.prefix_saved_chunks,
                         cow_forks=eng.cow_forks,
                         index_blocks=eng.prefix_cache.n_blocks)
            runs["on" if cache else "off"] = r
        same = runs["on"].pop("tokens") == runs["off"].pop("tokens")
        rec = {"phase": "serve_prefix", "model": "gpt2-small", "pool": pool,
               "requests": 16, "shared_prefix": 192, "prompt_len": 256,
               "max_new": 64, "tokens_identical": same,
               "launches_per_decode_step": {
                   k: r["launches"] / max(r["decode_steps"], 1)
                   for k, r in runs.items()},
               **runs}
        emit(rec)
        require(same, f"serve_prefix {pool}: tokens differ with the cache")
        require(runs["on"]["prefix_hits"] > 0,
                f"serve_prefix {pool}: no prefix hit")
        out[pool] = rec
    return out


def phase_serve_spec(torch, model) -> None:
    """Speculative decoding on the ``serve`` request set (GPT-2 small, 16
    requests x 256 prompt + 64 new, 8 slots): ``speculative=4`` against
    ``speculative=0``.  Gate: identical tokens.  Every verify step (T = 5)
    takes the dense gather path, as the JAX engine's do, so the
    speculative run launches K4 on no step; the plain run once a layer a
    decode step."""
    import numpy as np

    rs = np.random.RandomState(0)
    vocab = model.cfg.vocab_size
    prompts = [[int(t) for t in rs.randint(1, vocab, size=(256,))]
               for _ in range(16)]
    base = dict(n_slots=8, max_len=1024, block_size=16, prefill_chunk=32)
    runs = {}
    for k in (0, 4):
        r = _serve_run(torch, model, prompts, max_new=64, speculative=k,
                       **base)
        eng = r.pop("eng")
        r.update(k4_steps=eng.decode_routes["paged"],
                 dense_verify_steps=eng.decode_routes["dense"])
        if k:
            r.update(spec_drafted=eng.spec_drafted,
                     spec_accepted=eng.spec_accepted,
                     accept_rate=eng.spec_accepted / max(eng.spec_drafted, 1))
        runs[f"speculative_{k}"] = r
    plain, spec = runs["speculative_0"], runs["speculative_4"]
    same = plain.pop("tokens") == spec.pop("tokens")
    emit({"phase": "serve_spec", "model": "gpt2-small", "requests": 16,
          "prompt_len": 256, "max_new": 64, "tokens_identical": same,
          "decode_steps": {"plain": plain["decode_steps"],
                           "speculative": spec["decode_steps"]}, **runs})
    require(same, "serve_spec: speculative=4 tokens differ from plain")
    require(plain["launches"] == model.cfg.n_layers * plain["k4_steps"]
            and plain["k4_steps"] == plain["decode_steps"],
            "serve_spec: the plain run's K4 launches are not one a layer a "
            "decode step")
    require(spec["launches"] == 0 and spec["k4_steps"] == 0
            and spec["dense_verify_steps"] == spec["decode_steps"],
            "serve_spec: a verify step took the paged kernel")


def phase_head_dim_96(torch) -> None:
    """A decoder at a head dim outside the flash kernels' instances (GPT-2
    small's width in 8 heads: head_dim 96): one training step, where
    ``attention(impl="auto")`` takes flash (S 1024), the kernels running
    on operands zero-padded to head dim 128, and no plain attention; then
    a few tokens served by ``ServeEngine()`` with its defaults, which
    takes the paged kernel's head-dim-96 instance, once a layer a decode
    step, and gives the tokens of ``attention_impl="dense"``."""
    import numpy as np

    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2, SyntheticLM)
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        attention as attn_mod
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    chosen: dict[str, int] = {}
    real = {n: getattr(attn_mod, n)
            for n in ("xla_attention", "chunked_attention")}

    def counted(name):
        def fn(*a, **kw):
            chosen[name] = chosen.get(name, 0) + 1
            return real[name](*a, **kw)
        return fn

    wrappers = (fa.flash_forward, fa.flash_dkv, fa.flash_dq)
    for w in wrappers:
        w.launches = 0
    for n in real:
        setattr(attn_mod, n, counted(n))
    try:
        ad, state = _train_setup(torch, seed=6, n_heads=8)
        n_layers = ad.model.cfg.n_layers
        require(ad.model.cfg.head_dim == 96, "head_dim_96: wrong geometry")
        data = SyntheticLM(vocab_size=50257, seq_len=1025, batch_size=4)
        state, metrics = ad.step(state, data.batch(0))
        loss = float(metrics["loss"])
    finally:
        for n, f in real.items():
            setattr(attn_mod, n, f)
    flash = {w.__name__: w.launches for w in wrappers}
    del ad, state, data

    with torch.device("cuda"):
        model = GPT2("small", n_heads=8, max_seq_len=1024,
                     dtype=torch.float32)
    model.init_weights(torch.Generator(device="cuda").manual_seed(7))
    rs = np.random.RandomState(7)
    prompts = [[int(t) for t in rs.randint(1, 50257, size=(64,))]
               for _ in range(4)]
    geom = dict(n_slots=4, max_len=256, block_size=16)
    r = _serve_run(torch, model, prompts, max_new=16, **geom)
    eng = r.pop("eng")
    tokens = r.pop("tokens")
    dense = _engine_tokens(torch, model, prompts, max_new=16,
                           attention_impl="dense", **geom)
    emit({"phase": "head_dim_96", "model": "gpt2-small n_heads=8",
          "head_dim": 96,
          "train": {"loss": loss, "plain_attention_calls": chosen,
                    "flash_launches": flash, "kernel_head_dim": 128},
          "serve": {"attention_impl": eng.attention_impl,
                    "decode_routes": dict(eng.decode_routes),
                    "k4_launches": r["launches"],
                    "decode_steps": r["decode_steps"],
                    "tokens_per_s": r["tokens_per_s"],
                    "tokens_equal_dense": tokens == dense,
                    "first_tokens": tokens[0][:8]}})
    require(math.isfinite(loss) and abs(loss - math.log(50257)) < 1.0,
            f"head_dim_96: loss {loss} at random weights, not near "
            f"ln(50257)")
    require(not chosen and flash["flash_forward"] >= n_layers
            and flash["flash_dkv"] == flash["flash_dq"] == n_layers,
            f"head_dim_96: training attention took plain {chosen}, flash "
            f"launches {flash}")
    require(eng.attention_impl == "paged"
            and r["launches"] == n_layers * r["decode_steps"] > 0
            and eng.decode_routes["dense"] == 0,
            f"head_dim_96: the engine's decode steps did not take the "
            f"paged kernel ({r['launches']} launches, {eng.decode_routes})")
    require(tokens == dense, "head_dim_96: paged tokens differ from the "
                             "dense path's")


# -- phases 16 and 17: LoRA ---------------------------------------------------


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested optimizer state."""
    from torch_automatic_distributed_neural_network_tpu_torch.training.optim \
        import tree_map

    total = [0]

    def add(x):
        if hasattr(x, "element_size"):
            total[0] += x.numel() * x.element_size()

    tree_map(add, tree)
    return total[0]


def _timed_steps(torch, ad, state, batch, steps):
    """``steps`` steps on one batch: the state, the losses and the
    host-clock ms of each step (synchronized)."""
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = ad.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return state, losses, step_ms


def _kernels_per_step(torch, ad, state, batch, steps=3):
    """Kernel launches and device busy ms per training step under
    ``torch.profiler`` (None when the trace holds no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = ad.step(state, batch)
        torch.cuda.synchronize()
    dev = _device_time(prof, steps, 6)
    return state, dev


def phase_lora_train(torch, data, *, steps=12) -> dict[str, int]:
    """LoRA fine-tuning at GPT-2 small (B 8 x S 1024, the JAX defaults:
    bf16 compute, fp32 params, remat "dots", flash): ``LoraSpec(rank=16,
    alpha=32)`` on q/v/up through ``AutoDistribute(init_fn=lora_init_fn)``
    with ``lora_optimizer(adamw(3e-3))`` and ``lora_loss``, one batch
    stepped 12 times, the journal validated.  Gates: the first step's
    loss is the base model's on the batch (1e-6 relative: b = 0), the
    loss falls, every base tensor is bitwise unchanged, the optimizer
    state is the factors' two fp32 moments and nothing else, K1/K2/K3
    launch 24/12/12 a step, and ``merge_lora``'s plain weights give the
    adapted model's loss.  Reported beside the full fine-tune
    (``adamw(3e-3)`` on every parameter, same weights and batch, 6
    steps) in the same call: median step ms, peak memory, optimizer
    state bytes, kernels a step."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2, AutoDistribute, adamw, next_token_loss)
    from torch_automatic_distributed_neural_network_tpu_torch.obs import (
        Journal, as_default)
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa
    from torch_automatic_distributed_neural_network_tpu_torch.training \
        .lora import (LoraSpec, LoraTarget, is_lora_name, lora_init_fn,
                      lora_loss, lora_optimizer, lora_state, merge_lora)

    spec = LoraSpec(rank=16, alpha=32.0, targets=(
        LoraTarget(r"q_proj\.weight$", 1, 1, True),
        LoraTarget(r"v_proj\.weight$", 1, 1, True),
        LoraTarget(r"up_proj\.weight$", 1, 1, True)))
    batch = data.batch(0)
    cuda_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}

    def plain_loss(state_dict) -> float:
        with torch.device("cuda"):
            m = GPT2("small")
        m.load_state_dict(state_dict)
        with torch.no_grad():
            return float(next_token_loss(m, cuda_batch, None)[0])

    with torch.device("cuda"):
        base_model = GPT2("small")
    base_model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    base = {n: t.detach().clone() for n, t in base_model.state_dict().items()}
    del base_model
    base_loss = plain_loss(base)

    jnl = Journal(None, host0_only=False, validate=True,
                  meta={"tool": "chip_smoke"})
    with as_default(jnl):
        ad = AutoDistribute(
            GPT2("small"), optimizer=lora_optimizer(adamw(3e-3)),
            loss_fn=lora_loss(next_token_loss, spec),
            init_fn=lora_init_fn(base, spec))
        state = ad.init(torch.Generator(device="cuda").manual_seed(1))
        cfg = ad.model.cfg
        n_lora = sum(t.numel() for n, t in state.params.items()
                     if is_lora_name(n))
        n_base = sum(t.numel() for n, t in state.params.items()
                     if not is_lora_name(n))
        lora_bytes = sum(t.numel() * t.element_size()
                         for n, t in state.params.items() if is_lora_name(n))
        opt_bytes = _tensor_bytes(state.opt_state)
        wrappers = (fa.flash_forward, fa.flash_dkv, fa.flash_dq)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers:
            w.launches = 0
        state, losses, step_ms = _timed_steps(torch, ad, state, batch, steps)
        launches = {w.__name__: w.launches for w in wrappers}
        peak = torch.cuda.max_memory_allocated()
        unchanged = all(torch.equal(state.params[n], t)
                        for n, t in base.items())
        state, dev = _kernels_per_step(torch, ad, state, batch)
        adapted_loss = float(ad.eval_step(state, batch)["loss"])
    merged_loss = plain_loss(merge_lora(base, lora_state(ad.model), spec))
    del ad, state
    torch.cuda.empty_cache()

    # the full fine-tune on the same weights and batch, in this call
    with torch.device("cuda"):
        full_model = GPT2("small")
    full_model.load_state_dict(base)
    full = AutoDistribute(full_model, optimizer=adamw(3e-3),
                          loss_fn=next_token_loss)
    fstate = full.init(None)
    full_opt_bytes = _tensor_bytes(fstate.opt_state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fstate, full_losses, full_ms = _timed_steps(torch, full, fstate, batch, 6)
    full_peak = torch.cuda.max_memory_allocated()
    fstate, full_dev = _kernels_per_step(torch, full, fstate, batch)
    del full, fstate, full_model
    torch.cuda.empty_cache()

    per_layer = {"flash_forward": 2 if cfg.remat else 1, "flash_dkv": 1,
                 "flash_dq": 1}
    expected = {n: steps * cfg.n_layers * c for n, c in per_layer.items()}
    rel0 = abs(losses[0] - base_loss) / abs(base_loss)
    seq = data.seq_len - 1
    median_ms = statistics.median(step_ms[1:])
    emit({"phase": "lora_train", "model": "gpt2-small",
          "batch": data.batch_size, "seq": seq, "steps": steps,
          "lora": {"rank": spec.rank, "alpha": spec.alpha,
                   "targets": ["q_proj", "v_proj", "up_proj"]},
          "optimizer": "lora_optimizer(adamw(3e-3))",
          "compute_dtype": str(cfg.dtype).replace("torch.", ""),
          "params_base": n_base, "params_lora": n_lora,
          "losses": losses, "base_loss": base_loss,
          "step0_rel_diff_vs_base": rel0,
          "merged_loss": merged_loss, "adapted_loss": adapted_loss,
          "base_bitwise_unchanged": unchanged,
          "lora_param_bytes": lora_bytes, "opt_state_bytes": opt_bytes,
          "step_ms": step_ms, "median_step_ms": median_ms,
          "tokens_per_s": data.batch_size * seq / (median_ms / 1e3),
          "peak_memory_gib": peak / 2**30,
          "launches": launches,
          "launches_per_step": {n: c / steps for n, c in launches.items()},
          "kernels_per_step": dev and dev["kernels_per_step"],
          "device_busy_ms_per_step": dev and dev["device_busy_ms_per_step"],
          "full_finetune": {
              "optimizer": "adamw(3e-3)", "losses": full_losses,
              "step_ms": full_ms,
              "median_step_ms": statistics.median(full_ms[1:]),
              "peak_memory_gib": full_peak / 2**30,
              "opt_state_bytes": full_opt_bytes,
              "kernels_per_step": full_dev and full_dev["kernels_per_step"],
              "device_busy_ms_per_step":
                  full_dev and full_dev["device_busy_ms_per_step"]},
          "journal_records": len(jnl.records)})
    require(all(math.isfinite(x) for x in losses),
            f"lora_train: non-finite loss {losses}")
    require(rel0 <= 1e-6, f"lora_train: step-0 loss {losses[0]} is not the "
                          f"base model's {base_loss}")
    require(losses[-1] < losses[0], f"lora_train: loss did not fall {losses}")
    require(unchanged, "lora_train: a base tensor changed")
    require(opt_bytes == 2 * lora_bytes,
            f"lora_train: optimizer state {opt_bytes} B, the factors' two "
            f"moments are {2 * lora_bytes} B")
    require(abs(merged_loss - adapted_loss) <= 1e-5 * abs(adapted_loss),
            f"lora_train: merged weights give {merged_loss}, the adapted "
            f"model {adapted_loss}")
    for name, count in launches.items():
        require(count == expected[name],
                f"lora_train: {name} {count} launches, expected "
                f"{expected[name]}")
    return launches


def _lora_requests(rs, vocab, n, prompt_len, tenants):
    """``n`` seeded prompts; request j goes to tenant ``j % 4`` of the
    four, every fifth to the base model (None)."""
    prompts = [[int(t) for t in rs.randint(1, vocab, size=(prompt_len,))]
               for _ in range(n)]
    names = [None if j % 5 == 4 else tenants[j % len(tenants)]
             for j in range(n)]
    return prompts, names


def _lora_serve(torch, model, prompts, names, lora, *, max_new, n_adapters,
                quant, journal=None, **kw):
    """One multi-tenant ``ServeEngine`` run; K4's launches read around it
    alone; the engine, tokens, wall time and latencies."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import ServeEngine
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention
    from torch_automatic_distributed_neural_network_tpu_torch.training \
        .lora import LoraSpec

    eng = ServeEngine(model, lora_spec=LoraSpec(rank=16) if lora else None,
                      n_adapters=n_adapters, quant_adapters=quant,
                      journal=journal, device="cuda", **kw)
    for name, fac in (lora or {}).items():
        eng.register_adapter(name, fac)
    reqs = [eng.submit(p, max_new_tokens=max_new, eos_id=None,
                       adapter=n if lora else None)
            for p, n in zip(prompts, names)]
    torch.cuda.synchronize()
    paged_attention.launches = 0
    t0 = time.monotonic()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    require(len(done) == len(prompts) and all(
        r.n_generated == max_new for r in reqs),
        f"serve_lora: {len(done)}/{len(prompts)} requests finished")
    totals = [(r.t_done or 0.0) - r.t_submit for r in done]
    return {"eng": eng, "tokens": [r.out_tokens for r in reqs],
            "launches": paged_attention.launches, "wall_s": wall,
            "tokens_per_s": sum(r.n_generated for r in done) / wall,
            "p99_latency_s": _pct(totals, 0.99),
            "p50_latency_s": _pct(totals, 0.50)}


def _decode_kernels(torch, model, prompts, names, lora, *, steps=8, **kw):
    """Kernel launches and device busy ms a pure decode step (every slot
    decoding) under ``torch.profiler``, with the tenants' adapters or
    without (``lora`` None)."""
    from torch.profiler import ProfilerActivity, profile

    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import ServeEngine
    from torch_automatic_distributed_neural_network_tpu_torch.training \
        .lora import LoraSpec

    n = kw["n_slots"]
    eng = ServeEngine(model, lora_spec=LoraSpec(rank=16) if lora else None,
                      n_adapters=len(lora or {}) + 1,
                      prefill_chunks_per_step=n, device="cuda", **kw)
    for name, fac in (lora or {}).items():
        eng.register_adapter(name, fac)
    for p, a in zip(prompts[:n], names[:n]):
        eng.submit(p, max_new_tokens=3 * steps, eos_id=None,
                   adapter=a if lora else None)
    while eng.scheduler.n_decoding < n:
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    dev = _device_time(prof, steps, 4) or {}
    return {"decode_step_ms": step_ms,
            "kernels_per_step": dev.get("kernels_per_step", "not measured"),
            "device_busy_ms_per_step": dev.get("device_busy_ms_per_step",
                                               "not measured")}


def phase_serve_lora(torch) -> int:
    """Multi-tenant LoRA serving at GPT-2 small (fp32 compute, bf16 KV,
    block 16, chunk 32, 8 slots, the paged kernel): 16 requests of 256
    prompt + 64 new tokens, four rank-16 tenants (``random_adapter``),
    every fifth request on the base model; journals validated.  Runs:
    ``n_adapters=5`` with fp32 factors, then int8 factors, then
    ``n_adapters=3`` (two pool slots for four tenants: faults, stalls,
    requeues), and the same requests without adapters.  Gates: one K4
    launch a layer a decode step in every run, no adapter pin left, and
    each request's tokens equal to those of the same request alone in a
    one-slot engine with the same adapter and pool type.  Reported:
    agreement with ``generate`` on each tenant's merged weights, the hit
    rate, tokens/s and p99 with adapters on and off, kernels and device
    ms a decode step with and without adapters."""
    import numpy as np

    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .decode import generate
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .serve import random_adapter
    from torch_automatic_distributed_neural_network_tpu_torch.models import \
        gpt2_config
    from torch_automatic_distributed_neural_network_tpu_torch.models \
        .transformer_core import DecoderLM
    from torch_automatic_distributed_neural_network_tpu_torch.obs import \
        Journal
    from torch_automatic_distributed_neural_network_tpu_torch.training \
        .lora import LoraSpec, merge_lora

    cfg = gpt2_config("small", max_seq_len=1024, dtype=torch.float32,
                      n_layers=CUT_LAYERS)
    with torch.device("cuda"):
        model = DecoderLM(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(1))
    spec = LoraSpec(rank=16)
    names4 = [f"tenant{i}" for i in range(4)]
    lora = {n: random_adapter(model, spec, seed=100 + i)
            for i, n in enumerate(names4)}
    rs = np.random.RandomState(8)
    prompts, names = _lora_requests(rs, cfg.vocab_size, 16, 256, names4)
    max_new, n_layers = 64, cfg.n_layers
    geom = dict(n_slots=8, max_len=1024, block_size=16, prefill_chunk=32)
    # warm-up: first-call costs stay out of the timed runs
    _lora_serve(torch, model, prompts[:2], names[:2], lora, max_new=2,
                n_adapters=5, quant=False, **geom)

    runs, engines, launches = {}, {}, 0
    for key, n_adapters, quant in (("fp32", 5, False), ("int8", 5, True),
                                   ("fp32_3slots", 3, False)):
        jnl = Journal(None, host0_only=False, validate=True,
                      meta={"tool": "chip_smoke"})
        r = _lora_serve(torch, model, prompts, names, lora, max_new=max_new,
                        n_adapters=n_adapters, quant=quant, journal=jnl,
                        **geom)
        eng = r.pop("eng")
        steps = [x for x in jnl.records if x["name"] == "serve.step"]
        n_decode = sum(x["decode_s"] > 0 for x in steps)
        kinds = [x["kind"] for x in jnl.records
                 if x["name"] == "serve.adapter"]
        alloc = eng.adapter_pool.allocator
        require(r["launches"] == n_layers * n_decode > 0
                and eng.decode_routes["dense"] == 0,
                f"serve_lora {key}: {r['launches']} K4 launches over "
                f"{n_decode} decode steps of {n_layers} layers")
        require(alloc.n_pinned == 0, f"serve_lora {key}: a pin is left")
        eng.scheduler.check_invariants()
        launches += r["launches"]
        runs[key] = {**r, "n_adapters": n_adapters, "quant_adapters": quant,
                     "decode_steps": n_decode,
                     "launches_per_decode_step": r["launches"] / n_decode,
                     "adapter_hit_rate": alloc.hit_rate,
                     "faults": kinds.count("fault"),
                     "hits": kinds.count("hit"),
                     "stalls": kinds.count("stall"),
                     "evictions": alloc.evictions,
                     "requeues": eng.scheduler.n_preemptions,
                     "pool_bytes": eng.adapter_pool.total_bytes,
                     "journal_records": len(jnl.records)}
        engines[key] = eng
    require(runs["fp32_3slots"]["stalls"] > 0
            and runs["fp32_3slots"]["evictions"] > 0,
            "serve_lora: two pool slots for four tenants never stalled")
    # like with like: each request alone in a one-slot engine with the
    # same adapter and pool type
    alone = {}
    for quant in (False, True):
        r = _lora_serve(torch, model, prompts, names, lora, max_new=max_new,
                        n_adapters=5, quant=quant,
                        **{**geom, "n_slots": 1})
        alone[quant] = r["tokens"]
        launches += r["launches"]
    for key, rec in runs.items():
        rec["tokens_equal_alone"] = rec["tokens"] == alone[
            rec["quant_adapters"]]
    # the merged-weight reference: generate per tenant, its prompts batched
    merged_rows = [None] * len(prompts)
    for name in [None] + names4:
        idx = [j for j, n in enumerate(names) if n == name]
        ref = model
        if name is not None:
            ref = DecoderLM(cfg).cuda()
            ref.load_state_dict(merge_lora(
                model, engines["fp32"].adapter_pool.effective_lora(name),
                spec))
        out = generate(ref, torch.tensor([prompts[j] for j in idx],
                                         device="cuda"),
                       max_new_tokens=max_new, cache_dtype=torch.bfloat16)
        for row, j in enumerate(idx):
            merged_rows[j] = out[row, len(prompts[j]):].tolist()
        del ref
    off = _lora_serve(torch, model, prompts, names, None, max_new=max_new,
                      n_adapters=8, quant=False, **geom)
    off.pop("eng")
    launches += off["launches"]
    kern_on = _decode_kernels(torch, model, prompts, names, lora, **{
        k: v for k, v in geom.items() if k != "prefill_chunk"})
    kern_off = _decode_kernels(torch, model, prompts, names, None, **{
        k: v for k, v in geom.items() if k != "prefill_chunk"})
    agree = _agreement(runs["fp32"]["tokens"], merged_rows)
    for rec in runs.values():
        rec.pop("tokens")
    emit({"phase": "serve_lora", "model": "gpt2-small", "requests": 16,
          "prompt_len": 256, "max_new": max_new, "tenants": 4,
          "rank": spec.rank, **geom, "kv_dtype": "bfloat16",
          "runs": runs,
          "agreement_vs_merged_generate": agree,
          "adapters_off": {k: off[k] for k in (
              "tokens_per_s", "p50_latency_s", "p99_latency_s", "wall_s",
              "launches")},
          "decode_step_kernels": {"adapters_on": kern_on,
                                  "adapters_off": kern_off}})
    for key, rec in runs.items():
        require(rec["tokens_equal_alone"],
                f"serve_lora {key}: tokens differ from each request alone "
                f"in a one-slot engine")
    del model, engines
    torch.cuda.empty_cache()
    return launches


# -- phase 20: the model zoo on one card -------------------------------------


_FLASH_NAMES = ("flash_forward", "flash_dkv", "flash_dq")
# BERT base through K1-K3 against the plain attention, bf16: the losses of
# steps 1-3 on one batch
_BERT_LOSS_BOUND = 2e-3
# each K1-K3 call of one BERT base step, against its plain version on the
# very same tensors: the largest error over the output's largest magnitude
_PATH_CALL_BOUND = 2e-2


def _zoo_run(torch, family, module, argv, data, *, steps, items,
             keep=False):
    """One example's ``main`` (``examples/<module>.py``) at full width,
    stepping on one batch (``data``): its per-step metrics records (host
    step ms, synchronised by the loss fetch of every step), the K1-K3
    launches of the run, the peak memory and the wall time; with
    ``keep``, ``(record, what main returned)``."""
    import contextlib
    import importlib
    import io
    import os
    import shutil
    import tempfile

    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    mod = importlib.import_module(
        f"torch_automatic_distributed_neural_network_tpu_torch.examples."
        f"{module}")
    wrappers = [getattr(fa, n) for n in _FLASH_NAMES]
    for w in wrappers:
        w.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="tadnn_zoo_")
    try:
        if module == "train_mnist_mlp":
            argv = argv + ["--steps", str(steps), "--log-every", "1",
                           "--out-dir", tmp]
            path = os.path.join(tmp, "metrics.jsonl")
        else:
            path = os.path.join(tmp, "metrics.jsonl")
            argv = argv + [f"run.steps={steps}", "run.log_every=1",
                           f"run.metrics_path={path}"]
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv, data=data)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        with open(path) as f:
            records = [json.loads(line) for line in f if line.strip()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    records = [r for r in records if "step_time_s" in r]
    require(len(records) == steps,
            f"{family}: {len(records)} metrics records for {steps} steps")
    step_ms = [r["step_time_s"] * 1e3 for r in records]
    losses = [r["loss"] for r in records]
    median_ms = statistics.median(step_ms[1:])  # after one warm-up step
    mfu = [r["mfu"] for r in records[1:] if "mfu" in r]
    launches = {w.__name__: w.launches for w in wrappers}
    rec = {"family": family, "example": module, "argv": argv,
           "steps": steps, "step_ms": step_ms, "median_step_ms": median_ms,
           "items_per_step": items,
           "items_per_s": items / (median_ms / 1e3),
           "mfu": statistics.median(mfu) if mfu else None,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "launches": launches,
           "launches_per_step": {n: c / steps for n, c in launches.items()},
           "seconds": seconds,
           "printed_last": buf.getvalue().strip().splitlines()[-1]}
    require(all(math.isfinite(x) for x in losses),
            f"{family}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{family}: loss did not fall: {losses}")
    return (rec, out) if keep else rec


def _checked_calls(run) -> tuple:
    """``run()`` with every K1-K3 wrapper call also computed by the
    kernel's plain version on the very same tensors: what ``run``
    returns, the calls of each kernel, and each kernel's largest error
    over the largest magnitude of the output it was compared on."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    plain = {"flash_forward": fa.flash_forward_reference,
             "flash_dkv": fa.flash_dkv_reference,
             "flash_dq": fa.flash_dq_reference}
    kernels = {name: getattr(fa, name) for name in _FLASH_NAMES}
    calls = dict.fromkeys(_FLASH_NAMES, 0)
    errs = dict.fromkeys(_FLASH_NAMES, 0.0)

    def checked(name):
        def call(*args, **kw):
            got = kernels[name](*args, **kw)
            want = plain[name](*args, **kw)
            for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (got, want))):
                scale = float(b.detach().float().abs().max())
                errs[name] = max(errs[name],
                                 _max_err(a, b) / max(scale, 1e-30))
            calls[name] += 1
            return got
        call.launches = 0  # the wrapper counts its launches by its name
        return call

    for name in _FLASH_NAMES:
        setattr(fa, name, checked(name))
    try:
        out = run()
    finally:
        for name, kernel in kernels.items():
            setattr(fa, name, kernel)
    return out, calls, errs


def phase_zoo(torch) -> dict[str, int]:
    """The rest of the model zoo through its examples' entry points
    (``AutoDistribute`` and ``Trainer.fit``, or the MoE and MNIST
    examples' own loops), at full width with random weights from a seed,
    each stepping on one batch of its synthetic stream: BERT base MLM at
    B 8 x S 512 (K1-K3 non-causal; one more step's K1-K3 calls each held
    to its plain version on its own tensors), the same with the plain
    attention (the losses of steps 1-3 within ``_BERT_LOSS_BOUND``), MoE ``small`` at B 8 x S 1024 (K1-K3
    causal beside the routed expert bank), ViT-B/16 at B 64 x 224^2, the
    MT Transformer base at B 64 x 64 and the MNIST MLP at B 128.  Each
    family's K1-K3 launches a step must be what its depth and remat
    imply (none below the flash floor of 512)."""
    from torch_automatic_distributed_neural_network_tpu_torch.data import (
        SyntheticClassification, SyntheticLM, SyntheticMLM, SyntheticSeq2Seq)
    from torch_automatic_distributed_neural_network_tpu_torch.models.moe \
        import MoEMlp

    t_phase = time.monotonic()
    total = dict.fromkeys(_FLASH_NAMES, 0)
    per_layer = {"flash_forward": 2, "flash_dkv": 1, "flash_dq": 1}  # remat

    def check_launches(rec, layers):
        for name, count in rec["launches"].items():
            want = rec["steps"] * layers * per_layer[name]
            require(count == want, f"{rec['family']}: {name} launched "
                    f"{count} times, {layers} layers and remat imply {want}")
            total[name] += count

    # BERT base, masked LM at its published maximum length
    bert_argv = ["model.size=base", "model.seq_len=512", "run.batch_size=8"]
    mlm = _OneBatch(SyntheticMLM(vocab_size=30522, seq_len=512,
                                 batch_size=8).batch(0))
    bert, out = _zoo_run(torch, "bert-base-mlm", "train_bert_mlm", bert_argv,
                         mlm, steps=10, items=8 * 512, keep=True)
    check_launches(bert, 12)
    # one more step's gradients at the run's last weights, every K1-K3
    # call also made by its plain version on the very same tensors
    ad = out["trainer"].ad
    _, calls, call_errs = _checked_calls(
        lambda: ad._value_and_grad(ad._to_device(mlm.batch(0)), None))
    del out, ad
    gc.collect()
    plain = _zoo_run(torch, "bert-base-mlm-xla", "train_bert_mlm",
                     bert_argv + ["model.attention_impl=xla"], mlm,
                     steps=3, items=8 * 512)
    require(all(c == 0 for c in plain["launches"].values()),
            f"the plain BERT run launched flash kernels: {plain['launches']}")
    bert["path_calls"] = calls
    bert["path_call_rel_err"] = call_errs
    bert["path_call_bound"] = _PATH_CALL_BOUND
    # steps 1-3 on the same batch from the same weights: step 1's loss is
    # K1's forward, steps 2 and 3 follow updates made from K2 and K3
    n = plain["steps"]
    bert["losses_xla"] = plain["losses"]
    bert["loss_diffs"] = [abs(a - b) for a, b in
                          zip(bert["losses"][:n], plain["losses"])]
    bert["loss_bound"] = _BERT_LOSS_BOUND
    bert["xla_median_step_ms"] = plain["median_step_ms"]
    bert["xla_peak_memory_gib"] = plain["peak_memory_gib"]
    emit({"phase": "zoo", **bert})
    require(max(bert["loss_diffs"]) <= _BERT_LOSS_BOUND,
            f"BERT flash vs plain losses of steps 1-{n} differ by "
            f"{bert['loss_diffs']}, over {_BERT_LOSS_BOUND}")
    require(calls == {k: 12 * c for k, c in per_layer.items()},
            f"BERT: K1-K3 called {calls} times in the checked step")
    for name, err in call_errs.items():
        require(err <= _PATH_CALL_BOUND,
                f"BERT: {name} differs from its plain version by {err} of "
                f"the output's largest magnitude, over {_PATH_CALL_BOUND}")

    # MoE small: the routing metrics of the first step's forward, read off
    # each layer's expert bank by a global forward hook that removes itself
    # once it has every layer's
    first = []

    def on_forward(module, args, output):
        if isinstance(module, MoEMlp):
            first.append({k: float(v) for k, v in module.metrics.items()})
            if len(first) == module.cfg.n_layers:
                hook.remove()

    hook = torch.nn.modules.module.register_module_forward_hook(on_forward)
    try:
        moe = _zoo_run(
            torch, "moe-small", "train_moe",
            ["model.size=small", "model.seq_len=1024", "run.batch_size=8"],
            _OneBatch(SyntheticLM(vocab_size=32000, seq_len=1025,
                                  batch_size=8).batch(0)),
            steps=6, items=8 * 1024)
    finally:
        hook.remove()
    from torch_automatic_distributed_neural_network_tpu_torch.models import \
        moe_config

    mcfg = moe_config("small", max_seq_len=1024)
    require(len(first) == mcfg.n_layers,
            f"MoE: routing metrics of {len(first)} layers")
    moe["first_step_routing"] = {
        k: statistics.mean(layer[k] for layer in first)
        for k in ("dropped_fraction", "aux_loss", "z_loss")}
    moe["first_step_routing_per_layer"] = first
    moe["params"] = {"total": mcfg.num_params(),
                     "active": mcfg.active_params()}
    emit({"phase": "zoo", **moe})
    check_launches(moe, 12)

    # the families below the flash floor: plain GEMMs, no flash kernel.
    # ViT-B/16 steps at lr 1e-4: the example's default 3e-3 is set for its
    # test-size default model
    for family, module, argv, data, steps, items in (
            ("vit-b16", "train_vit",
             ["model.size=base", "model.image_size=224",
              "model.patch_size=16", "model.num_classes=1000",
              "run.batch_size=64", "run.lr=1e-4"],
             SyntheticClassification(image_shape=(224, 224, 3),
                                     num_classes=1000, batch_size=64),
             6, 64),
            ("mt-base", "train_transformer_mt",
             ["model.size=base", "run.batch_size=64"],
             SyntheticSeq2Seq(vocab_size=32000, src_len=64, tgt_len=64,
                              batch_size=64), 6, 64 * 64),
            ("mnist-mlp", "train_mnist_mlp", ["--batch-size", "128"],
             SyntheticClassification(batch_size=128), 10, 128)):
        rec = _zoo_run(torch, family, module, argv,
                          _OneBatch(data.batch(0)), steps=steps, items=items)
        emit({"phase": "zoo", **rec})
        check_launches(rec, 0)
    emit({"phase": "zoo_done", "launches": total,
          "seconds": time.monotonic() - t_phase})
    return total



# -- phase 21: ResNet with BatchNorm ------------------------------------------


# card against the port's CPU path: fp32, TF32 off, the same weights and
# batch; the largest error over the CPU result's largest magnitude
_RESNET_CPU_BOUND = 1e-3
# DDP at degree 1 in a world of one NCCL rank against the unwrapped step:
# the losses, relative (the statistics' all-reduce and the gradient mean
# over one rank change no number)
_RESNET_NCCL_BOUND = 1e-6
# the H100 SXM's dense bf16 rate for ResNet's MFU, as the JAX bench counts
_MFU_PEAK = 989.4e12


def _rel(got, want) -> float:
    """Largest error of ``got`` over the largest magnitude of ``want``,
    both moved to the CPU."""
    want = want.detach().float().cpu()
    return _max_err(got.cpu(), want) / max(float(want.abs().max()), 1e-30)


def _resnet_card_vs_cpu(torch) -> dict:
    """ResNet-50 (ImageNet stem, 224^2, B 4, fp32) from one set of seeded
    weights on the card and on the CPU: one SGD-momentum step each on the
    same batch, then the running statistics and ``ad(state, x,
    train=False)`` of both, held within ``_RESNET_CPU_BOUND``."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute, ResNet50, sgd, softmax_xent_loss_mutable)

    import numpy as np

    rs = np.random.RandomState(7)
    batch = {"x": rs.rand(4, 224, 224, 3).astype("float32"),
             "label": rs.randint(0, 1000, 4).astype("int32")}
    weights = ResNet50(dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(3)).state_dict()
    out = {}
    for device in ("cuda", "cpu"):
        model = ResNet50(dtype=torch.float32)
        model.load_state_dict(weights)
        ad = AutoDistribute(model, optimizer=sgd(0.1, momentum=0.9),
                            loss_fn=softmax_xent_loss_mutable, device=device)
        state = ad.init(None)
        state, m = ad.step(state, batch)
        out[device] = {"loss": float(m["loss"]),
                       "stats": {n: t.detach().cpu().clone()
                                 for n, t in state.model_state.items()},
                       "logits": ad(state, batch["x"], train=False).cpu()}
        del ad, state, model
    card, cpu = out["cuda"], out["cpu"]
    stats_err = max(_rel(card["stats"][n], t) for n, t in cpu["stats"].items())
    return {"loss_card": card["loss"], "loss_cpu": cpu["loss"],
            "running_stats_rel_err": stats_err,
            "eval_logits_rel_err": _rel(card["logits"], cpu["logits"]),
            "bound": _RESNET_CPU_BOUND}


def _resnet_bench_cell(torch, *, steps=6) -> dict:
    """``bench.py``'s ResNet cell on the port: ResNet-50, ImageNet stem,
    224^2, B 256, 1000 classes, bf16, ``sgd(0.1, momentum=0.9)``,
    ``softmax_xent_loss_mutable``, one synthetic batch drawn once (its
    teacher is a 150528 x 1000 host product a batch) and reused."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute, ResNet50, SyntheticClassification, sgd,
        softmax_xent_loss_mutable)

    B, hw = 256, (224, 224)
    batch = SyntheticClassification(image_shape=(*hw, 3), num_classes=1000,
                                    batch_size=B).batch(0)
    model = ResNet50(num_classes=1000)
    ad = AutoDistribute(model, optimizer=sgd(0.1, momentum=0.9),
                        loss_fn=softmax_xent_loss_mutable, strategy="dp")
    state = ad.init(torch.Generator(device="cuda").manual_seed(0), batch)
    batch = ad.shard_batch(batch)  # on the card once
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_ms = _timed_steps(torch, ad, state, batch, steps)
    median = statistics.median(step_ms[1:])
    flops = model.cfg.train_step_flops(hw, B)
    means = [float(t.abs().sum()) for n, t in state.model_state.items()
             if n.endswith(".mean")]
    rec = {"cell": "resnet50-224", "batch": B, "image": list(hw),
           "step_ms": step_ms, "median_step_ms": median,
           "images_per_s": B / (median / 1e3),
           "train_step_flops": flops,
           "mfu": flops / (median / 1e3) / _MFU_PEAK,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "running_means_moved": sum(m > 0 for m in means),
           "batchnorms": len(means)}
    require(all(math.isfinite(x) for x in losses),
            f"resnet50-224: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"resnet50-224: loss did not fall {losses}")
    require(rec["running_means_moved"] == len(means),
            f"resnet50-224: {len(means) - rec['running_means_moved']} "
            f"running means never moved")
    del ad, state, model
    return rec


def _resnet_nccl(torch, *, steps=5) -> dict:
    """The CIFAR cell's step unwrapped and then under ``dp`` in a world of
    one NCCL rank (DDP at degree 1; BatchNorm sums its statistics over the
    data and fsdp groups, on NCCL): the losses and the running
    statistics (each buffer's largest error over its largest magnitude)
    within ``_RESNET_NCCL_BOUND``, and every running mean moved."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute, ResNet50, SyntheticClassification, sgd,
        softmax_xent_loss_mutable, topology)

    batch = SyntheticClassification(image_shape=(32, 32, 3), num_classes=10,
                                    batch_size=128).batch(0)

    def run():
        ad = AutoDistribute(ResNet50(num_classes=10, small_inputs=True),
                            optimizer=sgd(0.1, momentum=0.9),
                            loss_fn=softmax_xent_loss_mutable, strategy="dp")
        state = ad.init(torch.Generator(device="cuda").manual_seed(0), batch)
        state, losses, step_ms = _timed_steps(torch, ad, state, batch, steps)
        wrapped = ad._exec is not None and type(ad._exec.module).__name__
        groups = [len(m.stat_groups) for m in ad.model.modules()
                  if hasattr(m, "stat_groups")]
        return {"losses": losses, "median_step_ms":
                statistics.median(step_ms[1:]), "wrapper": wrapped,
                "stat_groups": sorted(set(groups)),
                "stats": {n: t.clone() for n, t in state.model_state.items()}}

    plain = run()
    pg_dir = tempfile.mkdtemp()
    topology.initialize_distributed(
        backend="nccl", init_method=f"file://{os.path.join(pg_dir, 'pg')}",
        world_size=1, rank=0)
    try:
        ddp = run()
    finally:
        dist.destroy_process_group()
    diff = max(abs(a - b) / abs(b) for a, b in zip(ddp["losses"],
                                                    plain["losses"]))
    stats_equal = all(torch.equal(ddp["stats"][n], t)
                      for n, t in plain["stats"].items())
    stats_diff = max(_max_err(ddp["stats"][n], t)
                     / max(float(t.abs().max()), 1e-30)
                     for n, t in plain["stats"].items())
    unmoved = [n for n, t in plain["stats"].items()
               if n.endswith(".mean") and not bool(t.abs().max() > 0)]
    rec = {"unwrapped_losses": plain["losses"], "ddp_losses": ddp["losses"],
           "max_rel_loss_diff": diff, "bound": _RESNET_NCCL_BOUND,
           "running_stats_bitwise": stats_equal,
           "max_rel_running_stats_diff": stats_diff,
           "wrapper": ddp["wrapper"],
           "stat_groups": ddp["stat_groups"],
           "unwrapped_median_step_ms": plain["median_step_ms"],
           "ddp_median_step_ms": ddp["median_step_ms"]}
    require(ddp["wrapper"] == "_DDP" and ddp["stat_groups"] == [2],
            f"the NCCL run was not DDP with statistics over two groups: "
            f"{ddp['wrapper']} {ddp['stat_groups']}")
    require(diff <= _RESNET_NCCL_BOUND,
            f"ResNet under DDP at degree 1: losses {ddp['losses']} vs "
            f"{plain['losses']} differ by {diff} > {_RESNET_NCCL_BOUND}")
    # the statistics the step commits: a DDP step that dropped
    # aux["model_state"] would leave them where init put them
    require(not unmoved, f"ResNet unwrapped: running means never moved: "
                         f"{unmoved[:3]}")
    require(stats_diff <= _RESNET_NCCL_BOUND,
            f"ResNet under DDP at degree 1: running statistics differ from "
            f"the unwrapped run's by {stats_diff} > {_RESNET_NCCL_BOUND}")
    return rec


def phase_resnet(torch, card) -> None:
    """ResNet-50 with BatchNorm on the card: the port's
    ``examples/train_resnet_cifar.py`` at its own config through
    ``Trainer.fit`` (CIFAR stem, 32^2, B 128, bf16, ``dp``, 20 steps on
    one batch), then ``bench.py``'s cell (224^2, B 256, 1000 classes),
    the card against the CPU in fp32, and the step under DDP in a world
    of one NCCL rank.  No flash kernel runs (JAX has no Pallas
    convolution); falling losses and moved running statistics."""
    from torch_automatic_distributed_neural_network_tpu_torch.data import \
        SyntheticClassification

    t0 = time.monotonic()
    data = _OneBatch(SyntheticClassification(
        image_shape=(32, 32, 3), num_classes=10, batch_size=128).batch(0))
    cifar, out = _zoo_run(torch, "resnet50-cifar", "train_resnet_cifar",
                          ["model.arch=resnet50", "run.batch_size=128"],
                          data, steps=20, items=128, keep=True)
    state = out["state"]
    means = [float(t.abs().sum()) for n, t in state.model_state.items()
             if n.endswith(".mean")]
    moved = sum(m > 0 for m in means)
    cifar["running_means_moved"] = moved
    cifar["batchnorms"] = len(means)
    cifar["mfu_989"] = (out["trainer"].ad.model.cfg.train_step_flops(
        (32, 32), 128) / (cifar["median_step_ms"] / 1e3) / _MFU_PEAK)
    del out, state
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "resnet", "card": card, **cifar})
    require(all(c == 0 for c in cifar["launches"].values()),
            f"ResNet launched flash kernels: {cifar['launches']}")
    require(moved == len(means) == 53,
            f"resnet50-cifar: {moved} of {len(means)} running means moved")
    bench = _resnet_bench_cell(torch)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "resnet", "card": card, **bench})
    gate = _resnet_card_vs_cpu(torch)
    emit({"phase": "resnet_card_vs_cpu", "card": card, **gate})
    require(gate["running_stats_rel_err"] <= _RESNET_CPU_BOUND
            and gate["eval_logits_rel_err"] <= _RESNET_CPU_BOUND,
            f"ResNet-50 on the card against the CPU: {gate}")
    nccl = _resnet_nccl(torch)
    torch.cuda.empty_cache()
    emit({"phase": "resnet_nccl", "card": card, **nccl,
          "seconds": time.monotonic() - t0})


# -- phase 22: the Llama FSDP example ------------------------------------------


LLAMA_FSDP_LAYERS = 16  # Llama 3.2 1B
# K1 a layer: the forward, the layer's own recompute (remat "dots") and
# the loss-level recompute the fsdp plan adds, nested as JAX nests its
# jax.checkpoint of the loss around the layers' remat; K2, K3 once
LLAMA_FSDP_PER_LAYER = {"flash_forward": 3, "flash_dkv": 1, "flash_dq": 1}


def _llama_fsdp_child(out_path: str, batch_size: int, steps: int) -> int:
    """One rank of ``python -m torch.distributed.run --nproc-per-node 1``:
    the port's ``examples/train_llama_fsdp.py`` at ``model.size=1b``,
    S 2048, on one batch, FSDP2 at degree 1 with remat; then one more step
    under ``torch.profiler`` for the GQA repeat's device time.  Writes a
    JSON record to ``out_path`` (``{"oom": true}`` when the batch does not
    fit)."""
    import os
    import tempfile

    import torch
    from torch_automatic_distributed_neural_network_tpu_torch.data import \
        SyntheticLM
    from torch_automatic_distributed_neural_network_tpu_torch.examples import \
        train_llama_fsdp
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = [getattr(fa, n) for n in _FLASH_NAMES]
    data = _OneBatch(SyntheticLM(vocab_size=128256, seq_len=2049,
                                 batch_size=batch_size).batch(0))
    path = os.path.join(tempfile.mkdtemp(), "metrics.jsonl")
    argv = ["model.size=1b", "model.seq_len=2048",
            f"run.batch_size={batch_size}", f"run.steps={steps}",
            "run.log_every=1", f"run.metrics_path={path}"]
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        out = train_llama_fsdp.main(argv, data=data)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        with open(out_path, "w") as f:
            json.dump({"oom": True, "batch_size": batch_size,
                       "error": str(e)[:300]}, f)
        return 3
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(path) as f:
        records = [r for r in map(json.loads, f) if "step_time_s" in r]
    ad, state = out["trainer"].ad, out["state"]
    batch = ad.shard_batch(data.batch(0))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = ad.step(state, batch)
        torch.cuda.synchronize()

    def device_ms(key):
        for e in prof.key_averages():
            if e.key == key:
                t = getattr(e, "device_time_total", None)
                if t is None:
                    t = e.cuda_time_total
                return t / 1e3
        return 0.0

    step_ms = [r["step_time_s"] * 1e3 for r in records]
    median = statistics.median(step_ms[1:])
    rec = {"batch_size": batch_size, "steps": steps, "step_ms": step_ms,
           "median_step_ms": median,
           "tokens_per_s": batch_size * 2048 / (median / 1e3),
           "mfu": statistics.median(r["mfu"] for r in records[1:]
                                    if "mfu" in r),
           "flops_per_step": records[-1].get("flops_per_step"),
           "peak_memory_gib": peak, "losses": [r["loss"] for r in records],
           "launches": launches, "strategy": ad.plan.strategy,
           "degrees": ad.plan.degrees, "remat": ad.plan.remat,
           "wrapped": type(ad.model).__name__,
           "params": ad.model.cfg.num_params(),
           "gqa_repeat_fwd_device_ms": device_ms("aten::repeat_interleave"),
           "expand_backward_device_ms": device_ms("ExpandBackward0"),
           "profiled_step": _device_time(prof, 1, 8)}
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def phase_llama_fsdp(card, *, steps=6) -> dict[str, int]:
    """The port's Llama FSDP example at ``model.size=1b`` (1.24B
    parameters, the Llama 3.2 1B geometry), S 2048, B 8 (halved while it
    does not fit), FSDP2 at degree 1 with remat, under ``python -m
    torch.distributed.run --nproc-per-node 1``: K1-K3 on every layer of a
    GQA training path (K and V repeated by ``_prep_bshd``), a falling
    loss; step ms, tokens/s, MFU, peak memory and the repeat's device ms
    from ``torch.profiler``."""
    import os
    import tempfile

    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="tadnn_llama_")
    out_path = os.path.join(tmp, "llama_fsdp.json")
    tried = []
    for batch_size in (8, 4, 2):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", os.path.abspath(__file__),
               "--llama-fsdp-child", out_path, "--llama-fsdp-batch",
               str(batch_size), "--llama-fsdp-steps", str(steps)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        rec = None
        if os.path.exists(out_path):
            with open(out_path) as f:
                rec = json.load(f)
            os.remove(out_path)
        tried.append({"batch_size": batch_size, "rc": proc.returncode,
                      "oom": bool(rec and rec.get("oom"))})
        if rec is None or not rec.get("oom"):
            break
    require(proc.returncode == 0 and rec is not None and not rec.get("oom"),
            f"llama_fsdp: rc {proc.returncode}, tried {tried}\n"
            f"{proc.stderr[-3000:]}")
    per_step = {n: c / steps for n, c in rec["launches"].items()}
    want = {n: LLAMA_FSDP_LAYERS * k for n, k in LLAMA_FSDP_PER_LAYER.items()}
    rec.update({"card": card, "tried": tried, "launches_per_step": per_step,
                "expected_launches_per_step": want,
                "seconds": time.monotonic() - t0})
    emit({"phase": "llama_fsdp", **rec})
    losses = rec["losses"]
    require(rec["strategy"] == "fsdp" and rec["remat"]
            and rec["wrapped"].startswith("FSDP"),
            f"llama_fsdp: plan {rec['strategy']} remat {rec['remat']}, "
            f"model {rec['wrapped']}")
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"llama_fsdp: losses {losses}")
    require(per_step == want, f"llama_fsdp: K1-K3 a step {per_step} != {want}")
    return rec["launches"]


# -- phase 23: MoE past expert degree 1 -----------------------------------

# MoE small's decode and expert-parallel cells: the serving request set of
# phase 5, generate's B 4 x (128 + 64), the zoo's B 8 x S 1024 training
MOE_SERVE = dict(n_requests=16, prompt_len=256, max_new=64, n_slots=8,
                 max_len=1024, block_size=16, prefill_chunk=32)
MOE_EP_STEPS = 5
MOE_EP_RUNS = ("ep", "ep_fsdp", "ep_tp")
# MoE's routing turns a small difference into a different function where
# two expert probabilities are within it: a flipped choice moves that
# token's logits by ~0.1, where a dense model's move by the difference
# alone (seen on the CPU at the test preset, top-2 against every expert
# active).  So the token gates compare like with like (phase 5's paged vs
# dense engine; the one-slot engine vs generate in bf16), and routed vs
# dense is held row by row on the same tokens: the share of positions
# whose logits agree within MOE_ROW_BOUND of their largest magnitude
MOE_ROW_BOUND = 1e-3
MOE_ROW_SHARE = 0.99
# requests of MOE_SERVE's set that the one-slot engine decodes against
# generate, like with like
MOE_ALONE = 4


def _tf_logits(torch, model, prompt, rows, *, moe_decode, cache_dtype):
    """The logits at every generated position of each row, teacher-forced:
    ``forward_cached`` over the prompt and the row's own tokens in one
    pass (B rows together, ``moe_decode``): [B, N, V]."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .decode import KVCache, forward_cached

    P = prompt.shape[1]
    toks = torch.cat([prompt, torch.tensor(rows, device=prompt.device)[
        :, :-1]], dim=1)
    cache = KVCache.init(model.cfg, toks.shape[0], toks.shape[1],
                         dtype=cache_dtype, device=prompt.device)
    return forward_cached(model, toks, cache, moe_decode=moe_decode,
                          all_logits=True)[0][:, P - 1:]


def _moe_small(torch, dtype, *, seed=11, **kw):
    from torch_automatic_distributed_neural_network_tpu_torch import MoE

    with torch.device("cuda"):
        m = MoE("small", max_seq_len=1024, dtype=dtype,
                **{"n_layers": CUT_LAYERS, **kw})
    return m.init_weights(torch.Generator(device="cuda").manual_seed(seed))


def _moe_serve(torch, card) -> tuple[dict, int]:
    """(a) ``ServeEngine(moe_decode="dense")`` on MoE small, fp32 compute
    and bf16 KV as phase 5's cell, 16 requests of 256 + 64 on 8 slots,
    K4 once a layer a decode step; phase 5's gates: its tokens equal to
    the dense engine's and one decode step's logits within 1e-3 of the
    dense path's on one pool state; the agreement of the first 8
    requests with a one-request-at-a-time ``generate(moe_decode=
    "dense")`` reported beside them, with the logit gap and the router's
    margins at each row's first divergence (not alike: ``generate``'s
    bf16 cache rounds the attention probabilities to bf16 where the fp32
    engine keeps them fp32, its cache is P + N long and its prefill one
    chunk, and a flipped expert choice moves a token, see
    ``MOE_ROW_BOUND``); tokens/s, p99, the mean decode-step ms; then a
    decode step's device time and launches (``phase_profile``); then
    the gate against ``generate`` like with like
    (:func:`_moe_engine_vs_generate`)."""
    import numpy as np

    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .decode import generate
    from torch_automatic_distributed_neural_network_tpu_torch.obs.journal \
        import Journal
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention

    cfgs = dict(MOE_SERVE)
    n, P, N = (cfgs.pop(k) for k in ("n_requests", "prompt_len", "max_new"))
    m32 = _moe_small(torch, torch.float32)
    rs = np.random.RandomState(0)
    prompts = [[int(t) for t in rs.randint(1, m32.cfg.vocab_size, size=(P,))]
               for _ in range(n)]
    kw = dict(cfgs, moe_decode="dense")
    _serve(torch, m32, prompts[:1], max_new=2, impl="paged", journal=None,
           **kw)  # warm-up
    jnl = Journal(None, host0_only=False, validate=True,
                  meta={"tool": "chip_smoke"})
    paged_attention.launches = 0
    eng, reqs, done, wall = _serve(torch, m32, prompts, max_new=N,
                                   impl="paged", journal=jnl, **kw)
    launches = paged_attention.launches
    steps = [r for r in jnl.records if r.get("name") == "serve.step"]
    decode_ms = [1e3 * r["decode_s"] for r in steps if r["decode_s"] > 0]
    totals = [(r.t_done or 0.0) - r.t_submit for r in done]
    got = [r.out_tokens for r in reqs]
    _, dense_reqs, _, _ = _serve(torch, m32, prompts, max_new=N,
                                 impl="dense", journal=None, **kw)
    vs_dense = _agreement(got, [r.out_tokens for r in dense_reqs])
    tf_err = _teacher_forced(torch, m32, prompts[:MOE_SERVE["n_slots"]],
                             **kw)
    # the reported reference: the first wave's requests, one at a time
    alone = prompts[:MOE_SERVE["n_slots"]]
    t0 = time.monotonic()
    want = [generate(m32, torch.tensor([p], device="cuda"),
                     max_new_tokens=N, moe_decode="dense")[0, P:].tolist()
            for p in alone]
    ref_s = time.monotonic() - t0
    agree = _agreement(got[:len(alone)], want)
    rec = {"phase": "moe_serve", "card": card, "model": "moe-small",
           "compute": "fp32", "kv": "bf16", "moe_decode": eng.moe_decode,
           **MOE_SERVE, "finished": len(done),
           "new_tokens": sum(r.n_generated for r in done), "wall_s": wall,
           "tokens_per_s": sum(r.n_generated for r in done) / wall,
           "p50_latency_s": _pct(totals, 0.50),
           "p99_latency_s": _pct(totals, 0.99),
           "decode_steps": len(decode_ms),
           "mean_decode_step_ms": statistics.fmean(decode_ms),
           "paged_kernel_launches": launches,
           "launches_per_decode_step": launches / max(len(decode_ms), 1),
           "agreement_vs_dense_engine": vs_dense,
           "teacher_forced_max_abs_logit_diff": tf_err,
           "agreement_vs_generate_alone": agree,
           "generate_alone_seconds": ref_s,
           "divergences": _divergences(torch, m32, alone, got, want)
           if agree < 1.0 else []}
    emit(rec)
    require(len(done) == n and all(r.n_generated == N for r in reqs),
            f"moe serve: {len(done)}/{n} requests finished")
    require(launches == m32.cfg.n_layers * len(decode_ms),
            f"moe serve: {launches} K4 launches over {len(decode_ms)} decode "
            f"steps of {m32.cfg.n_layers} layers")
    require(vs_dense == 1.0, f"moe serve: paged tokens agree with the "
                             f"dense engine's on only {vs_dense:.4f}")
    require(tf_err <= 1e-3,
            f"moe serve: paged vs dense logits differ by {tf_err} > 1e-3")
    phase_profile(torch, name="moe-small", model=m32, n_slots=8,
                  prompt_len=P, max_len=1024, block_size=16, seed=2)
    del m32, eng
    torch.cuda.empty_cache()
    _moe_engine_vs_generate(torch, card, prompts[:MOE_ALONE], max_new=N)
    return rec, launches


def _moe_engine_vs_generate(torch, card, prompts, *, max_new) -> None:
    """The engine's MoE decode against ``generate(moe_decode="dense")``,
    like with like as phase ``generate`` holds GPT-2: bf16 weights, each
    prompt alone (``generate`` at B 1) through an engine of one slot
    whose one prefill chunk is the prompt and whose cache is as long as
    ``generate``'s, so every product has the same shape on both sides;
    the dense engine's tokens must equal ``generate``'s.  In fp32 the two
    are not alike: ``generate``'s bf16 cache rounds the attention
    probabilities to bf16 and the dense engine, which reads its pool at
    the model's type, keeps them fp32.  The paged engine (K4 keeps the
    probabilities fp32) is reported beside it, with the logit gap and
    the router's margins at each row's first divergence."""
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .decode import generate

    P, N = len(prompts[0]), max_new
    m16 = _moe_small(torch, torch.bfloat16).to(torch.bfloat16)
    want = [generate(m16, torch.tensor([p], device="cuda"),
                     max_new_tokens=N, moe_decode="dense")[0, P:].tolist()
            for p in prompts]
    agree, diverged = {}, {}
    for impl in ("dense", "paged"):
        got = _engine_tokens(torch, m16, prompts, max_new=N, n_slots=1,
                             max_len=P + N, block_size=16, prefill_chunk=P,
                             attention_impl=impl, moe_decode="dense")
        agree[impl] = _agreement(want, got)
        diverged[impl] = _divergences(torch, m16, prompts, want, got)
    emit({"phase": "moe_serve_vs_generate", "card": card,
          "model": "moe-small", "compute": "bf16", "kv": "bf16",
          "requests": len(prompts), "prompt_len": P, "max_new": N,
          "agreement": agree, "divergences": diverged})
    del m16
    torch.cuda.empty_cache()
    require(agree["dense"] == 1.0,
            f"moe serve: one-slot dense engine tokens agree with "
            f"generate's on only {agree['dense']:.4f} (first divergences: "
            f"{diverged['dense']})")


def _moe_generate(torch, card) -> dict:
    """(b) ``AutoDistribute.generate`` at B 4 x (128 + 64), bf16 weights:
    tokens/s of ``moe_decode`` dense and routed and of ``quant="int8"``
    (the banks and the router left in full precision); routed against
    dense at capacity factor 8 (nothing drops) in fp32, as JAX's
    ``tests/test_generate.py`` holds them: on the dense run's tokens,
    teacher-forced, at least ``MOE_ROW_SHARE`` of the positions' logits
    within ``MOE_ROW_BOUND`` of their largest magnitude, and the
    free-running token agreement reported."""
    import numpy as np

    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute, MoE, moe_next_token_loss)
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .decode import generate
    from torch_automatic_distributed_neural_network_tpu_torch.inference \
        .quant import QuantizedWeight, quantize_for_decode

    B, P, N = 4, 128, 64
    rs = np.random.RandomState(3)
    prompt = torch.from_numpy(rs.randint(1, 32000, size=(B, P))).cuda()
    m16 = _moe_small(torch, torch.bfloat16).to(torch.bfloat16)
    ad = AutoDistribute(m16, loss_fn=moe_next_token_loss, precision="bf16",
                        device="cuda")
    state = ad.init(None)
    modes = {
        "dense": lambda: ad.generate(state, prompt, max_new_tokens=N),
        "routed": lambda: ad.generate(state, prompt, max_new_tokens=N,
                                      moe_decode="routed"),
        "int8": lambda: ad.generate(state, prompt, max_new_tokens=N,
                                    quant="int8")}
    secs = {name: [] for name in modes}
    toks = {}
    for fn in modes.values():
        fn()  # warm-up
    for _ in range(2):
        for name, fn in modes.items():
            out, sec = _timed(torch, fn)
            secs[name].append(sec)
            toks[name] = out[:, P:].tolist()
    q = quantize_for_decode(m16)
    whole = all(
        isinstance(getattr(layer.mlp, b), torch.nn.Parameter)
        for layer in q.layers for b in ("experts_up", "experts_gate",
                                        "experts_down")) and not any(
        isinstance(layer.mlp.router.weight, QuantizedWeight)
        for layer in q.layers)
    quantized = isinstance(q.layers[0].attn.q_proj.weight, QuantizedWeight)
    del ad, state, q, m16
    torch.cuda.empty_cache()
    m32 = _moe_small(torch, torch.float32)
    with torch.device("meta"):
        m8 = MoE("small", max_seq_len=1024, dtype=torch.float32,
                 capacity_factor=8.0, n_layers=CUT_LAYERS)
    m8.load_state_dict(m32.state_dict(), assign=True)
    fp32 = {mode: generate(m8, prompt, max_new_tokens=N, moe_decode=mode,
                           cache_dtype=torch.float32)[:, P:].tolist()
            for mode in ("dense", "routed")}
    tf = {mode: _tf_logits(torch, m8, prompt, fp32["dense"],
                           moe_decode=mode, cache_dtype=torch.float32)
          for mode in ("dense", "routed")}
    scale = float(tf["dense"].abs().max())
    row_err = (tf["routed"] - tf["dense"]).abs().amax(-1)  # [B, N]
    row_share = float((row_err <= MOE_ROW_BOUND * scale).float().mean())
    del tf
    rec = {"phase": "moe_generate", "card": card, "model": "moe-small",
           "batch": B, "prompt_len": P, "max_new": N,
           **{f"{k}_tokens_per_s": B * N / statistics.median(v)
              for k, v in secs.items()},
           **{f"{k}_seconds": v for k, v in secs.items()},
           "routed_vs_dense_bf16_agreement": _agreement(toks["dense"],
                                                        toks["routed"]),
           "int8_vs_bf16_agreement": _agreement(toks["dense"], toks["int8"]),
           "fp32_capacity_factor_8_routed_vs_dense_agreement": _agreement(
               fp32["dense"], fp32["routed"]),
           "fp32_routed_vs_dense_rows_within_bound": row_share,
           "fp32_routed_vs_dense_max_row_err": float(row_err.max()),
           "fp32_logit_scale": scale,
           "row_bound": MOE_ROW_BOUND, "row_share_bound": MOE_ROW_SHARE,
           "int8_banks_and_router_whole": whole,
           "int8_attention_quantized": quantized}
    emit(rec)
    del m8, m32
    torch.cuda.empty_cache()
    require(row_share >= MOE_ROW_SHARE,
            f"moe generate: routed logits within {MOE_ROW_BOUND} of the "
            f"scale of the dense path's at only {row_share:.4f} of the "
            f"positions (capacity factor 8, fp32)")
    require(whole and quantized, "moe generate: int8 quantized the expert "
                                 "banks or the router, or nothing")
    require(all(0 <= t < 32000 for rows in toks.values() for row in rows
                for t in row), "moe generate: token id out of range")
    return rec


def _moe_expert_parallel(torch, card) -> tuple[dict, dict]:
    """(c) ``AutoDistribute(MoE small, strategy=...)`` at B 8 x S 1024
    (bf16 compute, fp32 params, adamw(3e-4)), 5 steps on one batch from
    the same seeded weights: unwrapped, then ``ep``, ``ep_fsdp`` and
    ``ep_tp`` in a world of one NCCL rank (the banks ``DTensor`` objects,
    every dispatch exchanged by NCCL's all-to-all over a group of one):
    losses bitwise the unwrapped ones; step ms, peak memory, the
    exchange's launches and K1-K3's a step; (d) the first step's dropped
    fraction, per layer, over the batch and on row 0 alone."""
    import os
    import tempfile

    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute, SyntheticLM, adamw, moe_next_token_loss, topology)
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa
    from torch_automatic_distributed_neural_network_tpu_torch.parallel \
        .expert import exchange

    wrappers = [getattr(fa, n) for n in _FLASH_NAMES]
    batch = SyntheticLM(vocab_size=32000, seq_len=1025,
                        batch_size=8).batch(0)
    total = dict.fromkeys(_FLASH_NAMES, 0)

    def run(strategy):
        from torch_automatic_distributed_neural_network_tpu_torch import MoE

        ad = AutoDistribute(MoE("small", max_seq_len=1024,
                                n_layers=CUT_LAYERS),
                            optimizer=adamw(3e-4),
                            loss_fn=moe_next_token_loss, strategy=strategy,
                            device="cuda")
        state = ad.init(torch.Generator(device="cuda").manual_seed(0),
                        batch)
        rec = {"strategy": ad.plan.strategy, "degrees": {
            a: d for a, d in ad.plan.degrees.items() if d > 1},
            "layers": ad.model.cfg.n_layers,
            "remat": ad.plan.remat, "layer_remat": ad.model.cfg.remat,
            "world_size": dist.get_world_size() if dist.is_initialized()
            else 1}
        if strategy == "auto":
            # row 0 alone, before any step: the CPU probe's figure
            with torch.no_grad():
                ad.model(torch.as_tensor(batch["input_ids"][:1, :-1],
                                         device="cuda"))
            rec["row0_dropped_fraction"] = [
                float(layer.mlp.metrics["dropped_fraction"])
                for layer in ad.model.layers]
        for w in wrappers:
            w.launches = 0
        exchange.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, first = [], [], None
        for i in range(MOE_EP_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = ad.step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            if i == 0:
                first = [float(layer.mlp.metrics["dropped_fraction"])
                         for layer in ad.model.layers]
        launches = {w.__name__: w.launches for w in wrappers}
        for k, v in launches.items():
            total[k] += v
        rec.update(
            losses=losses, step_ms=step_ms,
            median_step_ms=statistics.median(step_ms[1:]),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            exchanges_per_step=exchange.launches / MOE_EP_STEPS,
            launches_per_step={k: v / MOE_EP_STEPS
                               for k, v in launches.items()},
            first_step_dropped_fraction=statistics.fmean(first),
            first_step_dropped_per_layer=first)
        del ad, state
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    runs = {"unwrapped": run("auto")}
    pg_dir = tempfile.mkdtemp()
    topology.initialize_distributed(
        backend="nccl", init_method=f"file://{os.path.join(pg_dir, 'pg')}",
        world_size=1, rank=0)
    try:
        for strategy in MOE_EP_RUNS:
            runs[strategy] = run(strategy)
    finally:
        dist.destroy_process_group()
    base = runs["unwrapped"]
    for label, rec in runs.items():
        layers = rec["layers"]
        rec["bitwise_vs_unwrapped"] = rec["losses"] == base["losses"]
        rec["max_rel_loss_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                base["losses"]))
        remats = 1 + rec["layer_remat"] + rec["remat"]
        rec["expected_exchanges_per_step"] = (
            0 if label == "unwrapped" else layers * (2 * remats + 2))
        rec["expected_launches_per_step"] = {
            "flash_forward": layers * remats, "flash_dkv": layers,
            "flash_dq": layers}
        emit({"phase": "moe_ep", "run": label, "card": card, **rec,
              "unwrapped_median_step_ms": base["median_step_ms"]})
    for label, rec in runs.items():
        require(all(math.isfinite(x) for x in rec["losses"])
                and rec["losses"][-1] < rec["losses"][0],
                f"moe {label}: losses {rec['losses']}")
        require(rec["bitwise_vs_unwrapped"],
                f"moe {label}: losses {rec['losses']} are not the unwrapped "
                f"{base['losses']} bitwise")
        require(rec["exchanges_per_step"]
                == rec["expected_exchanges_per_step"],
                f"moe {label}: {rec['exchanges_per_step']} exchanges a step, "
                f"expected {rec['expected_exchanges_per_step']}")
        require(rec["launches_per_step"] == rec["expected_launches_per_step"],
                f"moe {label}: K1-K3 a step {rec['launches_per_step']}")
        if label != "unwrapped":
            require(rec["strategy"] == label and not rec["degrees"],
                    f"moe {label}: plan {rec['strategy']} {rec['degrees']}")
    return runs, total


def phase_moe(torch, card) -> tuple[int, dict[str, int]]:
    """MoE small past expert degree 1: (a) serving, (b) ``generate``,
    (c) expert parallelism on one NCCL rank, (d) the first step's drop
    rate.  Returns K4's launches in (a) and K1-K3's in (c)."""
    t0 = time.monotonic()
    serve, k4 = _moe_serve(torch, card)
    gen = _moe_generate(torch, card)
    runs, flash = _moe_expert_parallel(torch, card)
    emit({"phase": "moe_done", "card": card,
          "serve_tokens_per_s": serve["tokens_per_s"],
          "serve_p99_latency_s": serve["p99_latency_s"],
          "generate_tokens_per_s": {k: gen[f"{k}_tokens_per_s"] for k in (
              "dense", "routed", "int8")},
          "ep_median_step_ms": {k: r["median_step_ms"]
                                for k, r in runs.items()},
          "first_step_dropped_fraction": runs["unwrapped"][
              "first_step_dropped_fraction"],
          "row0_dropped_fraction_mean": statistics.fmean(
              runs["unwrapped"]["row0_dropped_fraction"]),
          "k4_launches": k4, "flash_launches": flash,
          "seconds": time.monotonic() - t0})
    return k4, flash


# -- phase 24: pipeline and context parallelism ---------------------------

# GPT-2 small (12 layers, d 768, 12 heads, vocab 50257, S 1024, bf16
# compute, fp32 parameters, remat "dots") at B 8 on one batch, as phase
# train; two processes share the one card over a gloo group (NCCL refuses
# two ranks on one device), so the sends, rotations and all-to-alls go
# through host buffers, counted
PIPE_CP_STEPS = 5
PIPE_CP_SEED = 0
PIPE_CP_MICROBATCHES = 4
PIPE_CP_RUNS = (
    ("cond", dict(pipeline_stages=2, microbatches=PIPE_CP_MICROBATCHES)),
    ("1f1b", dict(pipeline_stages=2, microbatches=PIPE_CP_MICROBATCHES,
                  pipeline_schedule="1f1b")),
    ("interleaved_1f1b", dict(pipeline_stages=2,
                              microbatches=PIPE_CP_MICROBATCHES,
                              pipeline_schedule="interleaved_1f1b",
                              pipeline_virtual=2)),
    ("ring", dict(seq_parallel=2, seq_impl="ring")),
    ("ulysses", dict(seq_parallel=2, seq_impl="ulysses")),
)
# every step's loss against the unsharded step's on the same weights and
# batch: bf16 compute whose sums the microbatches and the ring's blocks
# reorder, over 5 Adam steps; the loss falls by 0.26 to 1.0 a step here
# (phase train), so a stage or a slice that trained wrongly moves it by
# more than this
PIPE_CP_LOSS_BOUND = 5e-2
# the ring op alone, bf16, against flash on the whole sequence and
# against fp32 plain attention: the share of each output's largest
# magnitude (phase zoo's bound for K1-K3 in bf16)
RING_OP_BOUND = 2e-2
RING_OP_SHAPE = (8, 1024, 12, 64)


def _pipe_cp_expected(name: str, rank: int, layers: int = 12) -> dict:
    """K1-K3 launches a step on ``rank``.  A pipeline stage runs L/2
    layers on M microbatches; remat "dots" recomputes each layer's
    attention, so a forward with gradients is 2 K1 a layer.  cond: the
    forward and its recompute.  1F1B: a forward without gradients (1), the
    backward's forward wavefront (1, skipped for a chunk that ends the
    chain: the last stage's, or its last virtual stage's), and each chunk
    recomputed with gradients (2).  Ring: rank r attends r + 1 blocks
    (its own causally, the earlier ones whole), each K1 forward and
    recompute, K2 and K3 once.  Ulysses: none (its inner attention is
    ``xla_attention``, as in JAX)."""
    half, m = layers // 2, PIPE_CP_MICROBATCHES
    if name == "cond":
        return {"flash_forward": 2 * half * m, "flash_dkv": half * m,
                "flash_dq": half * m}
    if name in ("1f1b", "interleaved_1f1b"):
        v = 2 if name == "interleaved_1f1b" else 1
        not_last = v if rank == 0 else v - 1  # chunks that send onward
        wave = half // v * m * not_last
        return {"flash_forward": half * m * 3 + wave,
                "flash_dkv": half * m, "flash_dq": half * m}
    if name == "ring":
        blocks = rank + 1
        return {"flash_forward": 2 * layers * blocks,
                "flash_dkv": layers * blocks, "flash_dq": layers * blocks}
    return {"flash_forward": 0, "flash_dkv": 0, "flash_dq": 0}


def _pipe_cp_child(out_path: str, rank: int, init_file: str) -> int:
    """One of the two processes of phase ``pipeline_cp``: every run of
    ``PIPE_CP_RUNS`` through ``AutoDistribute`` on ``cuda:0`` in a gloo
    group of 2, then the ring op alone; writes a JSON record."""
    import torch
    import torch.distributed as dist
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2, AutoDistribute, SyntheticLM, adamw, next_token_loss, topology)
    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa
    from torch_automatic_distributed_neural_network_tpu_torch.parallel import \
        collectives
    from torch_automatic_distributed_neural_network_tpu_torch.parallel.ring \
        import ring_attention

    torch.cuda.set_device(0)
    topology.initialize_distributed(
        backend="gloo", init_method=f"file://{init_file}", world_size=2,
        rank=rank)
    wrappers = [getattr(fa, n) for n in _FLASH_NAMES]
    batch = SyntheticLM(vocab_size=50257, seq_len=1025,
                        batch_size=8).batch(0)
    out = {"rank": rank, "runs": {}}
    for name, kw in PIPE_CP_RUNS:
        ad = AutoDistribute(GPT2("small"), optimizer=adamw(1e-3),
                            loss_fn=next_token_loss, device="cuda:0", **kw)
        state = ad.init(torch.Generator(device="cuda").manual_seed(
            PIPE_CP_SEED), batch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers:
            w.launches = 0
        collectives.reset_traffic()
        losses, step_ms = [], []
        for _ in range(PIPE_CP_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, metrics = ad.step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        out["runs"][name] = {
            "losses": losses, "step_ms": step_ms,
            "median_step_ms": statistics.median(step_ms[1:]),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {w.__name__: w.launches for w in wrappers},
            "launches_per_step": {w.__name__: w.launches / PIPE_CP_STEPS
                                  for w in wrappers},
            "bytes_per_step": {k: v / PIPE_CP_STEPS
                               for k, v in collectives.traffic.items()},
            "degrees": ad.plan.degrees, "remat": ad.plan.remat,
            "held_layers": sorted({int(n.split(".")[1]) for n, p in
                                   ad.model.named_parameters()
                                   if n.startswith("layers.")
                                   and not p.is_meta})}
        del ad, state
        torch.cuda.empty_cache()
    # the ring op alone: each rank its half of the sequence
    mesh = topology.build_mesh(seq=2, device_type="cuda")
    group = mesh.get_group("seq")
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(RING_OP_SHAPE, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    width = RING_OP_SHAPE[1] // 2
    part = slice(rank * width, (rank + 1) * width)
    ms = []
    for _ in range(4):
        ql, kl, vl = (t[:, part].clone().requires_grad_() for t in (q, k, v))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        o = ring_attention(ql, kl, vl, causal=True, group=group)
        o.backward(do[:, part])
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    mine = [t.detach().cpu() for t in (o, ql.grad, kl.grad, vl.grad)]
    both = [None, None]
    dist.all_gather_object(both, mine)
    if rank == 0:
        got = [torch.cat(parts, dim=1) for parts in zip(*both)]
        from torch_automatic_distributed_neural_network_tpu_torch.ops \
            .attention import xla_attention

        refs = {}
        for ref, fn, dtype in (
                ("flash", fa.flash_attention, torch.bfloat16),
                ("plain", xla_attention, torch.float32)):
            qr, kr, vr = (t.detach().to(dtype).clone().requires_grad_()
                          for t in (q, k, v))
            o_ref = fn(qr, kr, vr, causal=True)
            o_ref.backward(do.to(dtype))
            refs[ref] = {label: max(
                float((a.float() - b.detach().float().cpu()).abs().max())
                / float(b.detach().float().abs().max()), 0.0)
                for label, a, b in zip(("o", "dq", "dk", "dv"), got,
                                       (o_ref, qr.grad, kr.grad, vr.grad))}
        out["ring_op"] = {"shape": list(RING_OP_SHAPE),
                          "ms_fwd_bwd": ms[1:], "errors": refs,
                          "bound": RING_OP_BOUND}
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def phase_pipeline_cp(torch, card) -> dict[str, int]:
    """Pipeline and context parallelism at GPT-2 small (B 8 x S 1024,
    bf16 compute, 5 steps on one batch): the unsharded step in this
    process, then two processes on the card in a gloo group running pipe
    2 under cond, 1f1b and interleaved_1f1b (V 2, microbatches 4) and
    seq 2 under ring and Ulysses, each against the unsharded losses; K1-K3
    launches a step per rank, step ms, peak memory and the bytes each
    rank sends; then ring attention alone on [8, 1024, 12, 64] bf16
    against flash on the whole sequence and the plain fp32 attention.
    Returns the main path's K1-K3 launches, both ranks summed."""
    import os
    import tempfile

    from torch_automatic_distributed_neural_network_tpu_torch import \
        SyntheticLM

    t0 = time.monotonic()
    ad, state = _train_setup(torch, seed=PIPE_CP_SEED)
    batch = SyntheticLM(vocab_size=50257, seq_len=1025, batch_size=8).batch(0)
    ref, ref_ms = [], []
    for _ in range(PIPE_CP_STEPS):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        state, metrics = ad.step(state, batch)
        torch.cuda.synchronize()
        ref_ms.append((time.monotonic() - t1) * 1e3)
        ref.append(float(metrics["loss"]))
    del ad, state
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="tadnn_pipe_cp_")
    paths = [os.path.join(tmp, f"rank{r}.json") for r in (0, 1)]
    # two processes on the host's cores: no oversubscription
    env = {**os.environ, "OMP_NUM_THREADS": "4"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pipe-cp-child",
         paths[r], "--pipe-cp-rank", str(r), "--pipe-cp-init",
         os.path.join(tmp, "pg")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in (0, 1)]
    errs = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode:
                errs.append(f"rank {r}: rc {proc.returncode}\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    require(not errs, "pipeline_cp: a child failed\n" + "\n".join(errs))
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    launches = {n: 0 for n in _FLASH_NAMES}
    runs = {}
    for name, _ in PIPE_CP_RUNS:
        per_rank = [rk["runs"][name] for rk in ranks]
        diffs = [max(abs(a - b) for a, b in zip(r["losses"], ref))
                 for r in per_rank]
        expected = [_pipe_cp_expected(name, r) for r in (0, 1)]
        runs[name] = {"per_rank": per_rank, "max_loss_diff": max(diffs),
                      "expected_launches_per_step": expected}
        for r, rec in enumerate(per_rank):
            require(all(math.isfinite(x) for x in rec["losses"]),
                    f"pipeline_cp {name}: rank {r} losses {rec['losses']}")
            require(rec["launches_per_step"] == {
                n: float(c) for n, c in expected[r].items()},
                f"pipeline_cp {name}: rank {r} K1-K3 a step "
                f"{rec['launches_per_step']} != {expected[r]}")
            for n in _FLASH_NAMES:
                launches[n] += rec["launches"][n]
        require(max(diffs) <= PIPE_CP_LOSS_BOUND,
                f"pipeline_cp {name}: losses {per_rank[0]['losses']} vs "
                f"unsharded {ref}: {max(diffs)} > {PIPE_CP_LOSS_BOUND}")
    for r in (0, 1):
        cond = runs["cond"]["per_rank"][r]["peak_memory_gib"]
        ofob = runs["1f1b"]["per_rank"][r]["peak_memory_gib"]
        require(ofob < cond, f"pipeline_cp: rank {r} 1f1b peak {ofob} GiB "
                             f"not below cond's {cond} GiB")
        require(runs["cond"]["per_rank"][r]["held_layers"] == list(
            range(6 * r, 6 * r + 6)), f"pipeline_cp: rank {r} holds "
            f"{runs['cond']['per_rank'][r]['held_layers']}")
    ring_op = ranks[0]["ring_op"]
    for ref_name, errs_ in ring_op["errors"].items():
        for label, e in errs_.items():
            require(e <= RING_OP_BOUND,
                    f"ring op vs {ref_name}: {label} off by {e} of its "
                    f"largest magnitude > {RING_OP_BOUND}")
    for n in _FLASH_NAMES:
        require(launches[n] > 0, f"pipeline_cp: {n} never launched")
    from torch_automatic_distributed_neural_network_tpu_torch.parallel.pipeline \
        import bubble_fraction

    emit({"phase": "pipeline_cp", "card": card,
          "model": "gpt2-small B 8 x S 1024 bf16, 5 steps on one batch",
          "unsharded": {"losses": ref, "step_ms": ref_ms,
                        "median_step_ms": statistics.median(ref_ms[1:])},
          "loss_bound": PIPE_CP_LOSS_BOUND,
          "bubble_fraction": {
              "cond": bubble_fraction(2, PIPE_CP_MICROBATCHES),
              "interleaved_1f1b": bubble_fraction(
                  2, 2 * PIPE_CP_MICROBATCHES)},
          "runs": runs, "ring_op": ring_op, "launches": launches,
          "seconds": time.monotonic() - t0})
    return launches



def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone: "
                         + ", ".join(PHASES) + " (prints no result)")
    # phase llama_fsdp's rank, started under torch.distributed.run
    ap.add_argument("--llama-fsdp-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--llama-fsdp-batch", type=int, default=8,
                    help=argparse.SUPPRESS)
    ap.add_argument("--llama-fsdp-steps", type=int, default=6,
                    help=argparse.SUPPRESS)
    # phase pipeline_cp's two processes
    ap.add_argument("--pipe-cp-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pipe-cp-rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--pipe-cp-init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = None if args.phases is None else set(args.phases.split(","))
    if only is not None and not only <= set(PHASES):
        print(f"chip_smoke: unknown phases {sorted(only - set(PHASES))}",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    try:
        import torch_automatic_distributed_neural_network_tpu_torch  # noqa
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    if args.llama_fsdp_child:
        return _llama_fsdp_child(args.llama_fsdp_child, args.llama_fsdp_batch,
                                 args.llama_fsdp_steps)
    if args.pipe_cp_child:
        return _pipe_cp_child(args.pipe_cp_child, args.pipe_cp_rank,
                              args.pipe_cp_init)
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        gpt2_config, llama_config)
    from torch_automatic_distributed_neural_network_tpu_torch.models \
        .transformer_core import DecoderLM

    # fp32 parity checks: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    starts: dict[str, float] = {}  # each phase's first start, for the record

    def run(name) -> bool:
        if only is None or name in only:
            starts.setdefault(name, time.monotonic() - t_start)
            return True
        return False

    card = phase_environment(torch)
    if run("build"):
        phase_build()
    if run("kernel_cases"):
        phase_kernel_cases(torch)
    if run("timing"):
        timing = phase_timing(torch)
    if run("tile_check"):
        phase_tile_check(torch)
    if run("flash_kernel_cases"):
        phase_flash_kernel_cases(torch)
        phase_flash_determinism(torch)
        phase_flash_autograd(torch)
    if run("flash_timing"):
        flash, flash_bert = phase_flash_timing(torch)

    def model_of(cfg, seed):
        with torch.device("cuda"):
            m = DecoderLM(cfg)
        return m.init_weights(torch.Generator(device="cuda").manual_seed(seed))

    if run("serve"):
        gpt2 = model_of(gpt2_config("small", max_seq_len=1024,
                                    dtype=torch.float32), 1)
        paged_launches, decode_steps = phase_serve(
            torch, name="gpt2-small", model=gpt2, n_requests=16,
            prompt_len=256, max_new=64, n_slots=8, max_len=1024,
            block_size=16, quant_kv=False, seed=0)
        paged_launches_per_step = paged_launches / decode_steps
        phase_profile(torch, name="gpt2-small", model=gpt2, n_slots=8,
                      prompt_len=256, max_len=1024, block_size=16, seed=2)
        del gpt2
        llama = model_of(llama_config("1b", n_layers=2, dtype=torch.float32),
                         2)
        phase_serve(
            torch, name="llama-1b-2layer-int8", model=llama, n_requests=4,
            prompt_len=128, max_new=32, n_slots=4, max_len=512,
            block_size=16, quant_kv=True, seed=1)
        del llama
        torch.cuda.empty_cache()
    if run("train") or run("dist_plan") or run("sharded_trainer"):
        from torch_automatic_distributed_neural_network_tpu_torch import \
            SyntheticLM

        data = SyntheticLM(vocab_size=50257, seq_len=1025, batch_size=8)
    if run("train"):
        train_launches = phase_train(torch, data)
        phase_train_parity(torch, data)
        phase_train_profile(torch, data)
        torch.cuda.empty_cache()
    if run("dist_plan"):
        dist_launches = phase_dist_plan(torch, data, card)
        torch.cuda.empty_cache()
    if run("trainer"):
        phase_trainer(torch)
    if run("launch"):
        phase_launch(card)
    if run("sharded_trainer"):
        sharded_launches = phase_sharded_trainer(torch, data, card)
        torch.cuda.empty_cache()
    if run("train") or run("dist_plan") or run("sharded_trainer"):
        del data
    if run("generate"):
        phase_generate(torch)
        torch.cuda.empty_cache()
    if run("serve_prefix") or run("serve_spec"):
        gpt2 = model_of(gpt2_config("small", max_seq_len=1024,
                                    dtype=torch.float32), 1)
        if run("serve_prefix"):
            prefix = phase_serve_prefix(torch, gpt2)
        if run("serve_spec"):
            phase_serve_spec(torch, gpt2)
        del gpt2
        torch.cuda.empty_cache()
    if run("head_dim_96"):
        phase_head_dim_96(torch)
    if run("lora_train"):
        from torch_automatic_distributed_neural_network_tpu_torch import \
            SyntheticLM

        lora_launches = phase_lora_train(
            torch, SyntheticLM(vocab_size=50257, seq_len=1025, batch_size=8))
        torch.cuda.empty_cache()
    if run("serve_lora"):
        lora_k4_launches = phase_serve_lora(torch)
        torch.cuda.empty_cache()
    if run("zoo"):
        zoo_launches = phase_zoo(torch)
        torch.cuda.empty_cache()
    if run("resnet"):
        phase_resnet(torch, card)
        torch.cuda.empty_cache()
    if run("llama_fsdp"):
        llama_launches = phase_llama_fsdp(card)
    if run("moe"):
        moe_k4_launches, moe_launches = phase_moe(torch, card)
        torch.cuda.empty_cache()
    if run("pipeline_cp"):
        pipe_cp_launches = phase_pipeline_cp(torch, card)
    seconds = time.monotonic() - t_start
    order = sorted(starts, key=starts.get)
    emit({"phase": "done", "seconds": seconds, "phase_start_s": starts,
          "phase_seconds": {name: (starts[nxt] if nxt else seconds)
                            - starts[name] for name, nxt in
                            zip(order, order[1:] + [None])}})
    if only is not None:
        return 0

    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": PAGED_SOURCE,
        "replaces": PAGED_REPLACES,
        "launches": paged_launches + lora_k4_launches + moe_k4_launches,
        "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None}]
    for name, rec in flash.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCES[name],
            "replaces": FLASH_REPLACES[name],
            "launches": (train_launches[name] + dist_launches[name]
                         + lora_launches[name] + sharded_launches[name]
                         + zoo_launches[name] + llama_launches[name]
                         + moe_launches[name] + pipe_cp_launches[name]),
            **{key: rec[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            # the same kernel at BERT base's shape, not causal (phase zoo)
            "noncausal_bert_shape": {key: flash_bert[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    emit({"phase": "summary", "n_kernels": len(kernels),
          "k4_launches_per_decode_step": paged_launches_per_step,
          "prefix_hit_rate": {pool: rec["on"]["prefix_hit_rate"]
                              for pool, rec in prefix.items()}})
    emit({"kernels": kernels})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


PHASES = ("build", "kernel_cases", "timing", "tile_check",
          "flash_kernel_cases", "flash_timing", "serve", "train",
          "dist_plan", "trainer", "launch", "sharded_trainer", "generate",
          "serve_prefix", "serve_spec", "head_dim_96", "lora_train",
          "serve_lora", "zoo", "resnet", "llama_fsdp", "moe", "pipeline_cp")


if __name__ == "__main__":
    sys.exit(main())
