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
   Llama 1b and Llama 8b attention geometries, block sizes 8 and 16,
   fp32/bf16/int8 pools, with and without a sliding window, fp32 and
   bf16 queries; bounds 1e-4 (fp32 q) and 2e-2 (bf16 q); then its split
   context where the splits outnumber the attended pages (ctx 0, short
   contexts, windows that empty whole splits) at the wrapper's split
   count and at 2, 7 and 16, each launched twice and bitwise equal, and
   a slot with no attended key giving zeros;
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
   repeated by the wrapper) and hd-128 geometries, S in {1, 100, 129,
   512, 1000, 1024}, causal or not, window None or 256, fp32 and bf16;
   bounds 1e-4 (fp32: sums in another order) and 2e-2 (bf16: one ulp at
   |x| in [2, 4)), and bf16 dv differing from its plain version in at
   most 2 % of its elements (K2 keeps p in fp32 for dv; rounding p to
   bf16 once would move far more, shown beside it on the same inputs);
   bf16 K1, K2 and K3 launched twice on the same inputs, bitwise equal;
   then the ``autograd.Function`` on the card against autograd of
   ``xla_attention`` in fp32 (1e-4);
8. flash timing at the training shape (B 8, S 1024, 12 heads, hd 64,
   causal, bf16), L2 flushed before each launch: K1, K2 and K3 beside
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
   steps run times 12 layers times 2, 1 and 1.

Then, on lines of their own: the per-kernel JSON record, the
``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is visible or the package is missing.
``--phases a,b,...`` runs only the named phases (for a short first
check of a new kernel) and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
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

    geoms = {"gpt2-small": (12, 12, 64), "llama-1b": (32, 8, 64),
             "llama-8b": (32, 8, 128)}
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
    emit({"phase": "kernel_cases", "kernel": "paged_attention", "cases": n,
          "worst_abs_err": worst})
    return worst


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
                                 "llama-1b": (32, 8, 64)}.items():
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
    tables, ctx, tok, _ = eng._decode_inputs()
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
                n_slots, max_len, block_size, quant_kv, seed) -> int:
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

    jnl = Journal(None, host0_only=False, meta={"tool": "chip_smoke"})
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
    return launches


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


def _dv_single_rounding(torch, fa, q, k, v, do, lse, delta, causal, window):
    """dv as a kernel that rounds p to bf16 once would give it: what the
    share bound must tell apart from K2."""
    p, _ = fa._backward_terms(q, k, v, do, lse, delta, causal, window)
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

    geoms = {"gpt2-small": (12, 12, 64), "llama-1b": (32, 8, 64),
             "hd128": (16, 16, 128)}
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
                    # the GQA repeat of the public entry point
                    q, k, v = fa._prep_bshd(q, k, v, causal, window)
                    kw = dict(causal=causal, window=window)
                    o, lse = fa.flash_forward(q, k, v, **kw)
                    o_ref, lse_ref = fa.flash_forward_reference(
                        q, k, v, causal, window)
                    delta = fa._delta(o_ref, do)
                    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
                    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, **kw)
                    dk_ref, dv_ref = fa.flash_dkv_reference(
                        q, k, v, do, lse_ref, delta, causal, window)
                    dq_ref = fa.flash_dq_reference(q, k, v, do, lse_ref,
                                                   delta, causal, window)
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
                            window)
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
             dict(H=4, kvH=4, hd=128, S=300, causal=False, window=None)]
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


def phase_flash_timing(torch) -> dict:
    import torch.nn.functional as F

    from torch_automatic_distributed_neural_network_tpu_torch.ops import \
        flash_attention as fa
    from torch_automatic_distributed_neural_network_tpu_torch.ops.attention \
        import attention

    B, S, H, hd = 8, 1024, 12, 64
    q, k, v, do = _flash_inputs(torch, B=B, S=S, H=H, kvH=H, hd=hd,
                                dtype=torch.bfloat16, seed=1001)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kw = dict(causal=True)
    o, lse = fa.flash_forward(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True)
    delta = fa._delta(o_ref, do)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse_ref, delta, True)
    dq_ref = fa.flash_dq_reference(q, k, v, do, lse_ref, delta, True)
    errs = {"flash_forward": max(_max_err(o, o_ref), _max_err(lse, lse_ref)),
            "flash_dkv": max(_max_err(dk, dk_ref), _max_err(dv, dv_ref)),
            "flash_dq": _max_err(dq, dq_ref)}
    for name, err in errs.items():
        require(err <= 2e-2, f"timing-shape {name} error {err} > 2e-2")

    # the library yardstick: one PyTorch call for the same function
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))  # BHSD
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), dot,
                                   retain_graph=True)

    runs = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, **kw),
            lambda: fa.flash_forward_reference(q, k, v, True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True)),
        "flash_dkv": (
            lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw),
            lambda: fa.flash_dkv_reference(q, k, v, do, lse_ref, delta, True),
            sdpa_bwd),
        "flash_dq": (
            lambda: fa.flash_dq(q, k, v, do, lse_ref, delta, **kw),
            lambda: fa.flash_dq_reference(q, k, v, do, lse_ref, delta, True),
            sdpa_bwd),
    }
    # the library calls' device time, timed once each: the cold-L2 median,
    # and beside it the kernel time that torch.profiler sees with a warm L2
    library_ms = {fn: (_time_ms(torch, fn, 20, flush),
                       _profiled_ms(torch, fn, 10))
                  for fn in dict.fromkeys(r[2] for r in runs.values())}
    # causal: the pairs with q >= k, what the function needs
    pairs = B * H * S * (S + 1) // 2
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
              "shape": {"B": B, "S": S, "H": H, "hd": hd, "causal": True,
                        "dtype": "bfloat16"},
              "library": ("scaled_dot_product_attention backward (dq, dk "
                          "and dv together)" if library is sdpa_bwd else
                          "scaled_dot_product_attention"), **rec})
        out[name] = rec

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
    return out


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
        journal = Journal()
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
            "checkpoint_bytes": saves[0].get("bytes") if saves else None,
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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone: "
                         + ", ".join(PHASES) + " (prints no result)")
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
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        gpt2_config, llama_config)
    from torch_automatic_distributed_neural_network_tpu_torch.models \
        .transformer_core import DecoderLM

    # fp32 parity checks: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    def run(name) -> bool:
        return only is None or name in only

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
        flash = phase_flash_timing(torch)

    def model_of(cfg, seed):
        with torch.device("cuda"):
            m = DecoderLM(cfg)
        return m.init_weights(torch.Generator(device="cuda").manual_seed(seed))

    if run("serve"):
        gpt2 = model_of(gpt2_config("small", max_seq_len=1024,
                                    dtype=torch.float32), 1)
        paged_launches = phase_serve(
            torch, name="gpt2-small", model=gpt2, n_requests=16,
            prompt_len=256, max_new=64, n_slots=8, max_len=1024,
            block_size=16, quant_kv=False, seed=0)
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
    if run("train"):
        from torch_automatic_distributed_neural_network_tpu_torch import \
            SyntheticLM

        data = SyntheticLM(vocab_size=50257, seq_len=1025, batch_size=8)
        train_launches = phase_train(torch, data)
        phase_train_parity(torch, data)
        phase_train_profile(torch, data)
        del data
        torch.cuda.empty_cache()
    if run("trainer"):
        phase_trainer(torch)
    emit({"phase": "done", "seconds": time.monotonic() - t_start})
    if only is not None:
        return 0

    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": PAGED_SOURCE,
        "replaces": PAGED_REPLACES, "launches": paged_launches,
        "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None}]
    for name, rec in flash.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCES[name],
            "replaces": FLASH_REPLACES[name],
            "launches": train_launches[name],
            **{key: rec[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    emit({"kernels": kernels})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


PHASES = ("build", "kernel_cases", "timing", "tile_check",
          "flash_kernel_cases", "flash_timing", "serve", "train", "trainer")


if __name__ == "__main__":
    sys.exit(main())
