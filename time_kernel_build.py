#!/usr/bin/env python3
"""Time the two ways of building the port's paged-attention kernel.

    python3 time_kernel_build.py    # checkout root, one CUDA card

Both routes build ``csrc/paged_attention.cu`` from scratch, for sm_90a
with ``-O3``, into fresh directories under ``build/kernel_build_timing/``:

- ``nvcc_ctypes``: the port's route (``ops/build.py``), one ``nvcc`` on
  the plain C source into a shared library loaded with ``ctypes``;
- ``cpp_extension``: ``torch.utils.cpp_extension.load`` on the same
  source plus a small pybind11 binding, the one file that includes
  ``torch/extension.h``.

Each built kernel then runs once on a small decode case and must agree
with the plain version within 1e-4 (fp32 queries, bf16 pool).  Prints
one JSON line per route with its build seconds, then the card's
``nvidia-smi`` name and power limit.  Exits non-zero when no CUDA device
is visible or a route fails to build or disagrees.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "kernel_build_timing"
SOURCE = ROOT / "torch_automatic_distributed_neural_network_tpu_torch" / \
    "csrc" / "paged_attention.cu"

BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAStream.h>
#include <cmath>

extern "C" int tadnn_paged_attention_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* ctx_lens, void* out, void* partial, void* counters,
    int q_dtype, int kv_dtype, int S, int NB, int kvH, int G, int hd, int bs,
    int MB, int window, int n_split, float scale, void* stream);

// fp32 queries over a bf16 pool, no window, one block a (slot, kv head)
// (no split, so no workspace): the case this script runs
torch::Tensor decode(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                     torch::Tensor tables, torch::Tensor ctx) {
  TORCH_CHECK(q.is_cuda() && q.scalar_type() == torch::kFloat32 &&
              k.scalar_type() == torch::kBFloat16);
  auto out = torch::empty_like(q);
  const int hd = q.size(2), kvH = k.size(2);
  const int err = tadnn_paged_attention_decode(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), nullptr, nullptr,
      tables.data_ptr(), ctx.data_ptr(), out.data_ptr(), nullptr, nullptr,
      0, 1, q.size(0), k.size(0), kvH, q.size(1) / kvH, hd, k.size(1),
      tables.size(1), 0, 1, 1.0f / std::sqrt(static_cast<float>(hd)),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "kernel launch failed: ", err);
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) { m.def("decode", &decode); }
"""

CUDA_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3"]


def _case(torch):
    from chip_smoke import _pool_case

    return _pool_case(torch, S=4, Hq=12, kvH=12, hd=64, bs=16,
                      ctx_lens=[0, 5, 100, 1023], pool_dtype=torch.bfloat16,
                      q_dtype=torch.float32, null_slot=-1, seed=7)


def _check(torch, got, case) -> float:
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention_reference

    torch.cuda.synchronize()
    err = float((got - paged_attention_reference(*case)).abs().max())
    if not err <= 1e-4:
        raise SystemExit(f"time_kernel_build: max_abs_err {err} > 1e-4")
    return err


def time_nvcc_ctypes(torch) -> dict:
    from torch_automatic_distributed_neural_network_tpu_torch.ops import build
    from torch_automatic_distributed_neural_network_tpu_torch.ops \
        .paged_attention import paged_attention

    build.BUILD_DIR = OUT / "nvcc_ctypes"
    t0 = time.monotonic()
    build.build(["paged_attention"])
    seconds = time.monotonic() - t0
    case = _case(torch)
    return {"route": "nvcc_ctypes", "build_s": seconds,
            "max_abs_err": _check(torch, paged_attention(*case), case)}


def time_cpp_extension(torch) -> dict:
    from torch.utils import cpp_extension

    if not cpp_extension.is_ninja_available():
        raise SystemExit("time_kernel_build: cpp_extension.load needs "
                         "ninja, which is not installed")
    d = OUT / "cpp_extension"
    d.mkdir(parents=True)
    binding = d / "binding.cpp"
    binding.write_text(BINDING)
    t0 = time.monotonic()
    ext = cpp_extension.load(
        name="tadnn_paged_attention_timing",
        sources=[str(SOURCE), str(binding)], build_directory=str(d),
        extra_cflags=["-O3"], extra_cuda_cflags=CUDA_FLAGS)
    seconds = time.monotonic() - t0
    case = _case(torch)
    return {"route": "cpp_extension", "build_s": seconds,
            "max_abs_err": _check(torch, ext.decode(*case), case)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_kernel_build: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    for fn in (time_nvcc_ctypes, time_cpp_extension):
        print(json.dumps(fn(torch)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
