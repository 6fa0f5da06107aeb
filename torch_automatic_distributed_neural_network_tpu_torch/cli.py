"""Command line for the PyTorch port: the ``serve``, ``doctor`` and
``devices`` subcommands.

    python -m torch_automatic_distributed_neural_network_tpu_torch serve \\
        --family gpt2 --size small --streams 16 --slots 8 --max-len 1024
    python -m torch_automatic_distributed_neural_network_tpu_torch doctor CKPT_DIR
    python -m torch_automatic_distributed_neural_network_tpu_torch devices

Mirrors the JAX package's ``tadnn serve``: the same flags and the same
JSON summary line, plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path).  Weights are random, made from ``--seed``.
``--prefix-cache``, ``--shared-prefix N`` (every prompt starts with the
same N seeded tokens), ``--speculative K`` and ``--adapters N
[--adapter-rank R] [--quant-adapters]`` (N seeded LoRA tenants
``tenant{i}``, request j served by ``tenant{j % N}``) run as in the JAX
package.  Flags whose features the port does not have yet
(disaggregation, tensor parallelism) are accepted and refused with exit
code 2 when set.  ``doctor`` is the
checkpoint part of the JAX package's ``tadnn doctor``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time


def cmd_serve(args: argparse.Namespace) -> int:
    """Build a decoder, spin up the paged-KV ServeEngine, drive it with N
    seeded streams and print one JSON summary line.  ``--smoke`` pins the
    tiny CI configuration of the JAX package's ``tadnn serve --smoke``."""
    import numpy as np
    import torch

    from .inference.serve import ServeEngine, random_adapter
    from .models import GPT2, Llama
    from .obs.journal import Journal
    from .utils.device import resolve_device

    if args.smoke:
        args.family, args.size = "gpt2", "test"
        args.streams = args.streams or 8
        args.max_len = args.max_len or 64
        args.block_size = args.block_size or 8
        args.max_new = args.max_new or 12
        args.prompt_len = args.prompt_len or 10
        args.slots = args.slots or 4
    if args.family not in ("gpt2", "llama"):
        print(f"serve needs a decoder family (gpt2/llama), got "
              f"{args.family!r}" + (" (MoE decoding is a later slice of the "
                                    "port)" if args.family == "moe" else ""),
              file=sys.stderr)
        return 2
    later = [flag for flag, on in (
        ("--disaggregate", args.disaggregate),
        ("--serve-tp", args.serve_tp > 1)) if on]
    if later:
        print(f"serve: {', '.join(later)} not ported yet (a later slice of "
              f"the PyTorch port)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    family = {"gpt2": GPT2, "llama": Llama}[args.family]
    size = args.size or "test"
    max_len = args.max_len or 256
    vocab = args.vocab or (128 if size == "test" else None)
    overrides = {"max_seq_len": max_len, "dtype": torch.float32}
    if vocab:
        overrides["vocab_size"] = vocab
    with torch.device(device):
        model = family(size, **overrides)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    model.init_weights(gen)
    cfg = model.cfg
    rs = np.random.RandomState(args.seed)
    prompt_len = args.prompt_len or 10
    lora_spec = None
    n_adapters = int(args.adapters or 0)
    if n_adapters:
        from .training.lora import LoraSpec

        lora_spec = LoraSpec(rank=args.adapter_rank)

    with Journal(args.journal, host0_only=False,
                 meta={"tool": "serve"}) as jnl:
        eng = ServeEngine(
            model,
            n_slots=args.slots or 4,
            max_len=max_len,
            block_size=args.block_size or 16,
            quant_kv=args.quant_kv,
            attention_impl=args.attention_impl,
            prefill_chunk=args.prefill_chunk or None,
            admission=args.admission,
            speculative=args.speculative,
            prefix_cache=args.prefix_cache,
            lora_spec=lora_spec,
            # +1: slot 0 is the identity adapter
            n_adapters=n_adapters + 1 if n_adapters else 8,
            quant_adapters=args.quant_adapters,
            journal=jnl,
            device=device,
        )
        for i in range(n_adapters):
            eng.register_adapter(
                f"tenant{i}", random_adapter(model, lora_spec,
                                             seed=args.seed + 100 + i))
        streams = args.streams or 8
        shared_len = max(0, min(args.shared_prefix, prompt_len - 1))
        shared = (rs.randint(1, cfg.vocab_size, size=(shared_len,))
                  if shared_len else None)
        for j in range(streams):
            prompt = rs.randint(1, cfg.vocab_size, size=(prompt_len,))
            if shared is not None:
                prompt = np.concatenate([shared, prompt[shared_len:]])
            eng.submit([int(t) for t in prompt],
                       max_new_tokens=args.max_new or 12, eos_id=0,
                       adapter=(f"tenant{j % n_adapters}" if n_adapters
                                else None))
        t0 = time.monotonic()
        done = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.monotonic() - t0
        totals = sorted((r.t_done or 0.0) - r.t_submit for r in done)
        new_tokens = sum(r.n_generated for r in done)

        def pct(vals, q):
            return (vals[min(len(vals) - 1,
                             max(0, math.ceil(q * len(vals)) - 1))]
                    if vals else None)

        summary = {
            "family": args.family, "size": size,
            "streams": streams, "slots": eng.n_slots,
            "n_requests": len(done),
            "new_tokens": new_tokens,
            "wall_s": round(wall, 4),
            "tokens_per_s": round(new_tokens / max(wall, 1e-9), 2),
            "p50_latency_s": pct(totals, 0.50),
            "p99_latency_s": pct(totals, 0.99),
            "mean_occupancy": (round(eng.mean_occupancy, 4)
                               if eng.mean_occupancy is not None else None),
            "preemptions": eng.scheduler.n_preemptions,
            "quant_kv": args.quant_kv,
            "attention_impl": eng.attention_impl,
            "prefill_chunk": eng.prefill_chunk,
            "adapters": n_adapters,
            "adapter_rank": lora_spec.rank if lora_spec else None,
            "quant_adapters": bool(args.quant_adapters and n_adapters),
            "adapter_hit_rate": (
                round(eng.adapter_pool.allocator.hit_rate, 4)
                if eng.adapter_pool is not None else None),
            "speculative": eng.speculative,
            "spec_accept_rate": (
                round(eng.spec_accepted / eng.spec_drafted, 4)
                if eng.spec_drafted else None),
            "disaggregate": False,
            "prefix_cache": eng.prefix_cache is not None,
            "prefix_hit_rate": (
                round(eng.prefix_cached_tokens
                      / max(1, sum(r.n_prompt for r in done)), 4)
                if eng.prefix_cache is not None else None),
            "prefix_hit_requests": (eng.prefix_hits
                                    if eng.prefix_cache is not None
                                    else None),
            "prefix_saved_chunks": (eng.prefix_saved_chunks
                                    if eng.prefix_cache is not None
                                    else None),
            "cow_forks": (eng.cow_forks
                          if eng.prefix_cache is not None else None),
            "decode_routes": dict(eng.decode_routes),
            "tp": 1,
            "kv_ships": eng.pool.n_transfers,
            "shipped_blocks": eng.pool.transferred_blocks,
            "shipped_bytes": eng.pool.transferred_bytes,
            "prefill_busy_s": round(eng.prefill_busy_s, 4),
            "decode_busy_s": round(eng.decode_busy_s, 4),
            "overlapped_wall_s": round(eng.overlapped_wall_s, 4),
            "journal": args.journal,
            "device": str(device),
        }
    print(json.dumps(summary))
    if args.smoke and len(done) != streams:
        print(f"smoke: expected {streams} finished requests, got "
              f"{len(done)}", file=sys.stderr)
        return 1
    return 0


def cmd_doctor(args: argparse.Namespace) -> int:
    """Verify a checkpoint directory's integrity and print the fallback
    chain restore_or_init would walk.  Exit 0 when at least one step is
    restorable, 1 otherwise (corrupt-only or empty directory)."""
    if args.launch_dir:
        raise NotImplementedError(
            "doctor --launch-dir: the launcher is not ported to the "
            "PyTorch package yet (ROADMAP Queue 1 item 3)")
    if args.gateway_dir:
        raise NotImplementedError(
            "doctor --gateway-dir: the gateway is not ported to the "
            "PyTorch package yet (ROADMAP Queue 1 item 7)")
    if not args.directory:
        print("doctor: a checkpoint directory is required", file=sys.stderr)
        return 2
    from .training import resilience

    report = resilience.verify_directory(args.directory)
    if args.json:
        print(json.dumps(report))
    else:
        print(resilience.format_doctor(report))
    return 0 if report["healthy"] else 1


def cmd_devices(args: argparse.Namespace) -> int:
    """The detected topology (``topology.detect``) and its chip's numbers;
    under ``torchrun`` the process group is brought up first."""
    import torch

    from . import topology
    from .utils.device import process_count, process_index

    topology.initialize_distributed()
    topo = topology.detect()
    chip = topo.chip
    print(f"process {process_index()}/{process_count()}")
    print(f"devices: {topo.num_devices} x {topo.device_kind} "
          f"({topo.platform}); visible CUDA devices: "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    print(f"hosts: {topo.num_hosts}  multihost: {topo.is_multihost}")
    print(f"chip: {chip.flops_per_s / 1e12:g} TFLOP/s bf16, "
          f"{chip.hbm_bytes / 2**30:.1f} GiB at "
          f"{chip.hbm_bytes_per_s / 1e12:g} TB/s, links "
          f"{chip.ici_bytes_per_s / 1e9:g} GB/s in a host, "
          f"{chip.dcn_bytes_per_s / 1e9:g} GB/s between hosts")
    if args.json:
        print(json.dumps({"num_devices": topo.num_devices,
                          "device_kind": topo.device_kind,
                          "platform": topo.platform,
                          "process_count": process_count(),
                          "chip": dataclasses.asdict(chip)}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m torch_automatic_distributed_neural_network_tpu_torch",
        description="tadnn on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser(
        "serve",
        help="continuous-batching serving loop (paged KV cache, "
             "iteration-level scheduler); --smoke pins the tiny CI "
             "configuration")
    p.add_argument("--smoke", action="store_true",
                   help="CI smoke: test-size model, 8 streams")
    p.add_argument("--family", default="gpt2",
                   help="decoder family: gpt2 | llama")
    p.add_argument("--size", default=None,
                   help="model preset (default: test)")
    p.add_argument("--vocab", type=int, default=None,
                   help="vocab override (default 128 for test size)")
    p.add_argument("--streams", type=int, default=None,
                   help="number of concurrent request streams")
    p.add_argument("--slots", type=int, default=None,
                   help="decode slots (batch width of the decode step)")
    p.add_argument("--max-len", type=int, default=None, dest="max_len",
                   help="max tokens per request (prompt + generated)")
    p.add_argument("--max-new", type=int, default=None, dest="max_new",
                   help="max generated tokens per request")
    p.add_argument("--prompt-len", type=int, default=None,
                   dest="prompt_len")
    p.add_argument("--block-size", type=int, default=None,
                   dest="block_size", help="KV pool block size (tokens)")
    p.add_argument("--quant-kv", action="store_true", dest="quant_kv",
                   help="int8 KV blocks (inference/quant.quantize_kv)")
    p.add_argument("--attention-impl", default="paged",
                   choices=("paged", "dense"), dest="attention_impl",
                   help="decode attention: the paged CUDA kernel or the "
                        "dense gather_blocks reference path")
    p.add_argument("--prefill-chunk", type=int, default=32,
                   dest="prefill_chunk",
                   help="chunked-prefill chunk size (0 = single-shot "
                        "prefill)")
    p.add_argument("--admission", default="reserve",
                   choices=("reserve", "optimistic"),
                   help="block admission policy (scheduler.py)")
    p.add_argument("--adapters", type=int, default=0,
                   help="serve N seeded LoRA tenants (tenant0..N-1); "
                        "request j goes to tenant j %% N")
    p.add_argument("--adapter-rank", type=int, default=8,
                   dest="adapter_rank", help="LoRA rank of the tenants")
    p.add_argument("--quant-adapters", action="store_true",
                   dest="quant_adapters",
                   help="int8 adapter pool (per-output-channel scales)")
    p.add_argument("--speculative", type=int, nargs="?", const=4,
                   default=0, metavar="K",
                   help="greedy speculative decoding: K prompt-lookup "
                        "drafts verified per step (default K 4)")
    p.add_argument("--disaggregate", action="store_true",
                   help="(not ported yet)")
    p.add_argument("--prefix-cache", action="store_true",
                   dest="prefix_cache",
                   help="cross-request prefix reuse (radix index over "
                        "resident KV blocks)")
    p.add_argument("--shared-prefix", type=int, default=0,
                   dest="shared_prefix", metavar="N",
                   help="every stream's prompt starts with the same N "
                        "seeded tokens (prefix-cache traffic)")
    p.add_argument("--serve-tp", type=int, default=1, dest="serve_tp",
                   metavar="N", help="(not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--journal", default=None,
                   help="journal path for serve.* spans (the JAX "
                        "package's tadnn report renders them)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "doctor",
        help="verify a checkpoint directory (per-leaf integrity "
             "manifests, resilience.py) and print the fallback chain; "
             "exits nonzero when no step is restorable")
    p.add_argument("directory", nargs="?", default=None,
                   help="CheckpointManager directory")
    p.add_argument("--launch-dir", default=None,
                   help="launch supervision health (not ported yet)")
    p.add_argument("--gateway-dir", default=None,
                   help="fleet post-mortem of a gateway (not ported yet)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("devices",
                       help="the detected topology and its chip's numbers")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_devices)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
