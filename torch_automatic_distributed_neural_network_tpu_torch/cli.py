"""Command line for the PyTorch port: the ``serve``, ``doctor``,
``devices``, ``run``, ``launch`` and ``tokenize`` subcommands.

    python -m torch_automatic_distributed_neural_network_tpu_torch serve \\
        --family gpt2 --size small --streams 16 --slots 8 --max-len 1024
    python -m torch_automatic_distributed_neural_network_tpu_torch doctor CKPT_DIR
    python -m torch_automatic_distributed_neural_network_tpu_torch doctor --launch-dir DIR
    python -m torch_automatic_distributed_neural_network_tpu_torch devices
    torchrun --nproc-per-node 2 -m torch_automatic_distributed_neural_network_tpu_torch \\
        run train.py -- ARGS
    python -m torch_automatic_distributed_neural_network_tpu_torch launch \\
        --smoke --hosts 2 --launch-dir DIR
    python -m torch_automatic_distributed_neural_network_tpu_torch tokenize \
        corpus.txt corpus.tadn --tokenizer byte

Mirrors the JAX package's ``tadnn serve``: the same flags and the same
JSON summary line, plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path).  Weights are random, made from ``--seed``.
``--prefix-cache``, ``--shared-prefix N`` (every prompt starts with the
same N seeded tokens), ``--speculative K`` and ``--adapters N
[--adapter-rank R] [--quant-adapters]`` (N seeded LoRA tenants
``tenant{i}``, request j served by ``tenant{j % N}``) run as in the JAX
package, and so do ``--disaggregate`` (disaggregated prefill's time
model) and ``--serve-tp N`` (tensor-parallel serving: one process a
device under ``torchrun`` or the port's launcher, N of them; every rank
serves the same seeded streams in lockstep and rank 0 writes the
journal and prints the summary).  ``doctor`` is the checkpoint and launch part of the
JAX package's ``tadnn doctor`` (a sharded directory, ``training/
shards.py``, is verified through its per-host shard chain).  ``run``
brings the process group up from ``torchrun``'s environment and runs a
script (the JAX package's ``tadnn run``); ``launch`` spawns and
supervises a worker cohort (``training/launch.py``), and ``launch
--smoke`` runs a clean and a SIGKILLed launch and exits 0 only when
their per-step losses are bitwise equal.  The cohort forms over NCCL,
one card a worker, unless ``--simulate`` asks for gloo on the CPU.
``tokenize`` writes a UTF-8 text file as a TADN token file
(``data/text.py``) with the JAX package's arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import runpy
import sys
import time


def cmd_serve(args: argparse.Namespace) -> int:
    """Build a decoder, spin up the paged-KV ServeEngine, drive it with N
    seeded streams and print one JSON summary line.  ``--smoke`` pins the
    tiny CI configuration of the JAX package's ``tadnn serve --smoke``."""
    import numpy as np
    import torch

    from .inference.serve import ServeEngine, random_adapter
    from .models import GPT2, MoE, Llama
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
    if args.family not in ("gpt2", "llama", "moe"):
        print(f"serve needs a decoder family (gpt2/llama/moe), got "
              f"{args.family!r}", file=sys.stderr)
        return 2
    mesh = None
    if args.serve_tp > 1:
        from . import topology

        topology.initialize_distributed()  # a no-op outside torchrun
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        if world != args.serve_tp:
            print(f"--serve-tp {args.serve_tp} needs {args.serve_tp} "
                  f"processes, one a device (torchrun --nproc-per-node "
                  f"{args.serve_tp}), but the world has {world}",
                  file=sys.stderr)
            return 2
        mesh = topology.build_mesh(tensor=args.serve_tp)
    device = resolve_device(None if args.device == "cuda" else args.device)

    family = {"gpt2": GPT2, "llama": Llama, "moe": MoE}[args.family]
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

    with Journal(args.journal, host0_only=mesh is not None,
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
            mesh=mesh,
            disaggregate=args.disaggregate,
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
            "disaggregate": eng.disaggregate,
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
            "tp": eng.tp,
            "kv_ships": eng.pool.n_transfers,
            "shipped_blocks": eng.pool.transferred_blocks,
            "shipped_bytes": eng.pool.transferred_bytes,
            "prefill_busy_s": round(eng.prefill_busy_s, 4),
            "decode_busy_s": round(eng.decode_busy_s, 4),
            "overlapped_wall_s": round(eng.overlapped_wall_s, 4),
            "journal": args.journal,
            "device": str(device),
        }
    if mesh is None or torch.distributed.get_rank() == 0:
        print(json.dumps(summary))
    if args.smoke and len(done) != streams:
        print(f"smoke: expected {streams} finished requests, got "
              f"{len(done)}", file=sys.stderr)
        return 1
    return 0


def cmd_doctor(args: argparse.Namespace) -> int:
    """Verify a checkpoint directory's integrity and print the fallback
    chain restore_or_init would walk.  Exit 0 when at least one step is
    restorable, 1 otherwise (corrupt-only or empty directory).

    ``--launch-dir`` switches to launch supervision health (training/
    launch.py): per-host last-seen heartbeats, restart-budget
    consumption, and which host broke the cohort; exit 1 when the
    launch gave up.  ``--gateway-dir`` is the serving twin: a fleet
    post-mortem from a gateway journal — per-replica heartbeats,
    failovers, hedge record, breaker/degrade history, and which replica
    broke the cohort; exit 1 when an accepted request was lost."""
    if args.launch_dir:
        from .training import launch as launch_mod

        doc = launch_mod.launch_doctor(args.launch_dir)
        if args.json:
            print(json.dumps(doc))
        else:
            print(launch_mod.format_launch_doctor(doc))
        return 1 if doc.get("ok") is False else 0
    if args.gateway_dir:
        from .inference.gateway import doctor as gw_doctor

        doc = gw_doctor.gateway_doctor(args.gateway_dir)
        if args.json:
            print(json.dumps(doc))
        else:
            print(gw_doctor.format_gateway_doctor(doc))
        return 1 if doc.get("ok") is False else 0
    if not args.directory:
        print("doctor: a checkpoint directory, --launch-dir or "
              "--gateway-dir is required", file=sys.stderr)
        return 2
    from .training import resilience, shards

    # sharded-format dirs (training/shards.py) carry a meta.json per
    # step; verify those through the per-host shard chain instead
    sharded = any(
        os.path.isfile(os.path.join(args.directory, str(s), "meta.json"))
        for s in resilience.list_steps(args.directory)
    )
    report = (shards.verify_directory(args.directory) if sharded
              else resilience.verify_directory(args.directory))
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


def cmd_run(args: argparse.Namespace) -> int:
    """Bring the process group up from ``torchrun``'s environment
    (``topology.initialize_distributed``; a no-op for one process
    launched without it), then run ``script`` as ``__main__`` with the
    arguments after it."""
    from . import topology
    from .utils.device import process_count, process_index

    topology.initialize_distributed()
    if process_count() > 1 and process_index() == 0:
        print(f"distributed: {process_count()} processes, backend "
              f"{__import__('torch').distributed.get_backend()}")
    script_args = list(args.script_args)
    if script_args and script_args[0] == "--":
        script_args = script_args[1:]
    sys.argv = [args.script, *script_args]
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.script)) or ".")
    runpy.run_path(args.script, run_name="__main__")
    return 0


def cmd_launch(args: argparse.Namespace) -> int:
    """Elastic multi-process launch (training/launch.py): spawn and
    supervise N workers with sharded async checkpoints, cohort restart
    under the RestartPolicy budget, and seeded chaos.

    ``--smoke`` runs the acceptance pair — a clean run and a chaos run
    (one SIGKILL) — and exits nonzero unless the chaos run resumes to
    **bitwise-identical** per-step losses."""
    from .training import resilience
    from .training.launch import LaunchConfig, Launcher

    chaos = None
    if args.kill_host_at or args.tear_shard_at or args.partition_journal_at:
        chaos = resilience.ChaosPlan(
            seed=args.seed,
            sigkill_at=tuple(args.kill_host_at or ()),
            shard_tear_at=tuple(args.tear_shard_at or ()),
            journal_partition_at=tuple(args.partition_journal_at or ()),
            chaos_host=args.chaos_host,
        )

    def make_cfg(launch_dir: str, chaos_plan) -> LaunchConfig:
        return LaunchConfig(
            launch_dir=launch_dir, hosts=args.hosts, steps=args.steps,
            ckpt_every=args.ckpt_every, strategy=args.strategy,
            zero1=args.zero1, seed=args.seed,
            max_restarts=args.max_restarts, elastic=args.elastic,
            watchdog_s=args.watchdog_s, chaos=chaos_plan,
            heartbeat_interval_s=args.heartbeat_interval_s,
            simulate=args.simulate, export_cache=args.export_cache,
        )

    if args.smoke:
        # acceptance pair: uninterrupted oracle, then the same seeded
        # run with one SIGKILL right after a step — per-step losses must
        # match bitwise after the resume
        if chaos is None:
            chaos = resilience.ChaosPlan(
                seed=args.seed, sigkill_at=(max(args.ckpt_every + 1, 3),),
                chaos_host=args.chaos_host)
        clean = Launcher(make_cfg(
            os.path.join(args.launch_dir, "clean"), None)).run()
        chaotic = Launcher(make_cfg(
            os.path.join(args.launch_dir, "chaos"), chaos)).run()
        parity = (clean.get("ok") and chaotic.get("ok")
                  and clean.get("losses") == chaotic.get("losses"))
        out = {
            "ok": bool(parity),
            "clean_ok": clean.get("ok"),
            "chaos_ok": chaotic.get("ok"),
            "parity": bool(clean.get("losses")
                           and clean.get("losses") == chaotic.get("losses")),
            "restarts_used": chaotic.get("restarts_used"),
            "final_loss": chaotic.get("final_loss"),
            "world": chaotic.get("world"),
            "merged_journal": chaotic.get("merged_journal"),
            "launch_dir": args.launch_dir,
            "clean_rounds_s": clean.get("rounds_s"),
            "chaos_rounds_s": chaotic.get("rounds_s"),
            "resume_s": chaotic.get("resume_s"),
        }
        if not chaotic.get("ok"):
            out["error"] = chaotic.get("error")
        print(json.dumps(out))
        return 0 if out["ok"] else 1

    result = Launcher(make_cfg(args.launch_dir, chaos)).run()
    if args.json:
        print(json.dumps(result))
    else:
        if result["ok"]:
            print(f"launch ok: world={result['world']} "
                  f"rounds={result['rounds']} "
                  f"restarts={result['restarts_used']} "
                  f"final_step={result['final_step']} "
                  f"final_loss={result['final_loss']}")
            if result.get("merged_journal"):
                print(f"merged journal: {result['merged_journal']}")
        else:
            print(f"launch FAILED: {result.get('error')}", file=sys.stderr)
    return 0 if result["ok"] else 1


def cmd_tokenize(args: argparse.Namespace) -> int:
    """Text -> TADN token file (``data/text.py``)."""
    from .data.text import load_tokenizer, tokenize_file

    tokenize_file(args.input, args.output,
                  tokenizer=load_tokenizer(args.tokenizer),
                  append_eos=not args.no_eos)
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
                   help="decoder family: gpt2 | llama | moe")
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
                   help="disaggregated prefill/decode: every prefilling "
                        "slot advances each step, finished KV ships into "
                        "decode through the pool, the step's modelled "
                        "wall is max(prefill, decode); token-identical "
                        "to colocated")
    p.add_argument("--prefix-cache", action="store_true",
                   dest="prefix_cache",
                   help="cross-request prefix reuse (radix index over "
                        "resident KV blocks)")
    p.add_argument("--shared-prefix", type=int, default=0,
                   dest="shared_prefix", metavar="N",
                   help="every stream's prompt starts with the same N "
                        "seeded tokens (prefix-cache traffic)")
    p.add_argument("--serve-tp", type=int, default=1, dest="serve_tp",
                   metavar="N",
                   help="tensor-parallel serving over N processes, one a "
                        "device (run under torchrun --nproc-per-node N)")
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
                   help="launch supervision health (training/launch.py): "
                        "heartbeats, restart budget, the failed host")
    p.add_argument("--gateway-dir", default=None,
                   help="fleet post-mortem of a gateway journal (a "
                   "directory holding one, or the file)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("devices",
                       help="the detected topology and its chip's numbers")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_devices)

    p = sub.add_parser("run", help="run a training script (initializes the "
                                   "process group under torchrun)")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser(
        "launch",
        help="elastic multi-process launcher: spawn + supervise N workers "
             "(one device each) with async sharded checkpoints, cohort "
             "restart on death/hang, and seeded chaos "
             "(training/launch.py); --smoke runs the kill-and-resume "
             "bitwise-parity acceptance pair",
    )
    p.add_argument("--launch-dir", required=True,
                   help="run directory (heartbeats, shards, journals)")
    p.add_argument("--hosts", type=int, default=2,
                   help="worker processes, one device each")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--ckpt-every", type=int, default=2)
    p.add_argument("--strategy", default="auto",
                   help="worker strategy ('auto' re-plans per cohort)")
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-restarts", type=int, default=2)
    p.add_argument("--elastic", action="store_true",
                   help="shrink the cohort after a host death instead "
                        "of respawning at full size")
    p.add_argument("--watchdog-s", type=float, default=120.0,
                   help="no heartbeat step-progress within this = hung")
    p.add_argument("--heartbeat-interval-s", type=float, default=0.5)
    p.add_argument("--kill-host-at", type=int, action="append",
                   help="SIGKILL the chaos host right after this step "
                        "(repeatable)")
    p.add_argument("--tear-shard-at", type=int, action="append",
                   help="tear the chaos host's shard of the newest "
                        "committed step at this step (repeatable)")
    p.add_argument("--partition-journal-at", type=int, action="append",
                   help="partition the chaos host's journal at this "
                        "step (repeatable)")
    p.add_argument("--chaos-host", type=int, default=0)
    p.add_argument("--simulate", action="store_true",
                   help="workers on the CPU over gloo (default: NCCL, "
                        "the card LOCAL_RANK names a worker)")
    p.add_argument("--export-cache", default=None, dest="export_cache",
                   help="not ported yet (ROADMAP Queue 1 item 4)")
    p.add_argument("--smoke", action="store_true",
                   help="clean + one-SIGKILL chaos pair; exit nonzero "
                        "unless resumed losses match bitwise")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_launch)

    p = sub.add_parser(
        "tokenize",
        help="tokenize a UTF-8 text file into a native TADN token file "
             "(data/loader.py) for the LM examples")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--tokenizer", default="byte",
                   help="'byte' (offline, vocab 258) or a transformers "
                        "tokenizer name/path (tried local-first)")
    p.add_argument("--no-eos", action="store_true")
    p.set_defaults(fn=cmd_tokenize)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
