"""Command line for the PyTorch port: the ``serve``, ``doctor``,
``devices``, ``run``, ``launch``, ``tokenize``, ``tune``, ``simulate``,
``monitor``, ``gateway``, ``report``, ``check``, ``fit``, ``trace``,
``profile``, ``bench`` and ``export`` subcommands.

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

``tune`` ranks a zoo model's candidate plans with the tune/ cost model
for the devices of this run (or ``--topology``'s fleet) and, with
``--measure``, times the top-k on ``--device``; ``simulate`` sweeps
hypothetical fleets (default ``h100-8``) device-free; ``monitor`` judges
a serving journal's windows against an SLO; ``gateway --smoke`` and
``--chaos`` run the virtual-clock scenarios, and ``gateway --port``
serves HTTP/SSE over ``--replicas`` engines on ``--device``.  Their
flags, rows and exit codes are the JAX package's.

    python -m torch_automatic_distributed_neural_network_tpu_torch tune \
        --family gpt2 --size small --seq 1024 --batch 8 --measure --top-k 1
    python -m torch_automatic_distributed_neural_network_tpu_torch simulate \
        --family gpt2 --size small --topology h100-8,h100-8x4
    python -m torch_automatic_distributed_neural_network_tpu_torch gateway \
        --port 8080 --replicas 2
    python -m torch_automatic_distributed_neural_network_tpu_torch monitor \
        JOURNAL --slo "p99_ms<=2500" --check

``report`` renders a run's journal and metrics file (and ``--check`` /
``--check-simulate`` guard bench records); ``check`` runs the source and
async lints, ``--serving``, ``--protocol``, the journal contract and the
traced-step lints (``--preflight FILE``, ``--memory``, ``--serving
--trace-serve``: the step traced on fake tensors on ``--device``);
``fit`` answers "will this model fit?" from the step run once on fake
tensors (``AutoDistribute.compile_report``), one JSON line a candidate;
``trace`` profiles a zoo config's steps on
``--device`` (cuda by default) with ``torch.profiler``, or runs a
script with ``TADNN_TRACE_EVERY_N`` exported; ``profile`` runs a script
under the profiler.  Their flags, lines and exit codes are the JAX
package's.

    python -m torch_automatic_distributed_neural_network_tpu_torch trace \
        --family gpt2 --size small --seq 1024 --batch 8 --journal run.jsonl
    python -m torch_automatic_distributed_neural_network_tpu_torch report run.jsonl
    python -m torch_automatic_distributed_neural_network_tpu_torch check --protocol
    python -m torch_automatic_distributed_neural_network_tpu_torch check \
        --memory --no-source --family gpt2 --size small --batch 8
    python -m torch_automatic_distributed_neural_network_tpu_torch fit \
        --family llama --size 8b --batch 1 --strategy dp

``bench`` times the collectives over a mesh axis (``parallel.
collectives.bench_sweep``; one JSON line a result): alone it brings up a
world of one rank (NCCL on the card, gloo with ``--device cpu``), under
``torchrun`` or ``launch`` it runs over the world.  ``export`` fills the
export cache (``export/``) with the kernel libraries a zoo config's
train step (and, with ``--serve``, its serving engine) launches, so a
later start installs them instead of running ``nvcc``; ``--worlds N,M``
exports for other world sizes in child processes, ``--verify`` audits
the entries and ``--gc`` drops those not hit within ``--max-age-days``.
``run`` keeps the built kernels across processes
(``topology.enable_compilation_cache``) unless
``TADNN_NO_COMPILE_CACHE=1``.

    python -m torch_automatic_distributed_neural_network_tpu_torch bench \
        --ops allreduce,allgather --sizes 1048576,134217728
    python -m torch_automatic_distributed_neural_network_tpu_torch export \
        --family gpt2 --size small --seq 1024 --batch 8 --serve --json
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

    if not os.environ.get("TADNN_NO_COMPILE_CACHE"):
        topology.enable_compilation_cache()
    topology.initialize_distributed()
    if process_count() > 1 and process_index() == 0:
        print(f"distributed: {process_count()} processes, backend "
              f"{__import__('torch').distributed.get_backend()}")
    return _script(args.script, args.script_args)


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


def cmd_bench(args: argparse.Namespace) -> int:
    """Collectives microbenchmark (the JAX package's BASELINE metric is
    the all-reduce bus bandwidth): one JSON line per (op, size) over the
    ``--axis`` group of a ``build_mesh(<axis>=-1)`` mesh.  Without a
    process group (and without ``torchrun``'s environment) it brings up
    a world of one rank: NCCL on the card, gloo with ``--device cpu`` —
    which moves nothing between devices (``bus_bw_gbps`` 0 by the
    NCCL-tests factor)."""
    import torch

    from . import topology
    from .parallel.collectives import bench_sweep
    from .training.launch import _free_port
    from .utils.device import group_up, process_index

    backend = "gloo" if args.device == "cpu" else "nccl"
    own = not group_up()
    if own:
        if "WORLD_SIZE" in os.environ:
            topology.initialize_distributed(backend=backend)
        else:
            if backend == "nccl" and not torch.cuda.is_available():
                raise RuntimeError(
                    "bench on --device cuda needs a card; pass --device cpu "
                    "for gloo on the CPU")
            topology.initialize_distributed(
                backend=backend, world_size=1, rank=0,
                init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        mesh = topology.build_mesh(**{args.axis: -1})
        ops = args.ops.split(",")
        sizes = [int(x) for x in args.sizes.split(",")]
        for r in bench_sweep(sizes=sizes, ops=ops, axis=args.axis,
                             mesh=mesh):
            if process_index() == 0:
                print(json.dumps(r.to_json()), flush=True)
    finally:
        if own:
            torch.distributed.destroy_process_group()
    return 0


def cmd_export(args: argparse.Namespace) -> int:
    """The export cache (``export/``): build the kernel libraries a zoo
    config's train step launches — and, with ``--serve``, those of the
    serving engine's decode and prefill — store them in the cache, and
    print one result line per kind.  Any later ``Trainer`` /
    ``ServeEngine`` start on the same fingerprint (the same shapes,
    plan, topology, torch, CUDA and ``nvcc``) then installs them in
    milliseconds instead of running ``nvcc``.  ``--worlds N,M`` exports
    the train step for N-process worlds of this kind in child processes
    (the elastic launcher's shrink candidates); ``--verify`` audits
    which entries would load here/now and which are stale; ``--gc``
    drops entries not hit within ``--max-age-days``."""
    from .export import cache as export_cache_mod
    from .obs import journal as obs_journal_mod
    from .obs.journal import Journal

    cache = export_cache_mod.resolve(args.cache or True)

    if args.gc:
        days = 30.0 if args.max_age_days is None else float(args.max_age_days)
        with Journal(args.journal, host0_only=False,
                     meta={"tool": "export"}) as jnl:
            with obs_journal_mod.as_default(jnl):
                stats = cache.gc(days * 86400.0)
        if args.json:
            print(json.dumps({"cache": cache.root, **stats}))
        else:
            kb = stats["payload_bytes_freed"] // 1024
            print(f"export cache: {cache.root}")
            print(f"  gc: dropped {stats['dropped']}/{stats['scanned']} "
                  f"entries not hit in {days:g} day(s) "
                  f"({kb} KiB of payloads freed, {stats['kept']} kept)")
        return 0

    if args.verify:
        report = cache.verify()
        if args.json:
            print(json.dumps({"cache": cache.root, "entries": report}))
        else:
            print(f"export cache: {cache.root}")
            if not report:
                print("  (empty)")
            for e in report:
                mark = "live " if e["live"] else "STALE"
                kb = (e.get("payload_bytes") or 0) // 1024
                line = (f"  [{mark}] {e.get('kind') or '?':<14} "
                        f"{e['key'][:16]}  {kb} KiB")
                if e.get("reason"):
                    line += f"  ({e['reason']})"
                print(line)
        return 0

    if args.worlds:
        # one child a world size: each plans for an N-process world of
        # this kind without joining one and stores the entry under the
        # key such a world looks up
        import subprocess

        worlds = [int(w) for w in args.worlds.split(",") if w.strip()]
        base = [sys.executable, "-m", __package__, "export",
                "--family", args.family, "--batch", str(args.batch),
                "--strategy", args.strategy, "--precision", args.precision,
                "--grad-accum", str(args.grad_accum),
                "--device", args.device, "--cache", cache.root, "--json"]
        for flag, value in (("--size", args.size), ("--seq", args.seq),
                            ("--preflight", args.preflight)):
            if value:
                base += [flag, str(value)]
        if args.zero1:
            base.append("--zero1")
        ok = True
        for w in worlds:
            env = {**os.environ, "TADNN_EXPORT_CACHE": cache.root}
            proc = subprocess.run([*base, "--world", str(w)], env=env,
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                ok = False
                print(json.dumps({"world": w, "error": "export failed",
                                  "rc": proc.returncode,
                                  "stderr": proc.stderr[-500:]}))
                continue
            for line in proc.stdout.splitlines():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                rec["world"] = w
                print(json.dumps(rec))
        return 0 if ok else 1

    from . import AutoDistribute
    from .training import adamw

    results: list[dict] = []
    with Journal(args.journal, host0_only=False,
                 meta={"tool": "export"}) as jnl:
        with obs_journal_mod.as_default(jnl):
            if args.preflight:
                # user-authored spec: the file's tadnn_export() returns
                # {model, loss_fn, sample_batch[, optimizer, **ad_kwargs]}
                # — export the REAL training program, not a zoo preset
                import importlib.util

                spec = importlib.util.spec_from_file_location(
                    "_tadnn_export_target", args.preflight)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                hook = getattr(mod, "tadnn_export", None)
                if hook is None:
                    print(f"{args.preflight} does not define "
                          f"tadnn_export()", file=sys.stderr)
                    return 2
                d = dict(hook())
                model = d.pop("model")
                loss = d.pop("loss_fn")
                sample = d.pop("sample_batch")
                optimizer = d.pop("optimizer", None) or adamw(1e-4)
                kwargs = {"strategy": args.strategy,
                          "precision": args.precision,
                          "device": args.device}
                kwargs.update(d)
            else:
                model, loss, sample = _family_setup(args)
                optimizer = adamw(1e-4)
                kwargs = {"strategy": args.strategy,
                          "precision": args.precision,
                          "device": args.device}
            ad = AutoDistribute(model, optimizer=optimizer, loss_fn=loss,
                                grad_accum=args.grad_accum,
                                zero1=args.zero1, **kwargs)
            results.append(ad.export_step(None, sample, cache=cache,
                                          world=args.world))
            if args.serve:
                if args.family not in ("gpt2", "llama", "moe"):
                    print("export --serve needs a decoder family "
                          "(--family gpt2|llama|moe)", file=sys.stderr)
                    return 2
                results.extend(_export_serve(args, cache, jnl))
    rc = 0
    for r in results:
        if r.get("source") == "error":
            rc = 1
        if args.json:
            print(json.dumps(r))
        else:
            wall = (f"installed in {r['deserialize_s'] * 1e3:.1f} ms"
                    if r.get("source") == "hit"
                    else f"built in {r.get('compile_s', 0.0):.2f} s"
                    if r.get("source") == "compile" else "FAILED")
            kb = (r.get("payload_bytes") or 0) // 1024
            print(f"{r.get('kind', '?'):<14} {r.get('source', '?'):<8} "
                  f"{wall}  ({kb} KiB, key {r.get('key', '?')[:16]})")
    if not args.json:
        print(f"export cache: {cache.root}")
    return rc


def _export_serve(args, cache, journal) -> list[dict]:
    """The serving engine's entries for ``export --serve``: the family
    at ``--size`` (``test`` by default) in fp32 on ``--device``, with
    uninitialized weights (only the shapes and the kernels matter)."""
    import torch

    from .inference.serve import ServeEngine
    from .models import GPT2, Llama, MoE

    family = {"gpt2": GPT2, "llama": Llama, "moe": MoE}[args.family]
    size = args.size or "test"
    max_len = args.max_len or 64
    vocab = args.vocab or (128 if size == "test" else None)
    overrides = {"max_seq_len": max_len, "dtype": torch.float32,
                 "remat": False}
    if vocab:
        overrides["vocab_size"] = vocab
    with torch.device(args.device):
        model = family(size, **overrides)
    eng = ServeEngine(
        model, n_slots=args.slots or 4, max_len=max_len,
        block_size=args.block_size or 8, prefill_chunk=args.prefill_chunk,
        journal=journal, export_cache=cache, device=args.device)
    return eng.export_info


def cmd_tokenize(args: argparse.Namespace) -> int:
    """Text -> TADN token file (``data/text.py``)."""
    from .data.text import load_tokenizer, tokenize_file

    tokenize_file(args.input, args.output,
                  tokenizer=load_tokenizer(args.tokenizer),
                  append_eos=not args.no_eos)
    return 0


def _family_setup(args: argparse.Namespace, device=None):
    """(model, loss_fn, sample_batch) for the model-zoo commands (tune,
    simulate) from --family/--size/--seq/--batch.  The model is built on
    ``device``, the meta device by default (shapes, no memory: the
    planner's input); ``tune --measure`` builds one on the card a
    candidate."""
    import numpy as np
    import torch

    from .models import GPT2, MLP, Bert, Llama, MoE, ViT
    from .training import (
        blockwise_next_token_loss,
        masked_lm_loss,
        moe_next_token_loss,
        next_token_loss,
        softmax_xent_loss,
    )

    with torch.device(device or "meta"):
        if args.family == "mlp":
            # the bench model: --size is the comma-separated layer
            # widths, --seq the (square) input image side
            feats = tuple(
                int(x) for x in (args.size or "1024,1024,10").split(","))
            side = args.seq or 28
            model = MLP(features=feats, in_features=side * side)
            sample = {
                "x": np.zeros((args.batch, side * side), np.float32),
                "label": np.zeros((args.batch,), np.int32),
            }
            return model, softmax_xent_loss, sample
        family = {"gpt2": GPT2, "llama": Llama, "moe": MoE,
                  "bert": Bert, "vit": ViT}[args.family]
        size = args.size or {"gpt2": "1p3b", "llama": "8b", "moe": "test",
                             "bert": "large", "vit": "large"}[args.family]
        blockwise = getattr(args, "loss", "full") == "blockwise"
        if args.family == "vit":
            side = args.seq or 224  # --seq is the image side for ViT
            model = family(size, image_size=side)
            loss = softmax_xent_loss
            sample = {"x": np.zeros((args.batch, side, side, 3), np.float32),
                      "label": np.zeros((args.batch,), np.int32)}
        else:
            seq = args.seq or 1024
            model = family(size, max_seq_len=seq)
            if args.family == "bert":
                loss = masked_lm_loss
                sample = {
                    "input_ids": np.zeros((args.batch, seq), np.int32),
                    "labels": np.full((args.batch, seq), -100, np.int32),
                }
            else:
                if blockwise:
                    loss = blockwise_next_token_loss()
                else:
                    loss = (moe_next_token_loss if args.family == "moe"
                            else next_token_loss)
                sample = {
                    "tokens": np.zeros((args.batch, seq + 1), np.int32),
                }
    return model, loss, sample


def _abstract(model, precision: str):
    """The planner's input for ``model`` in ``precision``'s storage
    dtype, and its head counts."""
    from .core import _heads
    from .planner import abstract_params
    from .training import precision as precision_mod

    prec = precision_mod.resolve(precision)
    return abstract_params(model, prec.param_dtype), _heads(model)


def cmd_fit(args: argparse.Namespace) -> int:
    """Will this model fit?  The step run once on fake tensors on
    ``--device`` under a live-storage tracker
    (``AutoDistribute.compile_report``) — nothing materialized, so it
    answers for models far larger than this device.  One JSON line per
    measured candidate, then the chosen strategy and mesh."""
    from . import AutoDistribute
    from .training import adamw

    if args.loss == "blockwise" and args.family in ("bert", "vit"):
        # blockwise CE is a CAUSAL next-token loss; silently running it
        # on an encoder would fit-report a graph no real config trains
        print(json.dumps({"error": "--loss blockwise is next-token "
                          "(causal); bert uses masked LM, vit uses "
                          "classification"}))
        return 1
    model, loss, sample = _family_setup(args)
    ad = AutoDistribute(
        model, optimizer=adamw(1e-4), loss_fn=loss,
        strategy=args.strategy, precision=args.precision,
        device=args.device,
    )
    if args.strategy == "search":
        ad.build_plan(None, sample)
        entries = ad.search_report or [
            {"strategy": ad.plan.strategy, "note": "1-device no-op"}
        ]
    else:
        report = ad.compile_report(None, sample)
        peak = report and report.get("per_device_peak_bytes")
        if not peak:
            print(json.dumps({"error": "backend exposes no analysis"}))
            return 1
        # same budget the search ladder measures against
        budget = AutoDistribute.hbm_fit_budget(ad.device_kind)
        entries = [{
            "strategy": ad.plan.strategy,
            "peak_bytes": peak,
            "budget_bytes": int(budget),
            "fits": peak <= budget,
            "flops": report.get("flops"),
            "memory": report.get("memory"),
        }]
    for e in entries:
        pb = e.get("peak_bytes")
        if pb:
            e["peak_gib"] = round(pb / 2**30, 3)
        print(json.dumps(e))
    chosen = ad.plan.strategy if ad.plan is not None else None
    print(json.dumps({"chosen_strategy": chosen,
                      "mesh": ad.plan.degrees if ad.plan is not None
                      else None}))
    return 0


# activation profiles by tune's model arguments, for later calls in this
# process (a profile traces the step twice)
_PROFILES: dict[tuple, dict] = {}


def cmd_tune(args: argparse.Namespace) -> int:
    """Rank candidate parallelism plans with the tune/ cost model (and
    optionally measure the top-k with a real microbenchmark), printing
    the per-candidate cost breakdown the decision was made from.
    ``--topology`` ranks for a fleet spelled as ``simulate`` spells it
    (default: the devices of this run)."""
    from . import AutoDistribute, topology, tune
    from .training import adamw

    if getattr(args, "simulate", None):
        # tune --simulate h100-8,h100-8x4 == tadnn simulate over those
        # fleets with this tune invocation's model/search knobs
        args.topology = [t.strip() for t in args.simulate.split(",")
                         if t.strip()]
        return cmd_simulate(args)

    model, loss, sample = _family_setup(args)
    abstract, heads = _abstract(model, args.precision)
    try:
        topo = (topology.parse_topology(args.tune_topology)
                if args.tune_topology else topology.detect())
    except ValueError as e:
        print(f"tune: {e}", file=sys.stderr)
        return 2
    act_profile = None
    key = (args.family, args.size, args.seq, args.batch, args.precision,
           getattr(args, "loss", "full"), args.device)
    if topo.num_devices > 1:  # one device: the fallback reads none
        act_profile = _PROFILES.get(key)
    if topo.num_devices > 1 and act_profile is None:
        try:
            # the liveness profile of the traced step (fake tensors on
            # --device: nothing is allocated), as JAX's tune ranks with
            # it; kept for this process's later calls on the same model
            act_profile = _PROFILES[key] = AutoDistribute(
                model, optimizer=adamw(1e-4), loss_fn=loss,
                precision=args.precision, device=args.device,
            ).activation_profile(None, sample)
        except Exception:  # profile is advisory — rank on the heuristic
            act_profile = None
    policy = tune.TunePolicy(
        grad_accums=tuple(int(g) for g in args.grad_accums.split(",")),
        top_k=args.top_k,
        batch_items=tune.estimate_batch_items(sample),
        use_cache=not args.no_cache,
        act_profile=act_profile,
        zero1=not args.no_zero1,
    )
    result = tune.tune(abstract, topo, policy=policy, heads=heads)
    ranked = result.ranked
    if not ranked:  # cache hit or fallback — re-rank locally for display
        kept, _ = tune.enumerate_candidates(
            abstract, topo, grad_accums=policy.grad_accums,
            max_tensor=policy.max_tensor, state_factor=policy.state_factor,
            batch_items=policy.batch_items, safety=policy.safety,
            act_profile=policy.act_profile, zero1=policy.zero1, heads=heads,
        )
        ranked = tune.rank(abstract, topo, kept,
                           state_factor=policy.state_factor,
                           batch_items=policy.batch_items,
                           safety=policy.safety,
                           act_profile=policy.act_profile,
                           heads=heads) if kept else []

    measured: dict[str, float] = {}
    if args.measure and ranked:
        def make_ad(cand):
            # a fresh model a candidate: init and the step own it
            fresh, _, _ = _family_setup(args, device=args.device)
            return AutoDistribute(
                fresh, optimizer=adamw(1e-4), loss_fn=loss,
                strategy=cand.strategy, mesh=cand.degrees_dict,
                grad_accum=cand.grad_accum, precision=args.precision,
                device=args.device,
            )

        trials = tune.measure.measure_candidates(
            [e.candidate for e in ranked[:args.top_k]], make_ad, 0, sample,
        )
        measured = {t["candidate"]: t.get("step_time_ms")
                    for t in trials if t.get("step_time_ms")}
        for t in trials:
            if t.get("error"):
                print(f"tune: {t['candidate']} was not measured: "
                      f"{t['error']}", file=sys.stderr)

    if args.json:
        for i, est in enumerate(ranked):
            row = {"rank": i, **est.to_json()}
            if est.candidate.label() in measured:
                row["measured_ms"] = measured[est.candidate.label()]
            print(json.dumps(row))
        print(json.dumps({
            "chosen_strategy": result.strategy, "mesh": result.degrees,
            "grad_accum": result.grad_accum, "zero1": result.zero1,
            "source": result.source,
            "cache_key": result.key,
        }))
        return 0

    print(f"devices: {topo.num_devices} x {topo.device_kind}  "
          f"candidates: {len(ranked)}  source: {result.source}")
    hdr = (f"{'rank':>4} {'strategy':<9} {'mesh':<24} {'ga':>2} "
           f"{'step_ms':>9} {'compute':>8} {'comm':>8} {'hbm':>8} "
           f"{'mem_gib':>8} fit")
    if measured:
        hdr += f" {'measured':>9}"
    print(hdr)
    for i, est in enumerate(ranked):
        b = est.breakdown
        mesh = "x".join(f"{a}{n}" for a, n in est.candidate.degrees if n > 1)
        strat = est.candidate.strategy + (
            "+z1" if est.candidate.zero1 else "")
        line = (f"{i:>4} {strat:<9} {mesh or '1':<24} "
                f"{est.candidate.grad_accum:>2} "
                f"{est.step_time_s * 1e3:>9.3f} {b['compute_ms']:>8.3f} "
                f"{b['comm_ms']:>8.3f} {b['hbm_ms']:>8.3f} "
                f"{b['memory']['total_bytes'] / 2**30:>8.2f} "
                f"{'y' if est.fits else 'N'}")
        m = measured.get(est.candidate.label())
        if measured:
            line += f" {m:>9.3f}" if m is not None else f" {'-':>9}"
        print(line)
    print(f"chosen: {result.strategy}{'+z1' if result.zero1 else ''} "
          f"{result.degrees} "
          f"grad_accum={result.grad_accum} ({result.source}; "
          f"cache {tune.cache.cache_path()})")
    return 0


def cmd_simulate(args: argparse.Namespace) -> int:
    """Fleet-scale what-if planner: sweep hypothetical topologies x
    parallelism plans and rank the joint prediction (training MFU/step
    time, HBM headroom, serving tok/s + p99 from a virtual-time replay
    of the real scheduler, restart-budget survival) against an operator
    SLO.  Pure shape math + discrete-event simulation — device-free.
    Its ``simulate.*`` records go to ``--journal`` (in memory without
    one), the process default for the call."""
    from .obs import Journal, as_default

    with as_default(Journal(getattr(args, "journal", None))):
        return _simulate(args)


def _simulate(args: argparse.Namespace) -> int:
    from . import tune

    model, _loss, sample = _family_setup(args)
    abstract, _heads = _abstract(model, args.precision)
    # transformer families carry a cfg that sizes the serving KV pool;
    # without one (mlp, vit) the serving columns are simply absent
    model_cfg = getattr(model, "cfg", None)
    if not all(hasattr(model_cfg, k)
               for k in ("n_layers", "kv_heads", "head_dim")):
        model_cfg = None

    # repeated --topology flags, or one comma-separated list (as tune
    # --simulate takes them)
    specs = [t.strip() for spec in (args.topology or ["h100-8"])
             for t in spec.split(",") if t.strip()]
    measured_overlap = getattr(args, "measured_overlap", None)
    trace_journal = getattr(args, "trace_journal", None)
    if measured_overlap is None and trace_journal:
        # feed a traced run back into the roofline: trace.step records
        # carry collective_s / exposed_collective_s, and their exposed
        # fraction IS cost.score's measured_overlap
        from .tune import cost as cost_mod

        steps = []
        with open(trace_journal) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("name") == "trace.step":
                    steps.append(rec)
        measured_overlap = cost_mod.overlap_from_trace(steps)
        if measured_overlap is None:
            print(f"simulate: {trace_journal} has no trace.step records "
                  "with collective time; ignoring --trace-journal",
                  file=sys.stderr)
    try:
        traffic = tune.TrafficMix.parse(getattr(args, "traffic", None))
        slo = tune.SLOSpec.parse(getattr(args, "slo", None))
        adm_raw = getattr(args, "admissions", None) or "reserve,optimistic"
        admissions = tuple(
            a.strip() for a in adm_raw.split(",") if a.strip())
        policy = tune.SimulatePolicy(
            grad_accums=tuple(
                int(g) for g in
                str(getattr(args, "grad_accums", None)
                    or "1,2,4,8").split(",")),
            batch_items=tune.estimate_batch_items(sample),
            admissions=admissions,
            slots=int(getattr(args, "slots", None) or 8),
            block_size=int(getattr(args, "block_size", None) or 16),
            max_len=int(getattr(args, "max_len", None) or 256),
            prefill_chunk=(int(getattr(args, "prefill_chunk", None) or 32)
                           or None),
            disaggregate=bool(getattr(args, "disaggregate", False)),
            prefix_cache=bool(getattr(args, "prefix_cache", False)),
            measured_overlap=measured_overlap,
            preemption_rate_per_h=float(
                getattr(args, "preemption_rate", None) or 0.0),
            mission_hours=float(
                getattr(args, "mission_hours", None) or 24.0),
            top_k=int(getattr(args, "top_k", None) or 10),
            use_cache=not getattr(args, "no_cache", False),
        )
        report = tune.simulate.simulate(
            abstract, specs, model_cfg=model_cfg, policy=policy,
            traffic=traffic, slo=slo)
    except ValueError as e:
        # unknown kind / malformed traffic / malformed SLO — loud + clean
        print(f"simulate: {e}", file=sys.stderr)
        return 2

    out_path = getattr(args, "out", None)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    if getattr(args, "json", False):
        print(json.dumps(report))
        return 0

    preds = report["predictions"]
    print(f"simulated {report['n_candidates']} candidates over "
          f"{len(report['topologies'])} topologies "
          f"({report['n_slo_ok']} meet the SLO; cache {report['cache']})")
    print(f"{'rank':>4} {'topology':<12} {'plan':<26} {'adm':<10} "
          f"{'mfu':>6} {'step_ms':>9} {'hdroom':>7} {'tok/s/c':>8} "
          f"{'p99_ms':>8} {'occ':>5} {'pre':>4} {'surv':>6} slo")
    for i, p in enumerate(preds):
        p99 = (f"{p['p99_s'] * 1e3:>8.1f}" if p.get("p99_s") is not None
               else f"{'-':>8}")
        tok = (f"{p['tok_s_per_chip']:>8.1f}"
               if p.get("tok_s_per_chip") is not None else f"{'-':>8}")
        occ = (f"{p['mean_occupancy']:>5.2f}"
               if p.get("mean_occupancy") is not None else f"{'-':>5}")
        pre = (f"{p['preemptions']:>4d}"
               if p.get("preemptions") is not None else f"{'-':>4}")
        print(f"{i:>4} {p['topology']:<12} {p['plan']:<26} "
              f"{p['admission']:<10} {p['mfu']:>6.3f} "
              f"{p['step_time_s'] * 1e3:>9.3f} "
              f"{p['hbm_headroom_frac']:>7.2%} {tok} {p99} {occ} {pre} "
              f"{p['survival']:>6.3f} "
              f"{'ok' if p['slo_ok'] else ';'.join(p['slo_violations'])}")
    if getattr(args, "journal", None):
        print(f"journal written to {args.journal} (render with "
              f"`tadnn report {args.journal}`)")
    return 0


def cmd_monitor(args: argparse.Namespace) -> int:
    """Continuous SLO monitor over a serving journal (obs/slo_monitor):
    fold ``serve.*`` events into rolling event-time windows, evaluate
    the ``--slo`` spec per window with hysteresis, journal
    ``slo.breach`` / ``slo.recover`` incidents, and optionally compare
    measured throughput against the simulate replay's prediction for a
    bench record (``--drift``).  ``--follow`` tails a live journal; the
    default deterministically replays a finished one — with ``--check``
    the exit code is the CI gate (nonzero on any breach or out-of-band
    planner drift).  Pure file parsing — no device needed."""
    from .obs import slo_monitor as slm
    from .obs.journal import Journal
    from .tune.slo import SLOSpec

    if args.follow and args.replay:
        print("monitor: --follow and --replay are mutually exclusive",
              file=sys.stderr)
        return 2
    try:
        spec = SLOSpec.parse(args.slo)
    except ValueError as e:
        print(f"monitor: {e}", file=sys.stderr)
        return 2
    if not args.follow and not os.path.isfile(args.journal):
        # --follow accepts a not-yet-created journal (a gateway starts
        # its monitor before first traffic): Journal.follow polls for
        # the file under --idle-timeout instead of raising
        print(f"monitor: no journal at {args.journal}", file=sys.stderr)
        return 2
    policy = slm.MonitorPolicy(
        slo=spec, window_s=args.window,
        breach_after=args.breach_after,
        recover_after=args.recover_after,
        n_chips=args.chips, warmup_windows=args.warmup_windows)
    drift_extra = None
    if args.drift:
        with open(args.drift) as f:
            rec = json.load(f)
        # a full bench record or a bare extra dict both work
        drift_extra = rec.get("extra") or rec
    # incidents land in their own sink: --replay must never append to
    # the (possibly committed) journal it is reading
    with Journal(args.incident_journal, host0_only=False,
                 meta={"tool": "monitor",
                       "source": args.journal}) as sink:
        records = (Journal.follow(args.journal,
                                  idle_timeout=args.idle_timeout)
                   if args.follow else Journal.read(args.journal))
        summary = slm.monitor_records(
            records, policy, journal=sink, drift_extra=drift_extra)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    if args.json:
        print(json.dumps(summary))
    else:
        print(slm.format_summary(summary))
    if args.check:
        drift_bad = ((summary.get("drift") or {}).get("within_band")
                     is False)
        return 1 if (summary["breaches"] or drift_bad) else 0
    return 0


def cmd_gateway(args: argparse.Namespace) -> int:
    """Online serving gateway (inference/gateway): multi-replica
    ingress with prefix-affinity routing and the closed-loop SLO
    autoscaler.

    ``--smoke`` runs the virtual-clock chaos scenario twice (traffic
    flip → SLO breach → replan → scale-out → recover) and checks the
    two journals are byte-identical — the CI gate.  ``--chaos`` runs
    the FLEET fault scenario (seeded replica kill/stall/slow) and
    passes only if every accepted request completes with a token
    stream bitwise-identical to a fault-free replay, deterministically
    across two runs.  ``--port`` starts a real asyncio HTTP/SSE server
    over ``--replicas`` engines of the ``tadnn serve --smoke`` model on
    ``--device`` (default ``cuda``: the paged-attention kernel serves
    each replica's decode).
    """
    from .inference.gateway import chaos_smoke, fleet_chaos

    if getattr(args, "chaos", False):
        out = fleet_chaos(
            journal_path=args.journal,
            seed=args.seed,
            n_replicas=max(4, args.replicas))
        print(json.dumps(out))
        if not out["ok"]:
            for flag in ("deterministic", "stream_parity",
                         "all_completed", "killed_inflight",
                         "baseline_complete"):
                if not out[flag]:
                    print(f"gateway chaos: {flag} check failed",
                          file=sys.stderr)
            return 1
        return 0
    if args.smoke:
        out = chaos_smoke(
            journal_path=args.journal,
            n_replicas=args.replicas,
            slo_text=args.slo,
            max_replicas=args.max_replicas,
            scale=args.scale,
            autoscale=args.autoscale)
        print(json.dumps(out))
        if not out["ok"]:
            for flag in ("deterministic", "closed_loop"):
                if not out[flag]:
                    print(f"gateway smoke: {flag} check failed",
                          file=sys.stderr)
            return 1
        return 0
    if not args.port:
        print("tadnn gateway needs --smoke, --chaos or --port",
              file=sys.stderr)
        return 2

    import asyncio

    import torch

    from .inference.gateway import (
        AutoscalePolicy, EngineReplica, Gateway, serve_forever)
    from .inference.serve import ServeEngine
    from .models import GPT2
    from .obs.journal import Journal
    from .tune.slo import SLOSpec
    from .utils.device import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    with torch.device(device):
        model = GPT2("test", max_seq_len=args.max_len, vocab_size=128,
                     dtype=torch.float32, remat=False)
    model.init_weights(
        torch.Generator(device=device).manual_seed(args.seed + 1))

    with Journal(args.journal, host0_only=False,
                 meta={"tool": "gateway"}) as jnl:
        def make(name: str) -> EngineReplica:
            eng = ServeEngine(model, n_slots=args.slots,
                              max_len=args.max_len, block_size=8,
                              prefix_cache=True, journal=jnl, device=device)
            return EngineReplica(name, eng)

        replicas = [make(f"replica{i}") for i in range(args.replicas)]
        policy = (AutoscalePolicy(slo=SLOSpec.parse(args.slo))
                  if args.autoscale else None)
        gw = Gateway(replicas, journal=jnl, autoscale=policy,
                     make_replica=make if args.autoscale else None,
                     rate_limit_per_s=args.rate_limit,
                     queue_limit=args.queue_limit)
        print(json.dumps({"listening": True, "host": args.host,
                          "port": args.port,
                          "replicas": args.replicas,
                          "autoscale": bool(args.autoscale),
                          "journal": args.journal,
                          "device": str(device)}), flush=True)
        try:
            asyncio.run(serve_forever(gw, host=args.host,
                                      port=args.port))
        except KeyboardInterrupt:
            pass
    return 0


def _script(script: str, script_args: list[str]) -> int:
    """Run ``script`` as ``__main__`` with the arguments after it, the
    process group brought up from ``torchrun``'s environment first (a
    no-op for one process launched without it)."""
    from . import topology

    topology.initialize_distributed()
    script_args = list(script_args)
    if script_args and script_args[0] == "--":
        script_args = script_args[1:]
    sys.argv = [script, *script_args]
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)) or ".")
    runpy.run_path(script, run_name="__main__")
    return 0


def cmd_profile(args: argparse.Namespace) -> int:
    """Run a script under a ``torch.profiler`` capture (the CUDA lane
    too when ``--device`` is cuda); the Chrome trace goes to
    ``--logdir``."""
    from .utils import profiling

    os.makedirs(args.logdir, exist_ok=True)
    with profiling.trace(args.logdir, device=args.device):
        rc = _script(args.script, args.script_args)
    print(f"profile trace written to {args.logdir}")
    return rc


def cmd_trace(args: argparse.Namespace) -> int:
    """Profile real steps on ``--device``: a device-timeline capture
    (obs/trace) attributed into per-step compute / collective / exposed
    collective time and measured MFU, plus the measured-vs-modeled
    collective-bytes crosscheck (the profiled step's c10d ops vs
    planner.expected_collective_bytes).

    Two modes: a model-zoo config (--family et al., default the bench
    mlp) traced in-process, or a training script (``tadnn trace
    train.py``) run with TADNN_TRACE_EVERY_N exported so the Trainer
    instruments itself every Nth step.
    """
    if args.target and args.target.endswith(".py"):
        os.environ.setdefault("TADNN_TRACE_EVERY_N", str(args.every))
        if args.journal:
            os.environ.setdefault("TADNN_JOURNAL", args.journal)
        return _script(args.target, args.script_args)
    if args.target:
        print(f"trace target must be a .py script (got {args.target}); "
              "omit it to trace a --family config", file=sys.stderr)
        return 2

    import torch

    from . import AutoDistribute, topology
    from .obs import Journal, as_default
    from .obs import comms as obs_comms
    from .obs import trace as obs_trace
    from .training import adamw
    from .training.metrics import transformer_step_flops
    from .utils.device import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    with as_default(Journal(args.journal)) as jnl:  # None: in memory
        model, loss, sample = _family_setup(args, device=device)
        ad = AutoDistribute(model, optimizer=adamw(1e-4), loss_fn=loss,
                            strategy=args.strategy,
                            precision=args.precision, device=device)
        state = ad.init(torch.Generator(device=device).manual_seed(0),
                        sample)
        n_params = sum(p.numel() for p in ad.model.parameters())
        tokens = args.batch * ((args.seq or 1024)
                               if args.family in ("gpt2", "llama", "moe",
                                                  "bert") else 1)
        flops = transformer_step_flops(n_params, tokens)

        # warm up outside the capture — the first step builds the
        # kernels and would profile the build, not the step
        state, m = ad.step(state, sample)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timeline: dict = {}
        state, recs = obs_trace.trace_steps(
            ad.step, state, sample, steps=args.steps, first_step=1,
            logdir=args.logdir, flops_per_step=flops, journal=jnl,
            device=device, timeline=timeline,
        )
        measured = obs_trace.measured_collective_bytes(timeline)
        est = obs_comms.comm_profile(ad)
        # the profiled step covers every accumulation slice: grad_accum 1
        xc = obs_trace.crosscheck_collectives(
            measured, est.get("per_device") or {}, journal=jnl)
        jnl.close()

    if args.json:
        for r in recs:
            print(json.dumps(r))
        for c in xc:
            print(json.dumps(c))
        return 0
    topo = topology.detect()
    print(f"traced {len(recs)} step(s) on {topo.num_devices} x "
          f"{topo.device_kind}  (strategy "
          f"{ad.plan.strategy}, {n_params:,} params)")
    for r in recs:
        line = (f"  step {r['step']}: wall {r['wall_s'] * 1e3:8.2f}ms  "
                f"compute {r['compute_s'] * 1e3:8.2f}ms  "
                f"collective {r['collective_s'] * 1e3:7.2f}ms  "
                f"exposed {r['exposed_collective_s'] * 1e3:7.2f}ms")
        if r.get("measured_mfu") is not None:
            line += f"  mfu {r['measured_mfu']:.2%}"
        print(line)
    frac = obs_trace.exposed_fraction(recs)
    if frac is not None:
        print(f"exposed collective fraction: {frac:.1%} "
              "(communication the schedule failed to hide)")
    for c in xc:
        print(f"  {c['category']}: measured {c['measured_bytes']:,} B "
              f"vs modeled {c['modeled_bytes']:,} B  "
              f"ratio {c['ratio']}"
              + ("" if c["within_2x"] else "  !! outside 2x band"))
    if args.journal:
        print(f"journal written to {args.journal} (render with "
              f"`tadnn report {args.journal}`)")
    return 0


def cmd_report(args: argparse.Namespace) -> int:
    """Summarize a finished (or crashed) run from its on-disk artifacts:
    journal JSONL + MetricsLogger JSONL.  Pure file parsing — no torch
    import, so it works on a machine with no accelerator runtime.
    ``--check`` instead runs the bench freshness guard; ``--merge``
    joins per-host journals first (obs/aggregate)."""
    from .obs import report as obs_report

    if args.check:
        code, msgs = obs_report.check_bench(
            args.target, bench_path=args.bench,
            last_good_path=args.last_good)
        for m in msgs:
            # per-message verdict: with two trajectories (BENCH + SERVE)
            # one can be fresh while the other fails the aggregate code
            print(("ok   " if ": fresh" in m else "FAIL ") + m)
        return code
    if getattr(args, "check_simulate", False):
        code, msgs = obs_report.check_simulate(args.target)
        for m in msgs:
            print(("ok   " if "within 2x" in m else "FAIL ") + m)
        return code
    if args.merge:
        from .obs import aggregate

        try:
            merged = aggregate.merge_run(args.target)
            print(f"merged per-host journals -> {merged}")
        except (FileNotFoundError, NotADirectoryError, OSError) as e:
            print(f"--merge: {e}", file=sys.stderr)
            return 1
    rep = obs_report.generate(args.target, args.metrics)
    if args.json:
        print(json.dumps(rep))
    else:
        print(obs_report.format_report(rep))
    return 0


def _fmt_mem_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.2f} GiB"


def _print_memory_report(report: dict) -> None:
    rows = [
        ("params", report.get("params_bytes")),
        ("optimizer", report.get("optimizer_bytes")),
        ("model_state", report.get("model_state_bytes")),
        ("batch", report.get("batch_bytes")),
        ("activations", report.get("activation_bytes")),
        ("peak", report.get("peak_bytes")),
        ("budget", report.get("budget_bytes")),
    ]
    mesh = "x".join(f"{a}{n}" for a, n in
                    sorted((report.get("degrees") or {}).items()))
    strat = str(report.get("strategy"))
    if report.get("zero1"):
        strat += "+zero1"
    print(f"memory estimate (static, per device; strategy "
          f"{strat}, mesh {mesh or '1'}, "
          f"grad_accum {report.get('grad_accum')}, "
          f"remat {'on' if report.get('remat') else 'off'}):")
    for name, val in rows:
        if name == "model_state" and not val:
            continue
        print(f"  {name:<12} {_fmt_mem_bytes(val):>12}")
    comp = report.get("compiled") or {}
    peak_c = comp.get("per_device_peak_bytes")
    if peak_c:
        # the step run once on fake tensors (compile_report) takes the
        # place of XLA's compiled peak
        print(f"  {'run peak':<12} {_fmt_mem_bytes(peak_c):>12}  "
              f"(static/compiled {report.get('static_over_compiled')}x)")
    elif comp.get("error"):
        print(f"  run peak: unavailable ({comp['error']})")


def cmd_check(args: argparse.Namespace) -> int:
    """Static analyzer (analysis/): source and async lint over this
    package by default; ``--serving`` sizes a decoder's KV pool against
    ``--budget``; ``--protocol`` model-checks the serving control
    plane; ``--journal`` / ``--journal-file`` check the telemetry
    contract; ``--preflight FILE`` adds plan + graph lint driven by the
    file's ``tadnn_check()`` dict; ``--memory`` builds a model-zoo
    config (--family/--batch/--strategy) and runs the liveness
    peak-memory estimator against ``--budget``; ``--trace-serve`` lints
    the serving engine's traced steps.  The traces run on fake tensors
    on ``--device``.  Exit 1 on error-severity findings; with
    ``--strict`` also on warnings."""
    from . import analysis

    if args.rules:
        if getattr(args, "journal", False):
            # the generated journal event reference: the registry as a
            # markdown table
            from .obs import schema as obs_schema

            print(obs_schema.registry_markdown())
            return 0
        for r in analysis.RULES.values():
            print(f"{r.code}  {r.layer:<6} {r.severity:<5} {r.title}")
        return 0
    findings: list = []
    if not args.no_source:
        from .analysis import async_lint, source_lint

        findings += source_lint.lint_paths(args.paths or None)
        findings += async_lint.lint_paths(args.paths or None)
    if args.preflight:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "_tadnn_check_target", args.preflight)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        hook = getattr(mod, "tadnn_check", None)
        if hook is None:
            print(f"{args.preflight} does not define tadnn_check()",
                  file=sys.stderr)
            return 2
        hook_spec = dict(hook())
        if args.pl005_bytes is not None:
            hook_spec.setdefault("big_leaf_bytes", args.pl005_bytes)
        findings += analysis.check_spec(hook_spec)
    mem_report = None
    if args.memory:
        from . import AutoDistribute
        from .training import adamw

        model, loss, sample = _family_setup(args)
        ad = AutoDistribute(
            model, optimizer=adamw(1e-4), loss_fn=loss,
            strategy=args.strategy, precision=args.precision,
            grad_accum=args.grad_accum, zero1=args.zero1,
            device=args.device,
        )
        mem_findings, mem_report = analysis.memory_check(
            ad, sample, budget=args.budget, headroom=args.headroom,
            big_leaf_bytes=args.pl005_bytes,
            compiled=not args.no_compiled,
        )
        findings += mem_findings
    serve_est = None
    serve_trace_stats = None
    if getattr(args, "serving", False):
        if args.family not in ("gpt2", "llama", "moe"):
            print("check --serving needs a decoder family "
                  "(--family gpt2|llama|moe)", file=sys.stderr)
            return 2
        from .analysis import serve_lint

        # the model on the meta device: shapes and dtypes, no memory
        model, _, _ = _family_setup(args)
        cfg = model.cfg
        params_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        kwargs = {}
        if args.headroom is not None:
            kwargs["headroom"] = args.headroom
        serve_tp = int(getattr(args, "serve_tp", 1) or 1)
        if serve_tp > 1:
            # per-shard accounting: KV heads + adapter b factors split,
            # params charged per shard like the engine lays them out
            kwargs["degrees"] = {"tensor": serve_tp}
            params_bytes //= serve_tp
        s_findings, serve_est = serve_lint.serve_estimate(
            cfg, budget=args.budget,
            block_size=args.serve_block_size,
            max_len=args.serve_max_len or args.seq or 256,
            streams=args.serve_streams,
            quant_kv=args.serve_quant_kv,
            attention_impl=args.serve_attention_impl,
            adapters=args.serve_adapters,
            adapter_rank=args.serve_adapter_rank,
            quant_adapters=args.serve_quant_adapters,
            prefix_cache=bool(getattr(args, "serve_prefix_cache", False)),
            expected_hit_rate=float(
                getattr(args, "serve_prefix_hit_rate", None) or 0.0),
            params_bytes=params_bytes, **kwargs)
        findings += s_findings
        if args.trace_serve:
            from .analysis import serve_trace

            # a real engine on --device (weights uninitialized: the
            # traces read shapes only)
            model, _, _ = _family_setup(args, device=args.device)
            t_findings, serve_trace_stats = serve_trace.serve_trace_check(
                model,
                n_slots=4,
                max_len=min(args.serve_max_len or 64, cfg.max_seq_len),
                block_size=min(args.serve_block_size, 8),
                quant_kv=args.serve_quant_kv,
                attention_impl=args.serve_attention_impl,
                device=args.device,
            )
            findings += t_findings
    protocol_results = None
    if getattr(args, "protocol", False):
        from .analysis import protocol as protocol_mod

        p_findings, p_results = protocol_mod.run_protocol_check(
            scope=args.scope,
            counterexample_dir=args.counterexample_dir,
        )
        findings += p_findings
        protocol_results = [
            {"model": r.model, "scope": r.scope, "states": r.states,
             "transitions": r.transitions, "depth": r.depth,
             "frontier_peak": r.frontier_peak,
             "wall_s": round(r.wall_s, 3), "complete": r.complete,
             "violations": len(r.counterexamples)}
            for r in p_results]
    journal_stats = None
    if getattr(args, "journal", False) or getattr(args, "journal_file",
                                                  None):
        from .analysis import journal_lint
        from .obs import journal as obs_journal

        journal_stats = {}
        if getattr(args, "journal", False):
            j_findings, journal_stats = journal_lint.lint_paths(
                args.paths or None)
            findings += j_findings
            obs_journal.event(
                "lint.journal",
                kinds_emitted=journal_stats.get("kinds_emitted", 0),
                kinds_known=journal_stats.get("kinds_known", 0),
                sites=journal_stats.get("sites", 0),
                dynamic_sites=journal_stats.get("dynamic_sites", 0),
                coverage=journal_stats.get("coverage", 1.0),
                findings=len(j_findings))
        audits = {}
        for jf in (getattr(args, "journal_file", None) or ()):
            a_findings, a_stats = journal_lint.audit_journal(jf)
            findings += a_findings
            audits[jf] = {**a_stats, "findings": len(a_findings)}
        if audits:
            journal_stats = {**journal_stats, "audited": audits}
    try:
        findings = analysis.filter_ignored(findings, args.ignore or ())
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    analysis.journal_findings(findings, phase="check")
    summary = analysis.summarize(findings)
    if args.json:
        out = {"findings": [f.to_json() for f in findings],
               "summary": summary}
        if mem_report is not None:
            out["memory"] = mem_report
        if serve_est is not None:
            out["serve_estimate"] = serve_est
        if serve_trace_stats is not None:
            out["serve_trace"] = serve_trace_stats
        if protocol_results is not None:
            out["protocol"] = protocol_results
        if journal_stats is not None:
            out["journal"] = journal_stats
        print(json.dumps(out))
    else:
        for f in findings:
            print(f.format())
        if mem_report is not None:
            _print_memory_report(mem_report)
        if serve_est is not None:
            ws = serve_est.get("decode_workspace_bytes", 0)
            print(f"serve estimate: {serve_est['max_streams']} "
                  f"concurrent stream(s) of {serve_est['max_len']} "
                  f"tokens ({serve_est['num_blocks']} blocks x "
                  f"{serve_est['block_size']}, "
                  f"{'int8' if serve_est['quant_kv'] else 'bf16'} KV, "
                  f"{serve_est.get('attention_impl', 'paged')} decode"
                  + (f", {ws // 1024} KiB gather workspace" if ws
                     else "")
                  + (f", adapter pool {serve_est['n_adapters']}x "
                     f"r{serve_est['adapter_rank']} "
                     f"{'int8' if serve_est['quant_adapters'] else 'f32'} "
                     f"({serve_est['adapter_pool_bytes'] // 1024} KiB)"
                     if serve_est.get("n_adapters") else "") + ")")
            if serve_est.get("prefix_cache"):
                print(f"  prefix cache: index metadata "
                      f"{serve_est['prefix_index_bytes'] // 1024} KiB; "
                      f"at {serve_est['expected_hit_rate']:.0%} hit rate "
                      f"~{serve_est['effective_max_streams']} effective "
                      f"stream(s) (shared prefix blocks counted once)")
        if protocol_results is not None:
            for r in protocol_results:
                print(f"protocol [{r['model']}]: {r['states']} states / "
                      f"{r['transitions']} transitions explored to depth "
                      f"{r['depth']} in {r['wall_s']}s "
                      f"({'complete' if r['complete'] else 'TRUNCATED'}"
                      f", {r['violations']} violation(s))")
        if journal_stats is not None and journal_stats.get("sites"):
            print(f"journal contract: {journal_stats['kinds_emitted']} "
                  f"event kind(s) across {journal_stats['sites']} "
                  f"emission site(s) "
                  f"(+{journal_stats['dynamic_sites']} dynamic), "
                  f"registry coverage "
                  f"{journal_stats['coverage']:.0%} of "
                  f"{journal_stats['kinds_known']} declared kind(s)")
        if journal_stats is not None:
            for jf, st in (journal_stats.get("audited") or {}).items():
                print(f"journal audit [{jf}]: {st['records']} record(s)"
                      + (f", {st['torn']} torn" if st["torn"] else "")
                      + f", {st['findings']} finding(s)")
        print(f"tadnn check: {summary['errors']} error(s), "
              f"{summary['warnings']} warning(s)")
    return analysis.exit_code(findings, strict=args.strict)


def _zoo_args(p: argparse.ArgumentParser) -> None:
    """The model-zoo arguments of ``tune`` and ``simulate``."""
    p.add_argument("--family", default="gpt2",
                   choices=("mlp", "gpt2", "llama", "moe", "bert", "vit"))
    p.add_argument("--size", default=None,
                   help="model size preset; default per family "
                        "(gpt2: 1p3b, llama: 8b, moe: test, bert: large, "
                        "vit: large); for vit, --seq is the image side; "
                        "for mlp, comma-separated layer widths")
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--precision", default="fp32")


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
                   help="the cohort's export cache dir (export/): workers "
                        "go cache-first on their kernels' build; with "
                        "--elastic the shrink worlds are prewarmed")
    p.add_argument("--smoke", action="store_true",
                   help="clean + one-SIGKILL chaos pair; exit nonzero "
                        "unless resumed losses match bitwise")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_launch)

    p = sub.add_parser("bench", help="collectives microbenchmark "
                                     "(parallel.collectives.bench_sweep)")
    p.add_argument("--ops", default="allreduce,allgather,reduce_scatter")
    p.add_argument("--sizes", default=str(64 * 2**20))
    p.add_argument("--axis", default="data")
    p.add_argument("--device", default="cuda",
                   help="cuda: NCCL, a card a rank; cpu: gloo")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "export",
        help="build the kernel libraries a config's train step (and "
             "--serve engine) launches and store them in the export "
             "cache, so later starts install them instead of running "
             "nvcc; --verify audits live vs stale entries",
    )
    p.add_argument("--family", default="gpt2",
                   choices=("mlp", "gpt2", "llama", "moe", "bert", "vit"))
    p.add_argument("--size", default=None,
                   help="model size preset (default per family)")
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--strategy", default="auto")
    p.add_argument("--precision", default="fp32")
    p.add_argument("--grad-accum", type=int, default=1, dest="grad_accum")
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--loss", default="full", choices=("full", "blockwise"))
    p.add_argument("--preflight", default=None, metavar="FILE",
                   help="export the file's tadnn_export() spec "
                        "({model, loss_fn, sample_batch[, optimizer, "
                        "ad kwargs]}) instead of a --family preset")
    p.add_argument("--serve", action="store_true",
                   help="also export the serving decode + prefill-chunk "
                        "entries (decoder families only)")
    p.add_argument("--worlds", default=None, metavar="N,M,...",
                   help="export the train step for N-process worlds of "
                        "this kind in child processes (the elastic "
                        "launcher's shrink candidates)")
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--cache", default=None,
                   help="export cache dir (default: TADNN_EXPORT_CACHE "
                        "or ~/.cache/tadnn/torch_kernels)")
    p.add_argument("--verify", action="store_true",
                   help="report which cache entries would load on this "
                        "host/version (live) and which are stale")
    p.add_argument("--gc", action="store_true",
                   help="garbage-collect by last-hit age: drop entries "
                        "not hit within --max-age-days, delete their "
                        "payloads and rewrite the index (every cache hit "
                        "refreshes an entry's age)")
    p.add_argument("--max-age-days", type=float, default=30.0,
                   dest="max_age_days", metavar="N",
                   help="--gc retention window in days (default 30)")
    p.add_argument("--slots", type=int, default=None,
                   help="--serve: decode slots")
    p.add_argument("--max-len", type=int, default=None, dest="max_len",
                   help="--serve: max tokens per request")
    p.add_argument("--block-size", type=int, default=None,
                   dest="block_size", help="--serve: KV block size")
    p.add_argument("--prefill-chunk", type=int, default=32,
                   dest="prefill_chunk")
    p.add_argument("--vocab", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="where the step and the engine run (cpu: the "
                        "plain versions, no kernel libraries)")
    p.add_argument("--journal", default=None,
                   help="journal path for export.* events "
                        "(tadnn report renders them)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "fit",
        help="will this model fit? the step run once on fake tensors "
             "(nothing allocated) under a live-storage tracker, per "
             "device; with --strategy search, walks the escalation "
             "ladder and reports every candidate",
    )
    p.add_argument("--family", default="gpt2",
                   choices=("mlp", "gpt2", "llama", "moe", "bert", "vit"))
    p.add_argument("--size", default=None,
                   help="model size preset; default per family "
                        "(gpt2: 1p3b, llama: 8b, moe: test, bert: large, "
                        "vit: large); for vit, --seq is the image side; "
                        "for mlp, comma-separated layer widths")
    p.add_argument("--seq", type=int, default=None,
                   help="sequence length (default 1024); for vit, the "
                        "image side (default 224)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--strategy", default="search")
    p.add_argument("--precision", default="mixed")
    p.add_argument("--loss", default="full", choices=("full", "blockwise"),
                   help="blockwise = vocab-blockwise CE (never "
                        "materializes [B,S,V] logits; big-vocab models "
                        "fit far smaller)")
    p.add_argument("--device", default="cuda",
                   help="device the fake tensors live on (cpu takes the "
                        "plain attention)")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser(
        "tune",
        help="rank candidate parallelism plans for a model-zoo config "
             "with the analytic cost model (tune/); --measure also "
             "builds and times the top-k on the real train step")
    _zoo_args(p)
    p.add_argument("--top-k", type=int, default=3,
                   help="candidates to measure with --measure")
    p.add_argument("--grad-accums", default="1",
                   help="comma-separated grad-accumulation choices to "
                        "include in the search space")
    p.add_argument("--measure", action="store_true",
                   help="build + time the top-k candidates (journaled "
                        "as tune.trial spans)")
    p.add_argument("--no-cache", action="store_true",
                   help="skip the persistent tuning cache "
                        "(~/.cache/tadnn/, TADNN_TUNE_CACHE)")
    p.add_argument("--no-zero1", action="store_true",
                   help="drop the ZeRO-1 optimizer-state-sharding "
                        "variants from the search space (changes the "
                        "cache key)")
    p.add_argument("--topology", default=None, dest="tune_topology",
                   metavar="SPEC",
                   help="rank for this fleet (h100-8, h100-8x4, cpu-8; "
                        "default: the devices of this run); --measure "
                        "times only the candidates these devices hold")
    p.add_argument("--simulate", default=None, metavar="TOPOS",
                   help="run the fleet-scale what-if sweep over these "
                        "comma-separated fleets (e.g. h100-8,h100-8x4) "
                        "instead of tuning — shorthand for `tadnn "
                        "simulate`")
    p.add_argument("--traffic", default=None, help=argparse.SUPPRESS)
    p.add_argument("--slo", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda",
                   help="where --measure runs: cuda (default) or cpu")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser(
        "simulate",
        help="fleet-scale what-if planner: sweep hypothetical GPU fleets "
             "(h100-8, h100-8x4, ...) x parallelism plans and rank the "
             "joint MFU/HBM/serving/survival prediction against an "
             "operator SLO — device-free, runs anywhere")
    p.add_argument("--topology", action="append", default=None,
                   metavar="SPEC",
                   help="fleet to sweep, as <kind>-<cards> or "
                        "<kind>-<cards_per_host>x<hosts> (repeatable, or "
                        "comma-separated; default h100-8; un-sliced "
                        "specs fan out over host counts)")
    _zoo_args(p)
    p.add_argument("--traffic", default=None,
                   help="serving traffic mix, e.g. "
                        "'rate=16,n=64,prompt=128,max_new=128,decode=96"
                        ",jitter=0.5,shared=0,seed=0' (rate in req/s; "
                        "shared = leading prompt tokens common to every "
                        "request, for --prefix-cache)")
    p.add_argument("--slo", default=None,
                   help="SLO spec, e.g. 'tok_s_chip>=40,p99_ms<=2500,"
                        "headroom>=0.1,survival>=0.9'")
    p.add_argument("--grad-accums", default="1,2,4,8",
                   dest="grad_accums",
                   help="comma-separated grad-accumulation choices in "
                        "the training search space")
    p.add_argument("--admissions", default="reserve,optimistic",
                   help="comma-separated admission policies to sweep")
    p.add_argument("--slots", type=int, default=8,
                   help="decode slots per serving replica")
    p.add_argument("--block-size", type=int, default=16,
                   dest="block_size")
    p.add_argument("--max-len", type=int, default=256, dest="max_len")
    p.add_argument("--prefill-chunk", type=int, default=32,
                   dest="prefill_chunk",
                   help="chunked-prefill size (0 = single-shot prefill)")
    p.add_argument("--disaggregate", action="store_true",
                   help="simulate disaggregated prefill/decode serving "
                        "replicas: prefill on its own host, KV blocks "
                        "shipped over the network on multi-host fleets, "
                        "step wall = max(prefill, decode)")
    p.add_argument("--prefix-cache", action="store_true",
                   dest="prefix_cache",
                   help="price cross-request prefix reuse in the replay "
                        "(a real PrefixCache over the virtual pool); "
                        "pair with a shared= term in --traffic, e.g. "
                        "'prompt=128,shared=112' — needs --prefill-chunk")
    p.add_argument("--measured-overlap", type=float, default=None,
                   dest="measured_overlap", metavar="FRAC",
                   help="measured exposed-collective fraction (0..1) "
                        "correcting the training roofline "
                        "(cost.score measured_overlap)")
    p.add_argument("--trace-journal", default=None, dest="trace_journal",
                   metavar="JSONL",
                   help="journal with trace.step records to derive "
                        "--measured-overlap from "
                        "(cost.overlap_from_trace)")
    p.add_argument("--preemption-rate", type=float, default=0.0,
                   dest="preemption_rate",
                   help="preemptions per HOST per hour for the "
                        "restart-budget survival model")
    p.add_argument("--mission-hours", type=float, default=24.0,
                   dest="mission_hours")
    p.add_argument("--top-k", type=int, default=10,
                   help="ranked candidates to keep in the report")
    p.add_argument("--no-cache", action="store_true",
                   help="skip the persistent sweep cache "
                        "(~/.cache/tadnn/, TADNN_TUNE_CACHE)")
    p.add_argument("--journal", default=None,
                   help="journal JSONL to write simulate.* events to")
    p.add_argument("--out", default=None,
                   help="write the full JSON report to this file")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser(
        "monitor",
        help="continuous SLO monitor over a serving journal: rolling "
             "TTFT/ITL/latency windows, slo.breach/slo.recover "
             "incidents with hysteresis, planner drift vs the serve "
             "replay (works offline; no device needed)")
    p.add_argument("journal", help="serving journal JSONL to monitor")
    p.add_argument("--slo", default=None,
                   help='spec over window aggregates, e.g. '
                        '"p99_ms<=2500,ttft_ms<=2000,itl_ms<=100" '
                        "(tune/slo fields; empty = report only)")
    p.add_argument("--window", type=float, default=5.0,
                   help="window width in event-time seconds")
    p.add_argument("--replay", action="store_true",
                   help="deterministically replay the journal from the "
                        "start (the default mode, spelled out)")
    p.add_argument("--follow", action="store_true",
                   help="tail a concurrently-appending journal instead "
                        "of replaying a finished one")
    p.add_argument("--idle-timeout", type=float, default=30.0,
                   dest="idle_timeout",
                   help="--follow: stop after this many seconds with "
                        "no new records")
    p.add_argument("--breach-after", type=int, default=2,
                   dest="breach_after",
                   help="consecutive violating windows before a breach "
                        "incident (hysteresis)")
    p.add_argument("--recover-after", type=int, default=2,
                   dest="recover_after",
                   help="consecutive clean windows before recovery")
    p.add_argument("--warmup-windows", type=int, default=1,
                   dest="warmup_windows",
                   help="leading traffic windows reported but not "
                        "SLO-evaluated (they carry the first calls' "
                        "kernel builds)")
    p.add_argument("--chips", type=int, default=1,
                   help="card count for tok_s_chip evaluation")
    p.add_argument("--drift", default=None,
                   help="a serving bench record (JSON, or its extra "
                        "dict): compare measured throughput against the "
                        "simulate replay's prediction and flag >2x "
                        "planner drift")
    p.add_argument("--incident-journal", default=None,
                   dest="incident_journal",
                   help="append slo.breach/slo.recover/simulate.drift "
                        "events to this JSONL")
    p.add_argument("--out", default=None,
                   help="write the full monitor summary JSON here")
    p.add_argument("--json", action="store_true")
    p.add_argument("--check", action="store_true",
                   help="exit nonzero on any breach or out-of-band "
                        "drift — the CI gate")
    p.set_defaults(fn=cmd_monitor)

    p = sub.add_parser(
        "gateway",
        help="online serving gateway: multi-replica SSE ingress with "
             "prefix-affinity routing and a closed-loop SLO "
             "autoscaler; --smoke replays the chaos scenario twice "
             "and asserts byte-identical journals")
    p.add_argument("--smoke", action="store_true",
                   help="run the virtual-clock chaos autoscale "
                        "scenario (breach → replan → scale → recover) "
                        "twice and verify determinism; exit 1 on any "
                        "failed check")
    p.add_argument("--chaos", action="store_true",
                   help="run the fleet fault scenario (seeded replica "
                        "kill/stall/slow mid-stream) and assert every "
                        "accepted request completes with tokens "
                        "bitwise-identical to a fault-free replay, "
                        "deterministically across two runs")
    p.add_argument("--replicas", type=int, default=2,
                   help="initial fleet size (--chaos default: 4)")
    p.add_argument("--max-replicas", type=int, default=8,
                   dest="max_replicas",
                   help="autoscaler ceiling (smoke: the scale-out "
                        "target under the traffic flip)")
    p.add_argument("--autoscale", action="store_true",
                   help="enable the closed-loop SLO autoscaler")
    p.add_argument("--slo", default="p99_ms<=2500",
                   help="SLO spec the monitor/autoscaler enforce "
                        "(tune/slo grammar, e.g. 'p99_ms<=2500,"
                        "ttft_p99_ms<=1000')")
    p.add_argument("--scale", default="smoke",
                   choices=["smoke", "light", "gentle"],
                   help="chaos scenario size (light = fast variant; "
                        "gentle = no traffic flip)")
    p.add_argument("--journal", default=None,
                   help="journal JSONL path (smoke: run 1's journal; "
                        "--port: the live journal tadnn monitor can "
                        "follow)")
    p.add_argument("--port", type=int, default=0,
                   help="start a real HTTP/SSE ingress on this port "
                        "(POST /v1/generate, GET /healthz)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--slots", type=int, default=4,
                   help="serving slots per replica (--port mode)")
    p.add_argument("--max-len", type=int, default=64, dest="max_len",
                   help="per-replica context length (--port mode)")
    p.add_argument("--rate-limit", type=float, default=None,
                   dest="rate_limit", metavar="R",
                   help="per-tenant sustained requests/s "
                        "(token bucket; default unlimited)")
    p.add_argument("--queue-limit", type=int, default=64,
                   dest="queue_limit",
                   help="per-tenant in-flight cap before 503 "
                        "backpressure")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="--port: where the engines run, cuda (default) "
                        "or cpu (the plain PyTorch path)")
    p.set_defaults(fn=cmd_gateway)

    p = sub.add_parser("profile",
                       help="run a script under torch.profiler")
    p.add_argument("script")
    p.add_argument("--logdir", default="/tmp/tadnn_profile")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the CUDA lane too) or cpu")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "trace",
        help="profile real steps: device-timeline capture with per-step "
             "compute/collective/exposed attribution + measured MFU, "
             "and a measured-vs-modeled collective-bytes crosscheck; "
             "pass a .py script to run it with TADNN_TRACE_EVERY_N "
             "exported",
    )
    p.add_argument("target", nargs="?", default=None,
                   help="training script to instrument (script mode); "
                        "omit to trace a --family config in-process. "
                        "trace options go BEFORE the script; everything "
                        "after it is passed to the script: "
                        "tadnn trace --every 8 train.py -- --steps 100")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.add_argument("--steps", type=int, default=3,
                   help="instrumented steps to capture (config mode)")
    p.add_argument("--every", type=int, default=10,
                   help="script mode: trace every Nth step "
                        "(TADNN_TRACE_EVERY_N)")
    p.add_argument("--logdir", default=None,
                   help="profiler logdir (default: a fresh temp dir)")
    p.add_argument("--journal", default=None,
                   help="journal JSONL to write trace.step / "
                        "trace.collective events to")
    p.add_argument("--json", action="store_true")
    p.add_argument("--family", default="mlp",
                   choices=("mlp", "gpt2", "llama", "moe", "bert", "vit"),
                   help="model to trace in config mode (default: the "
                        "bench mlp)")
    p.add_argument("--size", default=None,
                   help="model size preset; for mlp, comma-separated "
                        "layer widths (default 1024,1024,10)")
    p.add_argument("--seq", type=int, default=None,
                   help="sequence length; for mlp/vit, the input image "
                        "side")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--strategy", default="dp",
                   help="sharding strategy (default dp — the bench "
                        "config, which has collectives on >1 device)")
    p.add_argument("--precision", default="fp32")
    p.add_argument("--device", default="cuda",
                   help="config mode: where the steps run, cuda "
                        "(default) or cpu (the plain PyTorch path)")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "report",
        help="summarize a run's journal + metrics JSONL: compiles/"
             "recompiles, goodput breakdown, expected + measured comm "
             "bytes, trace attribution, incidents (works offline; no "
             "accelerator needed)",
    )
    p.add_argument("target",
                   help="run directory (searched for journal.merged."
                        "jsonl / journal.jsonl / metrics.jsonl) or a "
                        "journal file path")
    p.add_argument("--metrics", default=None,
                   help="explicit MetricsLogger JSONL path")
    p.add_argument("--json", action="store_true")
    p.add_argument("--check", action="store_true",
                   help="bench freshness guard: exit nonzero when the "
                        "latest BENCH_r*.json is stale-marked/missing "
                        "or its headline regressed >10%% vs "
                        "BENCH_LAST_GOOD.json")
    p.add_argument("--bench", default=None,
                   help="explicit bench record path for --check "
                        "(default: newest BENCH_r*.json in target)")
    p.add_argument("--last-good", default=None, dest="last_good",
                   help="explicit BENCH_LAST_GOOD.json path for --check")
    p.add_argument("--merge", action="store_true",
                   help="merge per-host journals in the target directory "
                        "into journal.merged.jsonl before reporting")
    p.add_argument("--check-simulate", action="store_true",
                   dest="check_simulate",
                   help="crosscheck the simulator against reality: "
                        "replay the newest SERVE_BENCH record's config "
                        "through the what-if serve replay and fail when "
                        "prediction and measurement disagree by >2x")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser(
        "check",
        help="static analyzer: source and async lint over this package, "
             "serving capacity (--serving), protocol model check "
             "(--protocol), journal contract (--journal); exit 1 on "
             "errors, with --strict also on warnings",
    )
    p.add_argument("paths", nargs="*",
                   help="files/dirs to source-lint (default: this "
                        "package)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--strict", action="store_true",
                   help="warnings also fail (exit 1)")
    p.add_argument("--rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--preflight", default=None, metavar="FILE",
                   help="python file defining tadnn_check() -> dict with "
                        "keys among plan/abstract_params/param_specs/"
                        "batch_spec/degrees/strategy/fn/args/static_args/"
                        "budget; runs plan + graph + mem + dtype lint "
                        "on it")
    p.add_argument("--no-source", action="store_true",
                   help="skip the source lint")
    p.add_argument("--memory", action="store_true",
                   help="trace a model-zoo config (--family et al.) and "
                        "predict its per-device peak memory against "
                        "--budget (ML001 error when it would OOM)")
    p.add_argument("--budget", default=None,
                   help="HBM budget for --memory and --serving, e.g. "
                        "'16GiB' (default: the detected card's ChipSpec)")
    p.add_argument("--headroom", type=float, default=None,
                   help="warn when the predicted peak is within this "
                        "fraction of the budget (default 0.1)")
    p.add_argument("--no-compiled", action="store_true",
                   help="skip the measured cross-check (the step run "
                        "once on fake tensors: compile_report)")
    p.add_argument("--ignore", action="append", default=[],
                   metavar="CODE",
                   help="suppress findings with this rule code "
                        "(repeatable) — the analog of "
                        "'# tadnn: lint-ok(CODE)'")
    p.add_argument("--pl005-bytes", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--family", default="mlp",
                   choices=("mlp", "gpt2", "llama", "moe", "bert", "vit"),
                   help="model for --serving")
    p.add_argument("--size", default=None,
                   help="model size preset; for mlp, comma-separated "
                        "layer widths (default 1024,1024,10)")
    p.add_argument("--seq", type=int, default=None,
                   help="sequence length; for mlp/vit, the input image "
                        "side (mlp default 28)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--strategy", default="fsdp",
                   help="sharding strategy for --memory (default fsdp)")
    p.add_argument("--precision", default="fp32")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="device the traces' fake tensors live on "
                        "(--memory, --trace-serve; nothing is allocated "
                        "for --memory); cpu takes the plain attention")
    p.add_argument("--serving", action="store_true",
                   help="serving capacity lint (analysis/serve_lint): "
                        "predict max concurrent KV streams under "
                        "--budget for --family/--size; ML004/ML005")
    p.add_argument("--serve-streams", type=int, default=None,
                   dest="serve_streams",
                   help="requested concurrency (fewer fitting = ML005)")
    p.add_argument("--serve-block-size", type=int, default=16,
                   dest="serve_block_size")
    p.add_argument("--serve-max-len", type=int, default=None,
                   dest="serve_max_len",
                   help="tokens per stream (default: --seq or 256)")
    p.add_argument("--serve-quant-kv", action="store_true",
                   dest="serve_quant_kv", help="int8 KV pool")
    p.add_argument("--serve-attention-impl", default="paged",
                   choices=("paged", "dense"),
                   dest="serve_attention_impl",
                   help="decode path to budget: dense charges the "
                        "per-step gather workspace, paged charges 0")
    p.add_argument("--serve-adapters", type=int, default=None,
                   dest="serve_adapters",
                   help="size the multi-tenant LoRA adapter pool "
                        "(N tenants + identity slot 0); ML006 when it "
                        "alone pushes streams to zero")
    p.add_argument("--serve-adapter-rank", type=int, default=8,
                   dest="serve_adapter_rank")
    p.add_argument("--serve-quant-adapters", action="store_true",
                   dest="serve_quant_adapters",
                   help="int8 adapter factors (~quarter the pool)")
    p.add_argument("--serve-tp", type=int, default=1, dest="serve_tp",
                   metavar="N",
                   help="budget the serving estimate per TP shard "
                        "(degrees={'tensor': N})")
    p.add_argument("--serve-prefix-cache", action="store_true",
                   dest="serve_prefix_cache",
                   help="charge the prefix-reuse radix index metadata "
                        "and report effective concurrency")
    p.add_argument("--serve-prefix-hit-rate", type=float, default=0.0,
                   dest="serve_prefix_hit_rate", metavar="FRAC",
                   help="expected fraction [0,1) of prompt tokens served "
                        "from the prefix cache")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 for --memory: shard optimizer moments "
                        "over the data axis (the per-chip optimizer row "
                        "drops ~DP-fold)")
    p.add_argument("--trace-serve", action="store_true",
                   dest="trace_serve",
                   help="with --serving: build a ServeEngine on the "
                        "family config and run graph + dtype lint over "
                        "its decode/prefill steps traced on fake tensors")
    p.add_argument("--protocol", action="store_true",
                   help="explicit-state model check of the serving "
                        "control plane (allocator / scheduler / prefix "
                        "cache / gateway): BFS over all event "
                        "interleavings at --scope, PC0xx findings with "
                        "minimized replayable counterexamples")
    p.add_argument("--scope", type=int, default=1,
                   help="protocol small-scope level (default 1: 2 "
                        "replicas, 3 requests, 4+ blocks; 2 widens "
                        "requests/windows — slower, exponentially "
                        "larger space)")
    p.add_argument("--counterexample-dir", default=None, metavar="DIR",
                   dest="counterexample_dir",
                   help="write minimized counterexamples as replayable "
                        "JSON event scripts into DIR (replay via "
                        "analysis.model_check.replay_script)")
    p.add_argument("--journal", action="store_true",
                   help="journal telemetry contract lint (JL00x); with "
                        "--rules, print the registry as a markdown "
                        "event reference instead")
    p.add_argument("--journal-file", action="append", default=None,
                   metavar="FILE", dest="journal_file",
                   help="audit a JSONL journal record-by-record against "
                        "the event schema registry (repeatable)")
    p.set_defaults(fn=cmd_check)

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
