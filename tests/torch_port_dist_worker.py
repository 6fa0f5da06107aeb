"""One rank of the PyTorch port's multi-process tests on the CPU (gloo).

Launched by ``tests/test_torch_port_distributed.py``, one process a
rank::

    python tests/torch_port_dist_worker.py <rank> <world> <init_file> \
        <job.pt> <out.pt>

``job.pt`` (``torch.save``) holds the model config's keyword arguments,
the starting ``state_dict``, the batches and the runs, each a name and
its ``AutoDistribute`` options.  In one gloo group this rank runs every
run in turn (a fresh model from the same weights each time) and the
port's collectives over the mesh's named axes; rank 0 writes
``out.pt``: per run the step losses, the tokens the step counted, the
plan and its journal events, the local shapes of the parameters, the
full final parameters (gathered) and, for a run marked ``inspect``, the
eval loss and greedy tokens of the trained state; and the collectives'
results of every rank.  A run marked ``lora`` freezes the base, puts
``job["lora"]``'s factors on it (``job["lora_spec"]``) and trains them
under ``lora_optimizer``.  A run may name a ``mesh`` (a degrees
mapping: the hybrid meshes, a data axis beside fsdp or tensor).

A run marked ``inspect`` also records ``ad(state, prompt)``, the
forward on every rank.  In the world of 2 the job also holds
``resnet``: ResNet18Thin (fp32) from its weights and running statistics,
``sgd`` with momentum and ``softmax_xent_loss_mutable`` under each of
its runs' strategies, recording the losses, the final parameters and
running statistics, and ``ad(state, x)`` with the running statistics
and with the batch's, and with the gathered parameters as a bare
mapping; a run marked ``reshard`` saves its state with a
``ShardedCheckpoint`` and restores it into a fresh ``dp`` state in the
same group (the buffers whole on every rank), recording whether every
leaf came back bitwise.

In the worlds of 2 and 4 the job also holds ``moe``: MoE ``test`` (fp32)
from its weights under the expert strategies (``ep``, ``ep_fsdp``,
``ep_tp``, a run's ``mesh`` and ``clip``), ``moe_next_token_loss``,
recording what a GPT-2 run records plus each expert bank's placements,
the expert exchange's launches in one step and, for a run marked
``inspect``, the eval loss, ``ad(state, prompt)`` and the routed greedy
tokens; a run marked ``reshard`` saves its state with a
``ShardedCheckpoint``, and once the group is down rank 0 restores it on
one process, recording whether every leaf came back bitwise.  Both
worlds also run ``moe_ffn_sharded`` on the global inputs of
``job["moe_ffn"]`` (expert 2, and data 2 x expert 2 on 4 ranks).

In the world of 4 the job also holds ``reshard``: the resharding chain
of ``training/shards.py`` — a ``ShardedCheckpoint`` step written under
dp on 4 ranks restores under fsdp on 2 (ranks 0-1 in a new group of
their own), is written again, restores under dp + ZeRO-1 on 4 (a new
group of all 4), is written again and restores on one process (rank 0,
no group); rank 0 records whether each hop's state (parameters and the
Adam moments, gathered) equals the first bitwise — and
``hsdp_divergence``: the Trainer's divergence check on a data2 x fsdp2
state, healthy and with one data replica's shard perturbed.  Imports
torch and the port only.
"""

import sys
from pathlib import Path

import torch


def _optimizer(clip):
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        adamw,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training.optim import (
        chain,
        clip_by_global_norm,
    )

    return chain(clip_by_global_norm(clip), adamw(1e-3)) if clip else (
        adamw(1e-3))


def _run(job, run):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        DecoderLM,
        TransformerConfig,
        next_token_loss,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.models.transformer_core import (
        gathered,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.obs import (
        journal,
    )

    model = DecoderLM(TransformerConfig(**job["cfg"]))
    model.load_state_dict(job["state_dict"])
    optimizer, loss_fn = _optimizer(run.get("clip")), next_token_loss
    if run.get("lora"):
        # the base frozen, JAX's initial factors on it
        from torch_automatic_distributed_neural_network_tpu_torch.training.lora import (
            apply_lora,
            lora_loss,
            lora_optimizer,
        )

        apply_lora(model, job["lora_spec"], job["lora"])
        optimizer = lora_optimizer(optimizer)
        loss_fn = lora_loss(next_token_loss, job["lora_spec"])
    ad = AutoDistribute(model, optimizer=optimizer,
                        loss_fn=loss_fn, device="cpu",
                        strategy=run["strategy"], zero1=run.get("zero1", False),
                        grad_accum=run.get("grad_accum", 1),
                        mesh=run.get("mesh"))
    with journal.as_default(journal.Journal(host0_only=False)) as j:
        state = ad.init(None, job["batches"][0])
    events = {name: [r for r in j.records if r["name"] == name]
              for name in ("plan", "comms.estimate", "plan.zero1")}
    local = {n: tuple((p.to_local() if hasattr(p, "to_local") else p).shape)
             for n, p in model.named_parameters()}
    losses, tokens = [], []
    for batch in job["batches"]:
        state, metrics = ad.step(state, batch)
        losses.append(float(metrics["loss"]))
        tokens.append(float(metrics["tokens"]))
    with torch.no_grad():
        params = {n: gathered(p).detach().clone()
                  for n, p in state.params.items()}
    out = {"losses": losses, "tokens": tokens, "strategy": ad.plan.strategy,
           "degrees": ad.plan.degrees, "zero1": ad.plan.zero1,
           "remat": ad.plan.remat, "local_shapes": local, "params": params,
           "events": events}
    if run.get("inspect"):
        # the trained state's eval loss on the global batch, greedy
        # tokens from the weights gathered on every rank, and the forward
        out["eval_loss"] = float(ad.eval_step(state, job["batches"][0])["loss"])
        out["generated"] = ad.generate(state, job["prompt"], max_new_tokens=4)
        out["logits"] = ad(state, job["prompt"])
    return out


def _resnet_ad(rj, strategy):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        sgd,
        softmax_xent_loss_mutable,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.models.resnet import (
        ResNet,
        ResNetConfig,
    )

    model = ResNet(ResNetConfig(**rj["cfg"]))
    model.load_state_dict(rj["state_dict"])
    return AutoDistribute(model, optimizer=sgd(rj["lr"], momentum=0.9),
                          loss_fn=softmax_xent_loss_mutable, device="cpu",
                          strategy=strategy)


def _resnet_run(rj, run, out_dir):
    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    ad = _resnet_ad(rj, run["strategy"])
    state = ad.init(None, rj["batches"][0])
    losses = []
    for batch in rj["batches"]:
        state, metrics = ad.step(state, batch)
        losses.append(float(metrics["loss"]))
    full = _full_state(state)
    out = {"losses": losses, "strategy": ad.plan.strategy,
           "degrees": ad.plan.degrees, "remat": ad.plan.remat,
           "params": {k[len("params/"):]: v for k, v in full.items()
                      if k.startswith("params/")},
           "model_state": {n: t.clone() for n, t in state.model_state.items()},
           "call": ad(state, rj["x"], train=False),
           "call_train": ad(state, rj["x"], train=True)}
    # whole tensors that are not the wrapped module's: an unwrapped copy
    out["call_gathered"] = ad(out["params"], rj["x"], train=False)
    if run.get("reshard"):
        directory = f"{out_dir}/resnet_{run['name']}"
        with ShardedCheckpoint(directory) as ck:
            ck.save(len(losses), state)
            ck.wait()
        dist.barrier()  # per-process saves: every marker has landed
        fresh = _resnet_ad(rj, "dp")
        fstate = ShardedCheckpoint(directory).restore(
            fresh.init(None, rj["batches"][0]))
        fresh.adopt_state(fstate)
        out["resharded"] = _equal(_full_state(fstate), full)
    return out


def _moe_ad(mj, run):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        moe_next_token_loss,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        MoEConfig,
        MoELM,
    )

    model = MoELM(MoEConfig(**mj["cfg"]))
    model.load_state_dict(mj["state_dict"])
    return AutoDistribute(model, optimizer=_optimizer(run.get("clip")),
                          loss_fn=moe_next_token_loss, device="cpu",
                          strategy=run["strategy"], mesh=run.get("mesh"),
                          **run.get("kw", {}))


def _moe_run(mj, run, out_dir):
    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch.parallel.expert import (
        exchange,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    ad = _moe_ad(mj, run)
    state = ad.init(None, mj["batches"][0])
    model = ad.model
    local = {n: tuple((p.to_local() if hasattr(p, "to_local") else p).shape)
             for n, p in model.named_parameters()}
    placements = {n: [(axis, pl.dim if pl.is_shard() else None)
                      for axis, pl in zip(p.device_mesh.mesh_dim_names,
                                          p.placements)]
                  for n, p in model.named_parameters() if "experts_" in n}
    losses, exchanges = [], []
    for batch in mj["batches"]:
        before = exchange.launches
        state, metrics = ad.step(state, batch)
        exchanges.append(exchange.launches - before)
        losses.append(float(metrics["loss"]))
    full = _full_state(state)
    out = {"losses": losses, "strategy": ad.plan.strategy,
           "degrees": ad.plan.degrees, "remat": ad.plan.remat,
           "local_shapes": local, "placements": placements,
           "exchanges": exchanges,
           "params": {k[len("params/"):]: v for k, v in full.items()
                      if k.startswith("params/")}}
    if run.get("inspect"):
        out["eval_loss"] = float(ad.eval_step(state, mj["batches"][0])["loss"])
        out["logits"] = ad(state, mj["prompt"])[0]
        out["generated"] = ad.generate(state, mj["prompt"], max_new_tokens=4,
                                       cache_dtype=torch.float32,
                                       moe_decode="routed")
    if run.get("reshard"):
        directory = f"{out_dir}/moe_{run['name']}"
        with ShardedCheckpoint(directory) as ck:
            ck.save(len(losses), state)
            ck.wait()
        dist.barrier()  # per-process saves: every marker has landed
        out["saved"] = (directory, full)
    return out


def _moe_restore_alone(mj, run, saved):
    """A ``reshard`` run's checkpoint restored on one process (no group):
    whether every leaf equals the saved state's, gathered, bitwise."""
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    directory, full = saved
    ad = _moe_ad(mj, dict(run, strategy="auto", mesh=None))
    state = ShardedCheckpoint(directory).restore(
        ad.init(None, mj["batches"][0]))
    ad.adopt_state(state)
    return _equal(_full_state(state), full)


def _moe_ffn_sharded(mf, world):
    from torch_automatic_distributed_neural_network_tpu_torch import topology
    from torch_automatic_distributed_neural_network_tpu_torch.parallel.expert import (
        moe_ffn_sharded,
    )

    mesh = (topology.build_mesh(expert=2) if world == 2
            else topology.build_mesh(data=2, expert=2))
    y, metrics = moe_ffn_sharded(*(torch.from_numpy(mf[k]) for k in (
        "x", "logits", "w_up", "w_down")), mesh=mesh, top_k=2)
    return {"y": y, **{k: float(v) for k, v in metrics.items()}}


def _collectives(rank, world):
    from torch_automatic_distributed_neural_network_tpu_torch import topology
    from torch_automatic_distributed_neural_network_tpu_torch.parallel import (
        collectives as C,
    )

    mesh = topology.build_mesh(data=world)
    x = torch.arange(world * 6, dtype=torch.float32).reshape(world * 2, 3)
    x = x + 100.0 * rank
    return {
        "allreduce": C.allreduce(x, "data", mesh=mesh),
        "allmean": C.allmean(x, ("data", "tensor"), mesh=mesh),
        "allgather": C.allgather(x, "data", mesh=mesh, gather_dim=1),
        "allgather_stacked": C.allgather(x, "data", mesh=mesh, tiled=False),
        "reduce_scatter": C.reduce_scatter(x, "data", mesh=mesh),
        "broadcast": C.broadcast(x, "data", mesh=mesh, root=world - 1),
        "all_to_all": C.all_to_all(x, "data", mesh=mesh, split_dim=0,
                                   concat_dim=1),
        "ppermute_ring": C.ppermute_ring(x, "data", mesh=mesh, shift=1),
        "axis_index": C.axis_index("data", mesh=mesh),
    }


def _flash_refusals(world):
    """The flash entry points handed a ``DTensor``: each error message
    (the kernels take a plan's local tensors, never its global view)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from torch_automatic_distributed_neural_network_tpu_torch import topology
    from torch_automatic_distributed_neural_network_tpu_torch.ops import (
        flash_attention as fa,
    )

    mesh = topology.build_mesh(data=world)
    q = distribute_tensor(torch.zeros(1, 8, 2, 32), mesh["data"],
                          [Replicate()])
    lse = torch.zeros(1, 2, 8)
    calls = (lambda: fa.flash_attention(q, q, q, causal=True),
             lambda: fa.flash_forward(q, q, q),
             lambda: fa.flash_dkv(q, q, q, q, lse, lse),
             lambda: fa.flash_dq(q.to_local(), q, q, q.to_local(), lse, lse))
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except TypeError as e:
            out.append(str(e))
    return out


def _fresh_ad(job, strategy="dp", zero1=False, mesh=None):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        DecoderLM,
        TransformerConfig,
        next_token_loss,
    )

    model = DecoderLM(TransformerConfig(**job["cfg"]))
    model.load_state_dict(job["state_dict"])
    return AutoDistribute(model, optimizer=_optimizer(None),
                          loss_fn=next_token_loss, device="cpu",
                          strategy=strategy, zero1=zero1, mesh=mesh)


def _full_state(state):
    """Every leaf of the state, whole (a sharded one gathered)."""
    from torch_automatic_distributed_neural_network_tpu_torch.models.transformer_core import (
        gathered,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        resilience,
    )

    return {k: gathered(resilience.as_tensor(v)).detach().clone()
            for k, v in resilience.flatten_state(state).items()}


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def _reshard(job, rank, init_file, out_dir):
    """dp/4 -> fsdp/2 -> dp+zero1/4 -> one process (module docstring);
    rank 0's verdict per hop."""
    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch import topology
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    batches = job["batches"]
    dirs = [f"{out_dir}/reshard{i}" for i in range(3)]

    def restored(ad, directory):
        state = ad.init(None, batches[0])
        state = ShardedCheckpoint(directory).restore(state)
        ad.adopt_state(state)
        return state

    def save(state, directory):
        with ShardedCheckpoint(directory) as ck:
            ck.save(2, state)
            ck.wait()
        dist.barrier()  # per-process saves: every marker has landed

    ad = _fresh_ad(job)
    state = ad.init(None, batches[0])
    for b in batches[:2]:
        state, _ = ad.step(state, b)
    want = _full_state(state)
    save(state, dirs[0])
    out = {}
    dist.destroy_process_group()
    if rank < 2:
        topology.initialize_distributed(
            backend="gloo", init_method=f"file://{init_file}.fsdp2",
            world_size=2, rank=rank)
        state = restored(_fresh_ad(job, "fsdp"), dirs[0])
        out["fsdp/2"] = _equal(_full_state(state), want)
        save(state, dirs[1])
        dist.destroy_process_group()
    topology.initialize_distributed(
        backend="gloo", init_method=f"file://{init_file}.zero1",
        world_size=4, rank=rank)
    state = restored(_fresh_ad(job, "dp", zero1=True), dirs[1])
    out["dp+zero1/4"] = _equal(_full_state(state), want)
    save(state, dirs[2])
    dist.destroy_process_group()
    if rank == 0:
        state = restored(_fresh_ad(job), dirs[2])
        out["one process"] = _equal(_full_state(state), want)
    return out


def _hsdp_divergence(job, rank):
    """The divergence check on data2 x fsdp2: healthy, then with the
    shard of one replica (data coordinate 1) moved."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        Trainer,
        TrainerConfig,
    )

    ad = _fresh_ad(job, mesh={"data": 2, "fsdp": 2})
    state = ad.init(None, job["batches"][0])
    state, _ = ad.step(state, job["batches"][0])
    trainer = Trainer(ad, TrainerConfig(divergence_every=1))
    out = {}
    for case in ("healthy", "perturbed"):
        if case == "perturbed" and ad.plan.mesh.get_local_rank("data") == 1:
            with torch.no_grad():
                p = state.params["layers.0.mlp.up_proj.weight"]
                (p.to_local() if hasattr(p, "to_local") else p).add_(1e-3)
        try:
            trainer._guard_divergence(state, 1)
            out[case] = None
        except RuntimeError as e:
            out[case] = str(e)
    return out


def _lm_ad(sec, run):
    """A decoder LM (``sec["cfg"]``, overridden by the run's ``cfg``) from
    the section's weights, under the run's ``AutoDistribute`` options."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        DecoderLM,
        TransformerConfig,
        next_token_loss,
    )

    model = DecoderLM(TransformerConfig(**{**sec["cfg"],
                                           **run.get("cfg", {})}))
    model.load_state_dict(sec["state_dicts"][run.get("weights", "base")])
    return AutoDistribute(model, optimizer=_optimizer(run.get("clip")),
                          loss_fn=next_token_loss, device="cpu",
                          **run.get("kw", {}))


def _lm_run(sec, run, out_dir):
    """One pipeline or context-parallel run (module docstring of the
    test files): the losses, the gathered parameters, the plan, what
    each rank holds, the embedding's first-step gradient on every rank,
    and on request the eval loss, ``ad(state, x)``, greedy tokens and a
    ``ShardedCheckpoint`` of the trained state."""
    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch.parallel import (
        collectives,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    ad = _lm_ad(sec, run)
    batches = run.get("batches", sec["batches"])
    state = ad.init(None, batches[0])
    held = sorted(n for n, p in ad.model.named_parameters()
                  if not p.is_meta)
    grads = {}
    embed = ad.model.embed
    def keep(p):
        g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
        grads.setdefault("embed", g.detach().clone())

    handle = embed.register_post_accumulate_grad_hook(keep)
    losses, tokens = [], []
    collectives.reset_traffic()
    for batch in batches:
        state, metrics = ad.step(state, batch)
        losses.append(float(metrics["loss"]))
        tokens.append(float(metrics.get("tokens", float("nan"))))
    handle.remove()
    traffic = dict(collectives.traffic)
    params = ad.gathered_params(state)
    out = {"losses": losses, "tokens": tokens, "strategy": ad.plan.strategy,
           "degrees": ad.plan.degrees, "remat": ad.plan.remat,
           "stages": ad.plan.stages, "params": params, "traffic": traffic}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {"held": held,
                                      "embed_grad": grads.get("embed")})
    out["ranks"] = everyone
    if run.get("inspect"):
        out["eval_loss"] = float(ad.eval_step(state, batches[0])["loss"])
        out["logits"] = ad(state, sec["prompt"])
        out["generated"] = ad.generate(state, sec["prompt"],
                                       max_new_tokens=4,
                                       cache_dtype=torch.float32)
    if run.get("reshard"):
        directory = f"{out_dir}/lm_{run['name']}"
        with ShardedCheckpoint(directory) as ck:
            ck.save(len(losses), state)
            ck.wait()
        dist.barrier()  # per-process saves: every marker has landed
        full = {k: v for k, v in _full_state_of(ad, state).items()}
        # the same layout: a fresh state of the same plan, restored
        fresh = _lm_ad(sec, run)
        fstate = ShardedCheckpoint(directory).restore(
            fresh.init(None, sec["batches"][0]))
        fresh.adopt_state(fstate)
        out["same_layout"] = _equal(_full_state_of(fresh, fstate), full)
        # the coordinated DCP format: each leaf from the rank that holds
        # it, restored into a fresh state of the same plan
        from torch_automatic_distributed_neural_network_tpu_torch.training.checkpoint import (
            CheckpointManager,
        )

        dcp_dir = f"{out_dir}/dcp_{run['name']}"
        manager = CheckpointManager(dcp_dir, device="cpu")
        manager.save(len(losses), state)
        manager.wait()
        fresh = _lm_ad(sec, run)
        fstate = CheckpointManager(dcp_dir, device="cpu").restore(
            fresh.init(None, batches[0]))
        fresh.adopt_state(fstate)
        out["dcp_same_layout"] = _equal(_full_state_of(fresh, fstate), full)
        out["saved"] = (directory, dcp_dir, full)
    return out


def _full_state_of(ad, state):
    """Every leaf of the state whole, a pipeline's stages gathered: the
    parameters and the Adam moments by name (``gathered_params``), the
    rest as it is."""
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        resilience,
    )

    out = {}
    for path, leaf in resilience.flatten_state(state).items():
        name = path.rsplit("/", 1)[-1]
        t = resilience.as_tensor(leaf)
        if name in state.params:
            t = ad.gathered_params({name: t})[name]
        out[path] = t.detach().clone()
    return out


def _lm_restore_alone(sec, run, saved):
    """A run's checkpoints, sharded and DCP, each restored on one process
    (no group): whether every leaf equals the saved state's, gathered,
    bitwise."""
    from torch_automatic_distributed_neural_network_tpu_torch.training.shards import (
        ShardedCheckpoint,
    )

    from torch_automatic_distributed_neural_network_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )

    directory, dcp_dir, full = saved
    out = {}
    for name, manager in (("sharded", ShardedCheckpoint(directory)),
                          ("dcp", CheckpointManager(dcp_dir, device="cpu"))):
        ad = _lm_ad(sec, dict(run, kw={}))
        state = manager.restore(ad.init(None, sec["batches"][0]))
        ad.adopt_state(state)
        out[name] = _equal(_full_state_of(ad, state), full)
    return out


def _refusals(sec):
    """JAX's refusals under a pipe axis, made by ``AutoDistribute`` in a
    group of 2: each case's error message."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        blockwise_next_token_loss,
        softmax_xent_loss_mutable,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        MoE,
        ResNet18Thin,
    )

    def gpt(**kw):
        run = {"kw": kw.pop("kw"), "cfg": kw}
        return _lm_ad(sec, dict(run, weights="base")) if not kw else (
            _lm_ad(sec, dict(run, weights="deep")))

    cases = {
        "stateful": lambda: AutoDistribute(
            ResNet18Thin(), loss_fn=softmax_xent_loss_mutable, device="cpu",
            pipeline_stages=2).build_plan(),
        "blockwise": lambda: AutoDistribute(
            gpt(kw={}).model, loss_fn=blockwise_next_token_loss(16),
            device="cpu", pipeline_stages=2).build_plan(),
        "microbatches": lambda: gpt(kw=dict(
            pipeline_stages=2, microbatches=3)).init(None, sec["batches"][0]),
        "virtual": lambda: gpt(kw=dict(
            pipeline_stages=2, pipeline_virtual=2)).build_plan(),
        "interleaved_m": lambda: gpt(n_layers=4, kw=dict(
            pipeline_stages=2, microbatches=3,
            pipeline_schedule="interleaved", pipeline_virtual=2)).build_plan(),
        "layers": lambda: gpt(kw=dict(
            pipeline_stages=2, microbatches=4,
            pipeline_schedule="interleaved", pipeline_virtual=2)).build_plan(),
        "seq": lambda: gpt(kw=dict(pipeline_stages=2, seq_parallel=2)),
        "ep": lambda: AutoDistribute(
            MoE("test", vocab_size=256), device="cpu", strategy="ep",
            pipeline_stages=2).build_plan(),
    }
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except (ValueError, TypeError) as e:
            out[name] = str(e)
    return out


def _cp_ops(cj, world):
    """``ring_attention`` and ``ulysses_attention`` over a seq axis of
    the whole world on the global q, k, v of ``cj["ops"]``: each rank's
    output slice and its q, k, v gradients of ``sum(o * w)``, gathered;
    and the attention dispatcher's refusals under the axis."""
    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch import topology
    from torch_automatic_distributed_neural_network_tpu_torch.ops.attention import (
        attention,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.parallel import (
        context as pctx,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.parallel.ring import (
        ring_attention,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.parallel.ulysses import (
        ulysses_attention,
    )

    mesh = topology.build_mesh(seq=world)
    group, r = mesh.get_group("seq"), mesh.get_local_rank("seq")
    out = {}
    for case in cj["ops"]:
        fn = ring_attention if case["impl"] == "ring" else ulysses_attention
        ts = [torch.from_numpy(case[k]) for k in ("q", "k", "v", "w")]
        width = ts[0].shape[1] // world
        q, k, v, w = (t[:, r * width:(r + 1) * width].clone() for t in ts)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = fn(q, k, v, causal=case["causal"], group=group)
        (o * w).sum().backward()
        got = [None] * world
        dist.all_gather_object(got, [t.detach() for t in
                                     (o, q.grad, k.grad, v.grad)])
        out[case["name"]] = [torch.cat(parts, dim=1)
                             for parts in zip(*got)]
    # the differentiable moves: one ring step and the gather of slices,
    # each rank's value and gradient of sum(out * (rank + 1))
    from torch_automatic_distributed_neural_network_tpu_torch.parallel.collectives import (
        gather_slices,
        ppermute_ring,
    )

    moves = {}
    for name, fn in (("ppermute_ring",
                      lambda t: ppermute_ring(t, "seq", mesh=mesh)),
                     ("gather_slices", lambda t: gather_slices(t, group))):
        x = (torch.arange(6.0).reshape(1, 3, 2) + 10 * r).requires_grad_()
        y = fn(x)
        (y * (r + 1)).sum().backward()
        got = [None] * world
        dist.all_gather_object(got, (y.detach(), x.grad))
        moves[name] = got
    out["moves"] = moves
    refusals = {}
    ctx = pctx.ParallelContext(mesh=mesh)
    x = torch.zeros(1, 8, 2, 16)
    with pctx.use(ctx):
        for name, call in (
                ("mask", lambda: attention(x, x, x, causal=True,
                                           mask=torch.ones(1, 1, 8, 8,
                                                           dtype=torch.bool),
                                           impl="ring")),
                ("window", lambda: attention(x, x, x, causal=True, window=4,
                                             impl="ulysses")),
                ("flash", lambda: attention(x, x, x, causal=True,
                                            impl="flash"))):
            try:
                call()
                refusals[name] = None
            except NotImplementedError as e:
                refusals[name] = str(e)
    out["refusals"] = refusals
    return out


def main(rank, world, init_file, job_path, out_path):
    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch import topology

    torch.set_num_threads(1)
    topology.initialize_distributed(
        backend="gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank)
    job = torch.load(job_path, weights_only=False)
    out = {"topology": topology.detect(),
           "runs": {run["name"]: _run(job, run)
                    for run in job.get("runs", ())}}
    for key in ("pipeline", "cp"):
        if job.get(key):
            sec = job[key]
            out[key] = {run["name"]: _lm_run(sec, run,
                                             str(Path(out_path).parent))
                        for run in sec["runs"]}
    if job.get("cp_ops"):
        out["cp_ops"] = _cp_ops(job["cp_ops"], world)
    if job.get("refusals"):
        out["refusals"] = _refusals(job["pipeline"])
    if job.get("resnet"):
        out["resnet"] = {run["name"]: _resnet_run(
            job["resnet"], run, str(Path(out_path).parent))
            for run in job["resnet"]["runs"]}
    if job.get("moe"):
        mj = job["moe"]
        out["moe"] = {run["name"]: _moe_run(
            mj, run, str(Path(out_path).parent)) for run in mj["runs"]}
    if job.get("moe_ffn"):
        out["moe_ffn_sharded"] = _moe_ffn_sharded(job["moe_ffn"], world)
    if job.get("only_lm"):
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            for key in ("pipeline", "cp"):
                for run in job.get(key, {}).get("runs", ()):
                    got = out[key][run["name"]]
                    if "saved" in got:
                        got["resharded"] = _lm_restore_alone(
                            job[key], run, got.pop("saved"))
            torch.save(out, out_path)
        return
    got = _collectives(rank, world)
    gathered = [None] * world
    dist.all_gather_object(gathered, got)
    out["collectives"] = gathered
    out["flash_refusals"] = _flash_refusals(world)
    if job.get("reshard"):
        out["hsdp_divergence"] = _hsdp_divergence(job, rank)
        out["reshard"] = _reshard(job, rank, init_file,
                                  str(Path(out_path).parent))
    else:
        dist.barrier()
        dist.destroy_process_group()
    if rank == 0:
        for run in job.get("moe", {}).get("runs", ()):
            got = out["moe"][run["name"]]
            if "saved" in got:
                got["resharded"] = _moe_restore_alone(
                    job["moe"], run, got.pop("saved"))
        torch.save(out, out_path)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
