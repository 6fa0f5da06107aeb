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
under ``lora_optimizer``.  Imports torch and the port only.
"""

import sys

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
                        grad_accum=run.get("grad_accum", 1))
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
        # the trained state's eval loss on the global batch, and greedy
        # tokens from the weights gathered on every rank
        out["eval_loss"] = float(ad.eval_step(state, job["batches"][0])["loss"])
        out["generated"] = ad.generate(state, job["prompt"], max_new_tokens=4)
    return out


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


def main(rank, world, init_file, job_path, out_path):
    import torch.distributed as dist

    from torch_automatic_distributed_neural_network_tpu_torch import topology

    torch.set_num_threads(1)
    topology.initialize_distributed(
        backend="gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank)
    job = torch.load(job_path, weights_only=False)
    out = {"topology": topology.detect(),
           "runs": {run["name"]: _run(job, run) for run in job["runs"]}}
    got = _collectives(rank, world)
    gathered = [None] * world
    dist.all_gather_object(gathered, got)
    out["collectives"] = gathered
    out["flash_refusals"] = _flash_refusals(world)
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
