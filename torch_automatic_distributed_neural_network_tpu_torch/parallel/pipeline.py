"""Pipeline parallelism over the ``pipe`` axis: the JAX package's
``parallel/pipeline.py`` on ``torch.distributed``.

Each rank of the ``pipe`` group runs one stage: a block of the decoder's
layers (the plan records which stage owns each layer,
``planner.make_plan``).  The embeddings, the final norm and the head
stay whole on every pipe rank, as JAX replicates everything outside the
layer stack; the loss stays outside the pipeline.  ``AutoDistribute``
hands the loss :class:`PipelinedModel` in the model's place, whose
forward runs embed -> the pipelined trunk -> final norm and head, so
every loss of the port works unchanged.

The trunk is a ``torch.autograd.Function``.  Its forward splits this
rank's rows into ``M`` microbatches and runs the schedule's forward
ticks; the last stage's outputs are then broadcast to every pipe rank,
so each computes the head and the loss and the replicated parameters'
gradients come out identical on every pipe rank (never summed over
``pipe``).  Its backward takes the trunk output's cotangent, runs the
schedule's backward, and broadcasts the trunk input's cotangent from
the first stage, so the embedding's gradient (GPT-2's tied ``wte``
takes one from the head as well) is identical everywhere too.  Each
stage's parameter gradients accumulate where autograd puts them; the
step reduces them over ``data`` once, after the whole schedule.

Schedules, in JAX's tick algebra (``T = M V + S - 1`` forward ticks on
``S`` stages, rank ``s``'s ``k``-th chunk execution at tick ``s + k``,
``v = (k // S) % V``, ``m = (k // (S V)) S + k % S``):

- ``cond`` / ``dense``: GPipe.  The forward keeps every microbatch's
  stage graph and the backward runs them in reverse tick order.  JAX's
  two differ only in how its compiled loop treats bubble ticks (skipped
  by ``lax.cond``, or computed and masked); here a bubble tick computes
  nothing under either name, so both run the same schedule;
- ``1f1b``: the forward keeps nothing.  The backward reruns the forward
  wavefront and, one forward and one backward per tick, recomputes each
  chunk from its stashed input and backpropagates it (JAX's
  ``onef_oneb_grads``): live stage inputs are a ring of ``2 S - 1``
  slots whatever ``M`` is;
- ``interleaved``: ``V`` virtual stages a rank, natural layer
  ``(v S + s) C + j`` on stage ``s`` (``C = L / (S V)``), GPipe's
  backward; the bubble shrinks ``V``-fold;
- ``interleaved_1f1b``: both (``onef_oneb_grads_interleaved``: a stash
  ring of ``2 V S - 1``).

Activations cross stage boundaries in their compute dtype with
``batch_isend_irecv`` (``collectives.hops``).  Dropout draws its seeds
per (microbatch, global layer) from the step's generator, so its masks
do not depend on the schedule.  Inside a stage, attention goes through
the port's dispatcher, so on the card each stage runs the flash kernels
(JAX forces einsum attention there only because a Pallas call cannot be
partitioned inside its partial-manual region).
"""

from __future__ import annotations

import torch

from . import collectives

SCHEDULES = ("cond", "dense", "1f1b", "interleaved", "interleaved_1f1b")


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: idle fraction of the schedule."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def check_schedule(n_layers: int, n_stages: int, n_microbatches: int,
                   schedule: str, virtual: int) -> int:
    """JAX ``make_pipelined_apply``'s checks; returns the virtual
    stages a rank runs (1 for a plain schedule)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    interleaved = schedule in ("interleaved", "interleaved_1f1b")
    if interleaved and virtual < 2:
        raise ValueError(
            "schedule='interleaved' needs virtual >= 2 (V=1 is plain "
            "GPipe — use schedule='cond')")
    if not interleaved and virtual > 1:
        raise ValueError(
            f"virtual={virtual} only applies to schedule='interleaved'")
    V = virtual if interleaved else 1
    if n_layers % (n_stages * V):
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"{n_stages} stages x {V} virtual")
    if interleaved and n_microbatches % n_stages:
        raise ValueError(
            f"interleaved schedule needs microbatches % stages == 0; "
            f"got M={n_microbatches}, S={n_stages}")
    return V


def chunk_layers(stage: int, n_layers: int, n_stages: int,
                 virtual: int = 1) -> list[list[int]]:
    """The layer indices of each of ``stage``'s ``virtual`` chunks: chunk
    ``v`` is the ``(v S + stage)``-th run of ``L / (S V)`` layers."""
    c = n_layers // (n_stages * virtual)
    return [list(range((v * n_stages + stage) * c,
                       (v * n_stages + stage + 1) * c))
            for v in range(virtual)]


def stage_of_layer(layer: int, n_layers: int, n_stages: int,
                   virtual: int = 1) -> int:
    """The stage that owns ``layer``."""
    return (layer // (n_layers // (n_stages * virtual))) % n_stages


class Pipeline:
    """One rank's stage of ``model``'s layers over ``mesh``'s ``pipe``
    axis, and the schedule that runs them (the module docstring).
    Calling it is the trunk: ``(x, positions, generator, mask) ->
    features`` for this rank's rows."""

    def __init__(self, model, mesh, *, n_microbatches: int,
                 schedule: str = "cond", virtual: int = 1,
                 remat: bool | None = None):
        cfg = model.cfg
        self.cfg = cfg
        self.group = mesh.get_group("pipe")
        self.S = self.group.size()
        self.stage = mesh.get_local_rank("pipe")
        self.M = n_microbatches
        self.V = check_schedule(cfg.n_layers, self.S, self.M, schedule,
                                virtual)
        self.one_f_one_b = schedule in ("1f1b", "interleaved_1f1b")
        self.remat = cfg.remat if remat is None else remat
        self.chunk_ids = chunk_layers(self.stage, cfg.n_layers, self.S,
                                      self.V)
        self.chunks = [[model.layers[i] for i in ids]
                       for ids in self.chunk_ids]
        # whether this backward reduces the stages' FSDP gradients (off on
        # the accumulation slices before the last)
        self.sync = True

    def _fsdp_layers(self) -> list:
        from torch.distributed.fsdp import FSDPModule

        return [layer for chunk in self.chunks for layer in chunk
                if isinstance(layer, FSDPModule)]

    def hold_fsdp(self) -> None:
        """FSDP2 layers (pipe x fsdp) keep their unsharded gradients
        through the schedule's backward: its chunks recompute inside the
        trunk's backward, where FSDP registers no reduction hooks."""
        for layer in self._fsdp_layers():
            layer.set_is_last_backward(False)
            layer.set_reshard_after_backward(False)
            layer.set_requires_gradient_sync(False)

    def release_fsdp(self) -> None:
        """After the schedule: each FSDP2 layer's post-backward, once,
        reduce-scattering what the microbatches accumulated (as
        ``torch.distributed.pipelining`` does)."""
        from torch.distributed.fsdp import fully_shard

        for layer in self._fsdp_layers():
            layer.set_is_last_backward(True)
            layer.set_reshard_after_backward(True)
            layer.set_requires_gradient_sync(self.sync)
            for group in fully_shard.state(layer)._fsdp_param_groups:
                group.post_backward()

    # -- the tick algebra ------------------------------------------------------

    def _slot(self, k: int) -> tuple[int, int]:
        """(virtual stage, microbatch) of a rank's ``k``-th chunk."""
        S, V = self.S, self.V
        return (k // S) % V, (k // (S * V)) * S + k % S

    def _fwd_at(self, stage: int, t: int):
        """``(v, m)`` of ``stage``'s forward chunk at tick ``t``, or
        None on a bubble tick."""
        k = t - stage
        return self._slot(k) if 0 <= k < self.M * self.V else None

    def _bwd_at(self, stage: int, t: int):
        """``(v, m, k)`` of ``stage``'s backward chunk at tick ``t`` of
        the 1F1B loop (``k``: where its forward stashed the input), or
        None."""
        S, V = self.S, self.V
        j = t - V * S - (S - 1 - stage)
        if not 0 <= j < self.M * V:
            return None
        v = V - 1 - (j // S) % V
        m = (j // (S * V)) * S + j % S
        return v, m, (j // (S * V)) * (S * V) + v * S + j % S

    def _last(self, stage: int, v: int) -> bool:
        """Whether chunk ``v`` of ``stage`` ends the chain."""
        return stage == self.S - 1 and v == self.V - 1

    @staticmethod
    def _first(stage: int, v: int) -> bool:
        return stage == 0 and v == 0

    def _next(self, d: int) -> int:
        return (self.stage + d) % self.S

    # -- a chunk ----------------------------------------------------------------

    def _runner(self, seeds, positions, mask):
        """``run(v, x, m)``: chunk ``v`` of this stage on microbatch
        ``m``'s activation ``x``."""
        from ..models.transformer_core import run_layers

        M = self.M
        pos = positions.chunk(M)
        masks = (None if mask is None else mask.chunk(M)
                 if mask.shape[0] > 1 else [mask] * M)

        def run(v, x, m):
            ids = self.chunk_ids[v]
            layer_seeds = ([None] * len(ids) if seeds is None else
                           [tuple(int(a) for a in seeds[m, i]) for i in ids])
            y, _ = run_layers(self.chunks[v], self.cfg, x, pos[m],
                              layer_seeds, None if masks is None
                              else masks[m], remat_layers=self.remat)
            return y

        return run

    # -- the schedules ----------------------------------------------------------

    def _hop_fwd(self, send, t, like):
        """A forward tick's exchange: this rank's output to the next
        stage; the previous stage's, when it made one for us."""
        prev = self._next(-1)
        got = self._fwd_at(prev, t)
        expect = got is not None and not self._last(prev, got[0])
        return collectives.hops([(send, self._next(1), expect, prev)],
                                like=like, group=self.group)[0]

    def forward_ticks(self, mbs, run, keep: bool):
        """The forward schedule: the last stage's outputs per microbatch
        (None elsewhere) and, when ``keep``, each chunk's (input, output)
        graph by its execution index."""
        S, M, V, s = self.S, self.M, self.V, self.stage
        outputs, records, recv = [None] * M, {}, None
        for t in range(M * V + S - 1):
            send, slot = None, self._fwd_at(s, t)
            if slot is not None:
                v, m = slot
                x = mbs[m] if self._first(s, v) else recv
                if keep:
                    x = x.detach().requires_grad_()
                    with torch.enable_grad():
                        y = run(v, x, m)
                    records[t - s] = (x, y)
                else:
                    y = run(v, x, m)
                if self._last(s, v):
                    outputs[m] = y.detach()
                else:
                    send = y.detach()
            recv = self._hop_fwd(send, t, mbs[0])
        return outputs, records

    def backward_gpipe(self, records, g_mbs, like):
        """GPipe's backward: each kept chunk graph in reverse tick order,
        its output's cotangent from the next stage (or the trunk's, at the
        chain's end); returns the first stage's input cotangents."""
        S, M, V, s = self.S, self.M, self.V, self.stage
        dmbs, recv = [None] * M, None
        for t in reversed(range(M * V + S - 1)):
            send, slot = None, self._fwd_at(s, t)
            if slot is not None:
                v, m = slot
                x, y = records.pop(t - s)
                g = g_mbs[m] if self._last(s, v) else recv
                with torch.enable_grad():
                    torch.autograd.backward(y, g)
                if self._first(s, v):
                    dmbs[m] = x.grad
                else:
                    send = x.grad
            nxt = self._next(1)
            got = self._fwd_at(nxt, t)
            expect = got is not None and not self._first(nxt, got[0])
            recv = collectives.hops([(send, self._next(-1), expect, nxt)],
                                    like=like, group=self.group)[0]
        return dmbs

    def backward_1f1b(self, mbs, g_mbs, run):
        """The 1F1B backward (JAX ``onef_oneb_grads_interleaved``): per
        tick one forward chunk (the wavefront that refills the stash) and
        one backward chunk (recomputed from its stashed input, then
        backpropagated), over ``M V + V S + S - 1`` ticks; returns the
        first stage's input cotangents."""
        S, M, V, s = self.S, self.M, self.V, self.stage
        n_stash = 2 * V * S - 1
        stash, act, cot, dmbs = [None] * n_stash, None, None, [None] * M
        prev, nxt = self._next(-1), self._next(1)
        for t in range(M * V + V * S + S - 1):
            back = self._bwd_at(s, t)
            # read before the forward may overwrite the slot this tick
            x0 = None if back is None else stash[back[2] % n_stash]
            y_send, fwd = None, self._fwd_at(s, t)
            if fwd is not None:
                v, m = fwd
                x = mbs[m] if self._first(s, v) else act
                stash[(t - s) % n_stash] = x
                if not self._last(s, v):  # a last chunk's output goes unused
                    y_send = run(v, x, m)
            dx_send = None
            if back is not None:
                v, m, _ = back
                g = g_mbs[m] if self._last(s, v) else cot
                x0 = x0.detach().requires_grad_()
                with torch.enable_grad():
                    torch.autograd.backward(run(v, x0, m), g)
                if self._first(s, v):
                    dmbs[m] = x0.grad
                else:
                    dx_send = x0.grad
            got_f, got_b = self._fwd_at(prev, t), self._bwd_at(nxt, t)
            act, cot = collectives.hops(
                [(y_send, nxt, got_f is not None
                  and not self._last(prev, got_f[0]), prev),
                 (dx_send, prev, got_b is not None
                  and not self._first(nxt, got_b[0]), nxt)],
                like=mbs[0], group=self.group)
        return dmbs

    def __call__(self, x, positions, generator, mask):
        B = x.shape[0]
        if B % self.M:
            raise ValueError(f"batch {B} not divisible by {self.M} "
                             f"microbatches")
        seeds = None
        if self.cfg.dropout_rate and generator is not None:
            # one stream per (microbatch, global layer): the same masks
            # under every schedule
            seeds = torch.randint(0, 2**62, (self.M, self.cfg.n_layers, 2),
                                  generator=generator)
        return _Trunk.apply(self, seeds, positions, mask, x)


class _Trunk(torch.autograd.Function):
    """The pipelined layer stack: the schedule's forward, and its
    backward (module docstring)."""

    @staticmethod
    def forward(ctx, pipe, seeds, positions, mask, x):
        run = pipe._runner(seeds, positions, mask)
        mbs = list(x.detach().chunk(pipe.M))
        keep = ctx.needs_input_grad[4] and not pipe.one_f_one_b
        outputs, records = pipe.forward_ticks(mbs, run, keep)
        last = pipe.S - 1
        out = collectives.broadcast_from(
            torch.cat(outputs) if pipe.stage == last else None, last,
            pipe.group, shape=x.shape, dtype=x.dtype, device=x.device)
        ctx.pipe, ctx.run, ctx.records = pipe, run, records
        ctx.mbs = mbs if pipe.one_f_one_b else None
        return out

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        g_mbs = [c.contiguous() for c in g.chunk(pipe.M)]
        pipe.hold_fsdp()
        if pipe.one_f_one_b:
            dmbs = pipe.backward_1f1b(ctx.mbs, g_mbs, ctx.run)
        else:
            dmbs = pipe.backward_gpipe(ctx.records, g_mbs, g_mbs[0])
        pipe.release_fsdp()
        ctx.records = ctx.mbs = None
        dx = collectives.broadcast_from(
            torch.cat(dmbs) if pipe.stage == 0 else None, 0, pipe.group,
            shape=g.shape, dtype=g.dtype, device=g.device)
        return None, None, None, None, dx


class PipelinedModel:
    """What the loss calls in the model's place under a pipeline: the
    model's own forward with :class:`Pipeline` as its layer stack, and
    every other attribute (``cfg``, ``embed``) read through."""

    def __init__(self, model, pipeline: Pipeline):
        self.__dict__["module"] = model
        self.__dict__["pipeline"] = pipeline

    def __getattr__(self, name):
        return getattr(self.module, name)

    def __call__(self, *args, **kwargs):
        return self.module(*args, trunk=self.pipeline, **kwargs)
