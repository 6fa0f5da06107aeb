"""The port's framework-free scheduler against the JAX package's: the
same submit/step script, on the same virtual clock, gives the same slot
assignments, block grants and preemption victims, step by step, under
both admission policies.  The pure policy functions agree on random
inputs."""

import itertools

import numpy as np
import pytest

from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    kv_pool as jpool,
)
from torch_automatic_distributed_neural_network_tpu.inference.serve import (
    scheduler as jsched,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    kv_pool as tpool,
)
from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
    scheduler as tsched,
)


def _drive(mod, pool_mod, script, *, admission, n_slots, num_blocks, bs):
    """Run ``script`` (per step: the requests to submit) through a
    scheduler the way the engine does — evict finished, admit, finish
    prefill (single-shot: one token), grow/preempt, decode one token per
    running slot — and log every decision."""
    ticks = itertools.count()
    sched = mod.Scheduler(n_slots=n_slots,
                          allocator=pool_mod.BlockAllocator(num_blocks),
                          block_size=bs, admission=admission,
                          clock=lambda: float(next(ticks)))
    log = []
    for step, submits in enumerate(script):
        for rid, n_prompt, max_new, prio in submits:
            sched.submit(mod.Request(prompt=[1] * n_prompt,
                                     max_new_tokens=max_new, rid=rid,
                                     priority=prio))
        for s, req in enumerate(sched.slots):
            if req is not None and req.finished():
                log.append(("evict", step, s, sched.evict(s).rid))
        for slot, req in sched.admit():
            req.out_tokens = [0]  # the prefill's first token
            log.append(("admit", step, slot, req.rid, tuple(req.blocks)))
        for victim in sched.grow_for_step():
            log.append(("preempt", step, victim.rid))
        for s, req in enumerate(sched.slots):
            if req is not None and req.state == "running":
                req.out_tokens.append(0)
                log.append(("table", step, s, req.rid, tuple(req.blocks)))
        log.append(("queue", step, tuple(r.rid for r in sched.queue)))
        sched.check_invariants()
    return log, sched


@pytest.mark.parametrize("admission", ["reserve", "optimistic"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_jax(admission, seed):
    rs = np.random.RandomState(seed)
    rid = itertools.count()
    script = [[(next(rid), int(rs.randint(1, 30)), int(rs.randint(1, 20)),
                int(rs.randint(0, 2)))
               for _ in range(rs.poisson(0.8))] for _ in range(60)]
    script += [[] for _ in range(400)]  # drain
    kw = dict(admission=admission, n_slots=4, num_blocks=14, bs=4)
    want, jsch = _drive(jsched, jpool, script, **kw)
    got, tsch = _drive(tsched, tpool, script, **kw)
    assert got == want
    assert tsch.n_preemptions == jsch.n_preemptions
    assert tsch.idle() and jsch.idle()
    if admission == "optimistic" and seed == 0:
        assert tsch.n_preemptions > 0, "script never forced a preemption"


def test_policy_functions_match_jax():
    rs = np.random.RandomState(7)
    for _ in range(500):
        bs = int(rs.choice([4, 8, 16]))
        adm = str(rs.choice(["reserve", "optimistic"]))
        la = int(rs.randint(0, 3))
        q = [tuple(int(x) for x in rs.randint(1, 40, size=2))
             for _ in range(rs.randint(0, 6))]
        args = (q, int(rs.randint(0, 4)), int(rs.randint(0, 30)))
        kw = dict(block_size=bs, admission=adm, spec_lookahead=la)
        assert tsched.admission_plan(*args, **kw) == \
            jsched.admission_plan(*args, **kw)
        n_p, n_g, n_b = (int(x) for x in rs.randint(1, 50, size=3))
        assert tsched.decode_needs_block(n_p, n_g, n_b, block_size=bs) == \
            jsched.decode_needs_block(n_p, n_g, n_b, block_size=bs)
        occ = [(float(rs.randint(0, 5)) if rs.rand() > 0.2 else None, s)
               for s in range(int(rs.randint(0, 5)))]
        assert tsched.preemption_victim(occ) == jsched.preemption_victim(occ)
        assert tsched.prefill_schedule(occ, 2) == \
            jsched.prefill_schedule(occ, 2)
    assert tsched.IDENTITY_ADAPTER == 0
