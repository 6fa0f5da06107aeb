"""The dropped fraction of MoE ``small`` at init on the CPU: the JAX
package's, the port's on the same weights (drawn by JAX, carried across
by ``interop``) and the port's on its own init, on the same rows.

    python tests/torch_port_moe_drop_probe.py               # 12 layers, 1 row
    python tests/torch_port_moe_drop_probe.py --layers 2 --rows 8

The rows are the first of batch 0 of ``SyntheticLM(vocab_size=32000,
seq_len=1025, batch_size=8)``, the stream ``chip_smoke.py``'s MoE runs
step on, minus the last token (``moe_next_token_loss``'s inputs).  Each
row is a routing group of 1024 tokens (capacity 320 slots an expert at
capacity factor 1.25, 8 experts, top-2), so one row gives a row's
figure exactly.  fp32 compute, no remat.  Prints one JSON line: per
layer and on average, the three dropped fractions, and the largest
difference between JAX's and the port's on the same weights.  The full
preset takes ~6 GB of host memory and ~2 minutes; ``--layers 2`` ~25 s.
"""

from __future__ import annotations

import argparse
import json


def drop_rates(n_layers: int | None = None, rows: int = 1,
               seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import torch_automatic_distributed_neural_network_tpu.models.moe as jmoe
    from torch_automatic_distributed_neural_network_tpu.data.synthetic import (
        SyntheticLM,
    )
    from torch_automatic_distributed_neural_network_tpu_torch import interop
    from torch_automatic_distributed_neural_network_tpu_torch.models import (
        MoE,
        moe_config,
    )

    kw = dict(max_seq_len=1024, **({"n_layers": n_layers} if n_layers
                                    else {}))
    jm = jmoe.MoE("small", dtype=jnp.float32, remat=False,
                  scan_layers=False, **kw)
    tokens = SyntheticLM(vocab_size=32000, seq_len=1025,
                         batch_size=8).batch(0)["input_ids"][:rows, :-1]
    params = jax.jit(jm.init)(jax.random.key(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    # the JAX model's per-layer metrics: its moe_ffn, run eagerly (layers
    # unscanned), records them as each layer calls it
    jax_drop = []
    plain = jmoe.moe_ffn

    def recording(*a, **k):
        y, metrics = plain(*a, **k)
        jax_drop.append(float(metrics["dropped_fraction"]))
        return y, metrics

    jmoe.moe_ffn = recording
    try:
        jm.apply({"params": params}, jnp.asarray(tokens))
    finally:
        jmoe.moe_ffn = plain
    params = jax.tree.map(np.asarray, params)
    del jm
    cfg = moe_config("small", dtype=torch.float32, remat=False, **kw)

    def port_drop(model):
        with torch.no_grad():
            model(torch.from_numpy(tokens).long())
        return [float(layer.mlp.metrics["dropped_fraction"])
                for layer in model.layers]

    same = port_drop(interop.moe_from_jax_params(params, cfg, device="cpu"))
    del params
    own_model = MoE("small", dtype=torch.float32, remat=False, **kw)
    own = port_drop(own_model.init_weights(
        torch.Generator().manual_seed(seed)))
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    return {"layers": len(own), "rows": rows, "tokens_per_row": 1024,
            "seed": seed,
            "jax": jax_drop, "port_same_weights": same, "port_own_init": own,
            "mean": {"jax": mean(jax_drop), "port_same_weights": mean(same),
                     "port_own_init": mean(own)},
            "max_abs_diff_same_weights": max(
                abs(a - b) for a, b in zip(jax_drop, same))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(4)
    print(json.dumps(drop_rates(args.layers, args.rows, args.seed)))
    return 0


if __name__ == "__main__":
    import os
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
