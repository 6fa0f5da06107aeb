"""Carry decoder weights from the JAX package's parameter tree.

:func:`decoder_from_jax_params` takes the flax ``variables["params"]``
tree of a GPT-2 or Llama ``DecoderLM`` — with every leaf already a numpy
array (``jax.tree.map(np.asarray, params)`` on the JAX side; this module
never imports jax) — and returns the port's :class:`DecoderLM` on a
device.  Layouts mapped:

- the scanned ``layers`` stack ``[L, ...]``, sliced per layer;
- ``DenseGeneral`` q/k/v kernels ``[d, H, hd]`` with bias ``[H, hd]``,
  and ``o_proj`` ``[H, hd, d]``, flattened and transposed onto
  ``nn.Linear``'s ``[out, in]``;
- ``nn.Dense`` MLP kernels ``[in, out]``, transposed the same way;
- a tied ``embed.embedding`` ``[V, d]`` or an untied ``lm_head.kernel``
  ``[d, V]`` (kept ``[d, V]``), and ``pos_embed``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.transformer_core import DecoderLM, TransformerConfig
from .utils.device import resolve_device


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def decoder_from_jax_params(params: dict, cfg: TransformerConfig, *,
                            device=None) -> DecoderLM:
    """The port's ``DecoderLM`` holding the weights of a JAX decoder's
    numpy ``params`` tree, on ``device`` (default ``cuda``, raising
    without it; pass ``"cpu"`` for the CPU)."""
    if "layers" not in params:
        raise ValueError("expected the scanned parameter layout (a stacked "
                         "'layers' entry)")
    model = DecoderLM(cfg)
    state = {"embed": _t(params["embed"]["embedding"])}
    if cfg.pos == "learned":
        state["pos_embed"] = _t(params["pos_embed"])
    if not cfg.tie_embeddings:
        state["lm_head"] = _t(params["lm_head"]["kernel"])
    for name in ("scale", "bias"):
        if name in params["final_norm"]:
            state[f"final_norm.{name}"] = _t(params["final_norm"][name])

    stack = params["layers"]
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for norm in ("attn_norm", "mlp_norm"):
            for name, leaf in stack[norm].items():
                state[f"{pre}{norm}.{name}"] = _t(leaf[i])
        for proj in ("q_proj", "k_proj", "v_proj"):
            p = stack["attn"][proj]
            kernel = np.asarray(p["kernel"][i])  # [d, H, hd]
            state[f"{pre}attn.{proj}.weight"] = _t(
                kernel.reshape(kernel.shape[0], -1).T)
            if "bias" in p:
                state[f"{pre}attn.{proj}.bias"] = _t(
                    np.asarray(p["bias"][i]).reshape(-1))
        p = stack["attn"]["o_proj"]
        kernel = np.asarray(p["kernel"][i])  # [H, hd, d]
        state[f"{pre}attn.o_proj.weight"] = _t(
            kernel.reshape(-1, kernel.shape[-1]).T)
        if "bias" in p:
            state[f"{pre}attn.o_proj.bias"] = _t(p["bias"][i])
        for proj, p in stack["mlp"].items():
            state[f"{pre}mlp.{proj}.weight"] = _t(np.asarray(p["kernel"][i]).T)
            if "bias" in p:
                state[f"{pre}mlp.{proj}.bias"] = _t(p["bias"][i])

    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device))
