"""Mixture-of-Experts decoder LM family, the port of the JAX package's
``models/moe.py``.

Mixtral-style on the shared decoder core: RMSNorm, rope attention, every
MLP a top-k routed expert bank (``parallel/expert.py``).  The router is
an fp32 linear layer without a bias; the expert banks are ``[E, d, f]``
parameters named ``experts_{up,gate,down}`` in the JAX layout (the
planner's ``MOE_RULES`` match them), cast to the compute dtype at use.
Each layer's router losses (load balance and z, weighted by the
config's coefficients) are summed through the backbone, and
:class:`MoELM` returns ``(logits, aux)``: pair it with
``training.losses.moe_next_token_loss``.

Under an expert-parallel plan (``executor.apply_plan``) each
:class:`MoEMlp` gets the plan's mesh in :attr:`MoEMlp.expert_mesh` (and
``"tensor"`` in :attr:`MoEMlp.expert_tensor_axis` under ``ep_tp``), as
BatchNorm gets its ``stat_groups``; its banks are then ``DTensor`` objects
and it computes with their local blocks, exchanging the dispatched
slots over the mesh's ``expert`` group (JAX's model passes ``ctx.mesh``
to ``moe_ffn``).  Decoding reads the banks directly
(``inference/decode.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import context as pctx
from ..parallel.collectives import gather_slices
from ..parallel.expert import moe_ffn
from ..utils.device import is_dtensor
from .transformer_core import (
    DecoderLayer,
    DecoderLM,
    Linear,
    TransformerConfig,
    backbone_forward,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3

    def num_params(self) -> int:
        dense = super().num_params()
        d, f, L = self.d_model, self.ff_dim, self.n_layers
        per_layer_dense_mlp = (3 if self.act == "swiglu" else 2) * d * f
        moe_mlp = self.n_experts * per_layer_dense_mlp + d * self.n_experts
        return dense + L * (moe_mlp - per_layer_dense_mlp)

    def active_params(self) -> int:
        """Params touched per token (top-k of E experts): the MFU basis."""
        d, f, L = self.d_model, self.ff_dim, self.n_layers
        per_expert = (3 if self.act == "swiglu" else 2) * d * f
        return (self.num_params()
                - L * self.n_experts * per_expert
                + L * self.top_k * per_expert)


class MoEMlp(nn.Module):
    """Top-k routed expert bank in place of the dense MLP block: returns
    ``(y, aux)``.  The last forward's routing metrics (``aux_loss``,
    ``z_loss``, ``dropped_fraction``, detached, averaged over the batch)
    stay on :attr:`metrics` for a caller to read.  :attr:`expert_mesh`
    and :attr:`expert_tensor_axis`: the plan's expert parallelism (module
    docstring), None without one.  Under context parallelism each rank
    gathers the whole rows over the ``seq`` axis and routes them (the
    capacity and the load-balance loss are the row's), keeping its
    slice of the output."""

    def __init__(self, cfg: MoEConfig):
        super().__init__()
        self.cfg = cfg
        self.expert_mesh = None
        self.expert_tensor_axis: str | None = None
        E, d, f = cfg.n_experts, cfg.d_model, cfg.ff_dim
        self.router = Linear(d, E, bias=False)
        self.experts_up = nn.Parameter(torch.empty(E, d, f))
        if cfg.act == "swiglu":
            self.experts_gate = nn.Parameter(torch.empty(E, d, f))
        self.experts_down = nn.Parameter(torch.empty(E, f, d))
        self.metrics: dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def init_experts(self, generator: torch.Generator) -> None:
        """lecun-normal over each expert's fan-in (JAX's ``batch_axis=(0,)``)."""
        for w in (self.experts_up, getattr(self, "experts_gate", None),
                  self.experts_down):
            if w is not None:
                w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]),
                          generator=generator)

    def banks(self, dtype) -> tuple:
        """``(up, gate or None, down)``: this rank's blocks in ``dtype``."""
        return tuple(None if w is None else (
            w.to_local() if is_dtensor(w) else w).to(dtype)
            for w in (self.experts_up, getattr(self, "experts_gate", None),
                      self.experts_down))

    def act(self):
        return (F.silu if self.cfg.act == "swiglu"
                else (lambda t: F.gelu(t, approximate="tanh")))

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        ctx = pctx.current()
        if ctx is not None and ctx.seq_degree > 1:
            # context parallelism: route each whole row, as the unsharded
            # layer (and JAX's under GSPMD) does, then keep this rank's
            # slice; every seq rank computes the row's experts
            width = x.shape[1]
            y, aux = self._route(gather_slices(x, ctx.seq_group))
            r = ctx.seq_rank
            return y[:, r * width:(r + 1) * width], aux
        return self._route(x)

    def _route(self, x: torch.Tensor):
        cfg = self.cfg
        up, gate, down = self.banks(cfg.dtype)
        y, metrics = moe_ffn(
            x, self.router(x.to(torch.float32)), up, down, w_gate=gate,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=self.act(), mesh=self.expert_mesh,
            tensor_axis=self.expert_tensor_axis)
        self.metrics = {k: v.detach() for k, v in metrics.items()}
        aux = (cfg.aux_loss_coef * metrics["aux_loss"]
               + cfg.router_z_coef * metrics["z_loss"])
        return y, aux


class MoEDecoderLayer(DecoderLayer):
    """``DecoderLayer`` with the routed expert bank as its MLP: returns
    ``(x, aux)``."""

    def __init__(self, cfg: MoEConfig):
        super().__init__(cfg, mlp_cls=MoEMlp)


class MoELM(DecoderLM):
    """Causal MoE language model on the shared decoder backbone.

    ``forward`` returns ``(logits, aux_loss)`` (or ``(features,
    aux_loss)`` with ``return_features``): the summed router
    load-balance + z losses of every layer."""

    layer_cls = MoEDecoderLayer

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MoELM":
        super().init_weights(generator)
        for layer in self.layers:
            layer.mlp.init_experts(generator)
        return self

    def forward(self, tokens, positions=None, return_features: bool = False,
                *, generator: torch.Generator | None = None):
        x, aux = backbone_forward(self, self.cfg, tokens, positions,
                                  generator=generator)
        if return_features:
            return x, aux
        return self._head(x), aux


def moe_config(size: str = "test", **overrides) -> MoEConfig:
    presets = {
        # name: (n_layers, d_model, n_heads, n_experts, top_k)
        "test": (2, 128, 4, 4, 2),
        "nano": (4, 256, 8, 8, 2),
        "small": (12, 768, 12, 8, 2),       # ~0.5B total, 124M-class active
        "mixtral_tiny": (8, 512, 8, 8, 2),
    }
    L, d, h, E, k = presets[size]
    base = dict(
        vocab_size=32000,
        d_model=d,
        n_layers=L,
        n_heads=h,
        max_seq_len=1024,
        norm="rmsnorm",
        act="swiglu",
        pos="rope",
        tie_embeddings=True,
        n_experts=E,
        top_k=k,
    )
    base.update(overrides)
    return MoEConfig(**base)


def MoE(size: str = "test", **overrides) -> MoELM:
    return MoELM(moe_config(size, **overrides))
