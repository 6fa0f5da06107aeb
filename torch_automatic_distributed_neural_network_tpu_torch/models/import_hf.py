"""HuggingFace / PyTorch weight import and export — the migration path,
the port of the JAX package's ``models/import_hf.py``.

A user of the torch reference holds HF checkpoints.  These functions map
HF GPT-2, Llama (and Mistral), Mixtral, BERT and ViT state dicts onto
the port's models and back:

    import transformers
    hf = transformers.GPT2LMHeadModel.from_pretrained(path)
    model, params = import_hf_gpt2(hf)          # on "cuda" unless asked
    ad = AutoDistribute(model, loss_fn=next_token_loss,
                        init_fn=lambda m, g: m.load_state_dict(params))

An import takes an HF model (its ``state_dict()`` and, where it has one,
its ``config``) or a raw state dict, builds the port's model on the meta
device and assigns it the converted tensors on ``device``: each HF
tensor is converted there (torch ops, no numpy detour) and no whole host
copy is kept beside the device one.  It returns ``(model, params)``,
``params`` the model's parameters by the port's names.  An export gives
HF's names and layouts back as fp32 tensors on the model's device.

The rules are the JAX package's:

- the port's ``rope`` is the rotate-half formulation HF Llama uses, so
  weights import with no channel permutation;
- the port's ``gelu`` (tanh approximation) is HF ``gelu_new``; HF's
  ``gelu`` is the exact one (``gelu_exact``);
- norm epsilons thread from the checkpoint's config: ``rms_norm_eps``
  for Llama/Mistral (Mistral's 1e-6 against Llama 3's 1e-5),
  ``layer_norm_eps`` for BERT and ViT (1e-12); GPT-2 keeps the 1e-5
  both sides use;
- HF GPT-2 uses ``Conv1D`` (``[in, out]`` weights, transposed here onto
  ``nn.Linear``'s ``[out, in]``) with a fused ``c_attn`` split q, k, v
  in that order along its output; HF Llama, Mixtral, BERT and ViT use
  ``nn.Linear``'s ``[out, in]``, the port's layout, so their
  projections copy as they are;
- the port's untied head is ``[d, V]`` (the JAX kernel's layout): HF's
  ``lm_head.weight`` ``[V, d]`` is transposed;
- both MoE routers softmax over all experts, take the top k and
  renormalize; Mixtral imports at the no-drop capacity factor
  ``E / top_k`` (the capacity, rounded up to a multiple of 8, is then at
  least a row's tokens), so the routed dispatch drops nothing HF keeps;
- Llama 3's ``rope_scaling`` is read on neither side.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..utils.device import resolve_device
from .transformer_core import DecoderLM, TransformerConfig


def _state_dict(model_or_state_dict) -> Mapping[str, Any]:
    """The HF state dict of a model or a raw mapping (tensors or arrays);
    the bare-vs-headed prefixes (``transformer.``, ``model.``, ``bert.``,
    ``vit.``) are resolved where a name is read."""
    sd = (model_or_state_dict.state_dict()
          if hasattr(model_or_state_dict, "state_dict")
          else model_or_state_dict)
    return dict(sd)


class _Reader:
    """HF tensors by name, each copied to fp32 on ``device`` when it is
    read (one tensor at a time: no whole host copy beside the device
    one, and no storage shared with the source model)."""

    def __init__(self, sd: Mapping[str, Any], device: torch.device):
        self.sd, self.device = sd, device

    def __call__(self, *names: str) -> torch.Tensor:
        for n in names:
            if n in self.sd:
                return torch.as_tensor(self.sd[n]).detach().to(
                    self.device, torch.float32, copy=True)
        raise KeyError(f"none of {names} in state_dict (have e.g. "
                       f"{list(self.sd)[:5]}...)")


def _assign(model: torch.nn.Module, state: dict[str, torch.Tensor]
            ) -> tuple[torch.nn.Module, dict[str, torch.Tensor]]:
    """``model`` (built on the meta device) holding ``state``, every entry
    contiguous and fp32; returns ``(model, its parameters by name)``."""
    model.load_state_dict({n: t.contiguous() for n, t in state.items()},
                          strict=True, assign=True)
    return model, dict(model.named_parameters())


def _layers(sd: Mapping[str, Any], *patterns: str) -> int:
    """The number of layers: the first ``i`` for which no pattern
    (formatted with ``i``) names an entry."""
    n = 0
    while any(p.format(n) in sd for p in patterns):
        n += 1
    return n


def _dtype_kw(dtype) -> dict:
    return {"dtype": dtype} if dtype is not None else {}


def import_hf_gpt2(model_or_state_dict, *, max_seq_len: int | None = None,
                   dtype: torch.dtype | None = None, device=None
                   ) -> tuple[DecoderLM, dict]:
    """HF ``GPT2LMHeadModel`` / ``GPT2Model`` -> (the port's GPT-2, its
    parameters).

    Dims come from the weights (wte ``[V, d]``, wpe ``[P, d]``); the head
    count from an attached config's ``n_head``, else the GPT-2 family
    rule ``d / 64`` (a raw state dict)."""
    sd = _state_dict(model_or_state_dict)
    r = _Reader(sd, resolve_device(device))

    def g(name):
        return r(f"transformer.{name}", name)

    wte, wpe = g("wte.weight"), g("wpe.weight")
    vocab, d = wte.shape
    n_layers = _layers(sd, "transformer.h.{}.ln_1.weight", "h.{}.ln_1.weight")
    hf_cfg = getattr(model_or_state_dict, "config", None)
    if hf_cfg is not None and getattr(hf_cfg, "n_head", None):
        n_heads = int(hf_cfg.n_head)
    else:
        n_heads = max(1, d // 64)
    cfg = TransformerConfig(
        vocab_size=vocab, d_model=d, n_layers=n_layers, n_heads=n_heads,
        max_seq_len=max_seq_len or wpe.shape[0], norm="layernorm",
        act="gelu", pos="learned", tie_embeddings=True, **_dtype_kw(dtype))
    state = {"embed": wte, "pos_embed": wpe,
             "final_norm.scale": g("ln_f.weight"),
             "final_norm.bias": g("ln_f.bias")}
    for i in range(n_layers):
        pre, h = f"layers.{i}.", f"h.{i}."
        # Conv1D [d, 3d]: q, k, v along the output, each [in, out]
        qkv_w = g(h + "attn.c_attn.weight").split(d, dim=1)
        qkv_b = g(h + "attn.c_attn.bias").split(d, dim=0)
        for name, w, b in zip(("q_proj", "k_proj", "v_proj"), qkv_w, qkv_b):
            state[f"{pre}attn.{name}.weight"] = w.T
            state[f"{pre}attn.{name}.bias"] = b
        state.update({
            pre + "attn_norm.scale": g(h + "ln_1.weight"),
            pre + "attn_norm.bias": g(h + "ln_1.bias"),
            pre + "attn.o_proj.weight": g(h + "attn.c_proj.weight").T,
            pre + "attn.o_proj.bias": g(h + "attn.c_proj.bias"),
            pre + "mlp_norm.scale": g(h + "ln_2.weight"),
            pre + "mlp_norm.bias": g(h + "ln_2.bias"),
            pre + "mlp.up_proj.weight": g(h + "mlp.c_fc.weight").T,
            pre + "mlp.up_proj.bias": g(h + "mlp.c_fc.bias"),
            pre + "mlp.down_proj.weight": g(h + "mlp.c_proj.weight").T,
            pre + "mlp.down_proj.bias": g(h + "mlp.c_proj.bias"),
        })
    with torch.device("meta"):
        model = DecoderLM(cfg)
    return _assign(model, state)


class _LlamaCommon:
    """The dims, config and attention/norm mapping every Llama-family HF
    layout shares (Llama and Mixtral differ only in the MLP block)."""

    def __init__(self, model_or_state_dict, max_seq_len, rope_theta=None,
                 n_heads=None, n_kv_heads=None, device=None):
        sd = self.sd = _state_dict(model_or_state_dict)
        hf_cfg = self.hf_cfg = getattr(model_or_state_dict, "config", None)
        self.rope_theta = (float(getattr(hf_cfg, "rope_theta", 10000.0))
                           if rope_theta is None else rope_theta)
        # the trained context length from the config, else 8192
        self.max_seq_len = max_seq_len or int(
            getattr(hf_cfg, "max_position_embeddings", 8192) or 8192)
        emb = torch.as_tensor(self.sd[self.name("embed_tokens.weight")])
        self.vocab, self.d = emb.shape
        self.n_layers = _layers(sd, "model.layers.{}.input_layernorm.weight",
                                "layers.{}.input_layernorm.weight")
        # head counts: explicit kwargs win, else the attached config; a
        # raw state dict is refused: head_dim is not recoverable from the
        # weight shapes (TinyLlama-1.1B has d 2048 with 64-dim heads,
        # Llama-8B d 4096 with 128-dim heads)
        if n_heads is not None:
            self.n_heads = int(n_heads)
            self.n_kv = int(n_kv_heads if n_kv_heads is not None else n_heads)
        elif hf_cfg is not None and hasattr(hf_cfg, "num_attention_heads"):
            self.n_heads = int(hf_cfg.num_attention_heads)
            self.n_kv = int(getattr(hf_cfg, "num_key_value_heads",
                                    self.n_heads))
        else:
            raise ValueError(
                "raw state_dict has no attached config: head layout is "
                "ambiguous (head_dim cannot be inferred from weight "
                "shapes) — pass n_heads= and n_kv_heads= explicitly, or "
                "import via the transformers model object")
        self.r = _Reader(sd, resolve_device(device))
        # HF materializes lm_head.weight in state_dict() even when tied.
        # A bare backbone has no head whatever its config says (absence
        # means tied); with a head, trust the config, else compare values
        head = next((sd[k] for k in ("lm_head.weight", "model.lm_head.weight")
                     if k in sd), None)
        if head is None:
            self.tied = True
        elif hf_cfg is not None and hasattr(hf_cfg, "tie_word_embeddings"):
            self.tied = bool(hf_cfg.tie_word_embeddings)
        else:
            self.tied = torch.equal(torch.as_tensor(head), emb)

    def name(self, name: str) -> str:
        return f"model.{name}" if f"model.{name}" in self.sd else name

    def g(self, name: str) -> torch.Tensor:
        return self.r(f"model.{name}", name)

    def cfg_kwargs(self, dtype) -> dict:
        # Mistral-family configs carry sliding_window (None = full
        # attention); Llama configs have no such attribute
        window = getattr(self.hf_cfg, "sliding_window", None)
        return dict(
            norm_eps=float(getattr(self.hf_cfg, "rms_norm_eps", 1e-5)
                           if self.hf_cfg is not None else 1e-5),
            vocab_size=self.vocab, d_model=self.d, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv,
            max_seq_len=self.max_seq_len, norm="rmsnorm", act="swiglu",
            pos="rope", tie_embeddings=self.tied, rope_theta=self.rope_theta,
            sliding_window=int(window) if window else None,
            **_dtype_kw(dtype))

    def attn_and_norms(self, i: int) -> dict[str, torch.Tensor]:
        """One layer's attention and norm entries (everything but the
        MLP): HF's ``nn.Linear`` weights are the port's layout."""
        pre, h = f"layers.{i}.", f"layers.{i}."
        return {
            pre + "attn_norm.scale": self.g(h + "input_layernorm.weight"),
            pre + "attn.q_proj.weight": self.g(h + "self_attn.q_proj.weight"),
            pre + "attn.k_proj.weight": self.g(h + "self_attn.k_proj.weight"),
            pre + "attn.v_proj.weight": self.g(h + "self_attn.v_proj.weight"),
            pre + "attn.o_proj.weight": self.g(h + "self_attn.o_proj.weight"),
            pre + "mlp_norm.scale": self.g(
                h + "post_attention_layernorm.weight"),
        }

    def header(self) -> dict[str, torch.Tensor]:
        """The embedding, the final norm and an untied head (HF ``[V, d]``
        -> the port's ``[d, V]``)."""
        state = {"embed": self.g("embed_tokens.weight"),
                 "final_norm.scale": self.g("norm.weight")}
        if not self.tied:
            state["lm_head"] = self.r("lm_head.weight",
                                      "model.lm_head.weight").T
        return state


def import_hf_llama(model_or_state_dict, *, max_seq_len: int | None = None,
                    rope_theta: float | None = None,
                    dtype: torch.dtype | None = None,
                    n_heads: int | None = None, n_kv_heads: int | None = None,
                    device=None) -> tuple[DecoderLM, dict]:
    """HF ``LlamaForCausalLM`` / ``LlamaModel`` (and the Mistral family,
    the same layout) -> (the port's Llama, its parameters).

    ``rope_theta`` defaults from an attached config (Llama 3: 500000.0),
    else 10000.0.  A raw state dict must pass ``n_heads`` /
    ``n_kv_heads``.  A Mistral config's ``sliding_window`` becomes
    ``cfg.sliding_window``, so the model attends with the band it was
    trained with."""
    c = _LlamaCommon(model_or_state_dict, max_seq_len, rope_theta,
                     n_heads=n_heads, n_kv_heads=n_kv_heads, device=device)
    ff = c.sd[c.name("layers.0.mlp.gate_proj.weight")].shape[0]
    cfg = TransformerConfig(d_ff=ff, **c.cfg_kwargs(dtype))
    state = c.header()
    for i in range(c.n_layers):
        state.update(c.attn_and_norms(i))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            state[f"layers.{i}.mlp.{proj}.weight"] = c.g(
                f"layers.{i}.mlp.{proj}.weight")
    with torch.device("meta"):
        model = DecoderLM(cfg)
    return _assign(model, state)


def import_hf_mixtral(model_or_state_dict, *, max_seq_len: int | None = None,
                      rope_theta: float | None = None,
                      capacity_factor: float | None = None,
                      dtype: torch.dtype | None = None,
                      n_heads: int | None = None,
                      n_kv_heads: int | None = None, device=None):
    """HF ``MixtralForCausalLM`` / ``MixtralModel`` -> (the port's
    ``MoELM``, its parameters).

    Attention and norms are Llama's; ``block_sparse_moe.gate`` is the
    router (``[E, d]``, the port's layout) and each expert's ``w1`` /
    ``w3`` / ``w2`` (gate / up / down, ``nn.Linear`` ``[out, in]``) are
    transposed into the ``experts_gate`` / ``experts_up`` ``[E, d, ff]``
    and ``experts_down`` ``[E, ff, d]`` banks.  ``capacity_factor``
    defaults to ``n_experts / top_k``, the no-drop bound (HF Mixtral
    drops nothing); lower it for capacity-constrained training.  A raw
    state dict defaults ``rope_theta`` to 1e6, every released Mixtral's
    (the Llama fallback 1e4 is wrong for them all)."""
    from .moe import MoEConfig, MoELM

    if (rope_theta is None
            and getattr(model_or_state_dict, "config", None) is None):
        rope_theta = 1e6
    c = _LlamaCommon(model_or_state_dict, max_seq_len, rope_theta,
                     n_heads=n_heads, n_kv_heads=n_kv_heads, device=device)
    n_experts = _layers(
        c.sd, "model.layers.0.block_sparse_moe.experts.{}.w1.weight",
        "layers.0.block_sparse_moe.experts.{}.w1.weight")
    ff = c.sd[c.name("layers.0.block_sparse_moe.experts.0.w1.weight")
              ].shape[0]
    top_k = int(getattr(c.hf_cfg, "num_experts_per_tok", 2) or 2)
    cfg = MoEConfig(
        d_ff=ff, n_experts=n_experts, top_k=top_k,
        capacity_factor=(capacity_factor if capacity_factor is not None
                         else n_experts / top_k),
        **c.cfg_kwargs(dtype))
    state = c.header()
    for i in range(c.n_layers):
        state.update(c.attn_and_norms(i))
        moe = f"layers.{i}.block_sparse_moe."

        def bank(w, moe=moe):
            return torch.stack([c.g(f"{moe}experts.{e}.{w}.weight").T
                                for e in range(n_experts)])

        state.update({
            f"layers.{i}.mlp.router.weight": c.g(moe + "gate.weight"),
            f"layers.{i}.mlp.experts_gate": bank("w1"),  # [E, d, ff]
            f"layers.{i}.mlp.experts_up": bank("w3"),
            f"layers.{i}.mlp.experts_down": bank("w2"),  # [E, ff, d]
        })
    with torch.device("meta"):
        model = MoELM(cfg)
    return _assign(model, state)


def _hf_heads_or_raise(model_or_state_dict, n_heads):
    """Explicit ``n_heads`` wins, else the attached config's; a raw state
    dict is refused: a wrong head count splits the per-head fused Q/K/V
    on the wrong boundary, silently."""
    if n_heads is not None:
        return int(n_heads)
    hf_cfg = getattr(model_or_state_dict, "config", None)
    if hf_cfg is not None and getattr(hf_cfg, "num_attention_heads", None):
        return int(hf_cfg.num_attention_heads)
    raise ValueError(
        "cannot infer the head count from a raw state_dict "
        "(Q/K/V are per-head fused); pass n_heads= explicitly")


def _hf_norm_eps(model_or_state_dict, default=1e-12) -> float:
    hf_cfg = getattr(model_or_state_dict, "config", None)
    return float(getattr(hf_cfg, "layer_norm_eps", default)
                 if hf_cfg is not None else default)


# HF hidden_act -> the port's act: HF's 'gelu' is the exact erf
# formulation ('gelu_exact'); 'gelu_new' / 'gelu_pytorch_tanh' are the
# tanh approximation ('gelu')
_HF_ACT_MAP = {"gelu": "gelu_exact", "gelu_new": "gelu",
               "gelu_pytorch_tanh": "gelu"}


def _hf_act(model_or_state_dict, default="gelu_exact") -> str:
    """``hf_cfg.hidden_act`` as the port's act name; an activation the
    port has no path for raises (importing it as gelu would silently
    change the logits)."""
    hf_cfg = getattr(model_or_state_dict, "config", None)
    if hf_cfg is None:
        return default
    act = getattr(hf_cfg, "hidden_act", None)
    if act is None:
        return default
    if not isinstance(act, str) or act not in _HF_ACT_MAP:
        raise ValueError(
            f"unsupported HF hidden_act {act!r}: this importer maps "
            f"{sorted(_HF_ACT_MAP)} onto the framework's gelu variants; "
            "other activations would silently change the imported "
            "model's logits")
    return _HF_ACT_MAP[act]


def _hf_encoder_block(g, pre: str, h: str, attn: str
                      ) -> dict[str, torch.Tensor]:
    """The q/k/v/o and intermediate/output entries every HF encoder
    layout shares (``nn.Linear`` layouts, copied as they are); ``attn``
    is the self-attention prefix ('attention.self' for BERT,
    'attention.attention' for ViT).  The norms' placement differs by
    family and stays with the caller."""
    state = {}
    for port, hf in (("q_proj", "query"), ("k_proj", "key"),
                     ("v_proj", "value")):
        for leaf in ("weight", "bias"):
            state[f"{pre}attn.{port}.{leaf}"] = g(f"{h}{attn}.{hf}.{leaf}")
    for port, hf in (("attn.o_proj", "attention.output.dense"),
                     ("mlp.up_proj", "intermediate.dense"),
                     ("mlp.down_proj", "output.dense")):
        for leaf in ("weight", "bias"):
            state[f"{pre}{port}.{leaf}"] = g(f"{h}{hf}.{leaf}")
    return state


def import_hf_bert(model_or_state_dict, *, max_seq_len: int | None = None,
                   n_heads: int | None = None,
                   dtype: torch.dtype | None = None, device=None):
    """HF ``BertForMaskedLM`` / ``BertModel`` -> (the port's
    ``BertEncoder``, its parameters).

    Post-norm maps one to one: ``attention.output.LayerNorm`` and
    ``output.LayerNorm`` (after each residual add) are ``attn_norm`` and
    ``mlp_norm`` under ``norm_order='post'``, the embeddings' LayerNorm
    ``embed_norm``, the token-type table ``seg_embed``; the MLM
    transform and decoder are ``mlm_dense`` / ``mlm_norm`` /
    ``mlm_bias`` (the decoder tied to the word embeddings in both
    layouts).  A bare ``BertModel`` has no MLM head: an identity dense,
    a unit norm and a zero bias take its place, so the features come out
    right and MLM can be fine-tuned."""
    from .bert import BertEncoder, bert_config

    sd = _state_dict(model_or_state_dict)
    n_heads = _hf_heads_or_raise(model_or_state_dict, n_heads)
    act = _hf_act(model_or_state_dict)
    r = _Reader(sd, resolve_device(device))

    def g(name):
        return r(f"bert.{name}", name)

    wte = g("embeddings.word_embeddings.weight")
    wpe = g("embeddings.position_embeddings.weight")
    tte = g("embeddings.token_type_embeddings.weight")
    vocab, d = wte.shape
    n_layers = _layers(
        sd, "bert.encoder.layer.{}.attention.self.query.weight",
        "encoder.layer.{}.attention.self.query.weight")
    d_ff = g("encoder.layer.0.intermediate.dense.weight").shape[0]
    cfg = bert_config(
        "base", vocab_size=vocab, d_model=d, n_layers=n_layers,
        n_heads=n_heads, d_ff=d_ff, max_seq_len=max_seq_len or wpe.shape[0],
        type_vocab_size=tte.shape[0],
        norm_eps=_hf_norm_eps(model_or_state_dict),
        act=act, **_dtype_kw(dtype))
    state = {"embed": wte, "pos_embed": wpe, "seg_embed": tte,
             "embed_norm.scale": g("embeddings.LayerNorm.weight"),
             "embed_norm.bias": g("embeddings.LayerNorm.bias")}
    for i in range(n_layers):
        pre, h = f"layers.{i}.", f"encoder.layer.{i}."
        state.update(_hf_encoder_block(g, pre, h, "attention.self"))
        for port, hf in (("attn_norm", "attention.output.LayerNorm"),
                         ("mlp_norm", "output.LayerNorm")):
            state[f"{pre}{port}.scale"] = g(f"{h}{hf}.weight")
            state[f"{pre}{port}.bias"] = g(f"{h}{hf}.bias")
    if any(k.startswith("cls.predictions") for k in sd):
        state.update({
            "mlm_dense.weight": r("cls.predictions.transform.dense.weight"),
            "mlm_dense.bias": r("cls.predictions.transform.dense.bias"),
            "mlm_norm.scale": r(
                "cls.predictions.transform.LayerNorm.weight"),
            "mlm_norm.bias": r("cls.predictions.transform.LayerNorm.bias"),
            "mlm_bias": r("cls.predictions.bias"),
        })
    else:
        dev = wte.device
        state.update({
            "mlm_dense.weight": torch.eye(d, device=dev),
            "mlm_dense.bias": torch.zeros(d, device=dev),
            "mlm_norm.scale": torch.ones(d, device=dev),
            "mlm_norm.bias": torch.zeros(d, device=dev),
            "mlm_bias": torch.zeros(vocab, device=dev),
        })
    with torch.device("meta"):
        model = BertEncoder(cfg)
    return _assign(model, state)


def import_hf_vit(model_or_state_dict, *, n_heads: int | None = None,
                  dtype: torch.dtype | None = None, device=None):
    """HF ``ViTForImageClassification`` / ``ViTModel`` -> (the port's
    ``ViTEncoder``, its parameters).

    The patch convolution's kernel ``[d, C, p, p]`` becomes the patch
    projection's ``[d, p*p*C]`` through the (kh, kw, c, out) transpose
    (``[d, p, p, C]``): the same product the stride-p convolution is, in
    the pixel order ``unfold_patches`` gives.  Pre-norm maps directly
    (``layernorm_before`` / ``after`` -> ``attn_norm`` / ``mlp_norm``,
    ``vit.layernorm`` -> ``final_norm``); a model without a classifier
    gets a zero one of one class."""
    from .vit import ViTEncoder, vit_config

    sd = _state_dict(model_or_state_dict)
    n_heads = _hf_heads_or_raise(model_or_state_dict, n_heads)
    r = _Reader(sd, resolve_device(device))

    def g(name):
        return r(f"vit.{name}", name)

    conv = g("embeddings.patch_embeddings.projection.weight")
    d, ch, p, _ = conv.shape
    pos = g("embeddings.position_embeddings").reshape(-1, d)
    n_patches = pos.shape[0] - 1
    image_size = int(round(n_patches ** 0.5)) * p
    n_layers = _layers(
        sd, "vit.encoder.layer.{}.attention.attention.query.weight",
        "encoder.layer.{}.attention.attention.query.weight")
    d_ff = g("encoder.layer.0.intermediate.dense.weight").shape[0]
    has_classifier = "classifier.weight" in sd
    num_classes = (sd["classifier.weight"].shape[0]
                   if has_classifier else 0) or 1
    cfg = vit_config(
        "base", image_size=image_size, patch_size=p, num_classes=num_classes,
        d_model=d, n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
        norm_eps=_hf_norm_eps(model_or_state_dict), **_dtype_kw(dtype))
    state = {
        "patch_proj.weight": conv.permute(0, 2, 3, 1).reshape(d, p * p * ch),
        "patch_proj.bias": g("embeddings.patch_embeddings.projection.bias"),
        "cls_token": g("embeddings.cls_token").reshape(1, 1, d),
        "pos_embed": pos,
        "final_norm.scale": g("layernorm.weight"),
        "final_norm.bias": g("layernorm.bias"),
    }
    for i in range(n_layers):
        pre, h = f"layers.{i}.", f"encoder.layer.{i}."
        state.update(_hf_encoder_block(g, pre, h, "attention.attention"))
        for port, hf in (("attn_norm", "layernorm_before"),
                         ("mlp_norm", "layernorm_after")):
            state[f"{pre}{port}.scale"] = g(f"{h}{hf}.weight")
            state[f"{pre}{port}.bias"] = g(f"{h}{hf}.bias")
    if has_classifier:
        state["classifier.weight"] = r("classifier.weight")
        state["classifier.bias"] = r("classifier.bias")
    else:
        state["classifier.weight"] = torch.zeros(num_classes, d,
                                                 device=conv.device)
        state["classifier.bias"] = torch.zeros(num_classes,
                                               device=conv.device)
    with torch.device("meta"):
        model = ViTEncoder(cfg)
    return _assign(model, state)


# ---------------------------------------------------------------------------
# Exports: the port's models -> HF state dicts
# ---------------------------------------------------------------------------


def _exporter(model, params: Mapping[str, torch.Tensor] | None):
    """The model's tensors by name (``params`` in place of its own where
    given, e.g. a ``TrainState``'s fp32 masters), each read as a new
    fp32 tensor: an export shares no storage with the model."""
    own = {**model.state_dict(), **(params or {})}

    def t(name: str) -> torch.Tensor:
        return own[name].detach().to(torch.float32, copy=True)

    return t


def export_hf_gpt2(model, params: Mapping[str, torch.Tensor] | None = None
                   ) -> dict[str, torch.Tensor]:
    """The port's GPT-2 -> an HF ``GPT2LMHeadModel`` state dict (fp32
    tensors on the model's device; ``params`` by name replace the
    model's own where given).  Inverse of :func:`import_hf_gpt2`: q, k,
    v fused into ``c_attn`` and every projection back in ``Conv1D``'s
    ``[in, out]``."""
    cfg = model.cfg
    t = _exporter(model, params)
    wte = t("embed").contiguous()
    sd: dict[str, torch.Tensor] = {
        "transformer.wte.weight": wte,
        "transformer.wpe.weight": t("pos_embed").contiguous(),
        "transformer.ln_f.weight": t("final_norm.scale"),
        "transformer.ln_f.bias": t("final_norm.bias"),
    }
    sd["lm_head.weight"] = (wte if cfg.tie_embeddings
                            else t("lm_head").T.contiguous())
    for i in range(cfg.n_layers):
        pre, h = f"layers.{i}.", f"transformer.h.{i}."
        sd.update({
            h + "ln_1.weight": t(pre + "attn_norm.scale"),
            h + "ln_1.bias": t(pre + "attn_norm.bias"),
            h + "attn.c_attn.weight": torch.cat(
                [t(f"{pre}attn.{n}_proj.weight").T for n in "qkv"], dim=1),
            h + "attn.c_attn.bias": torch.cat(
                [t(f"{pre}attn.{n}_proj.bias") for n in "qkv"]),
            h + "attn.c_proj.weight": t(pre + "attn.o_proj.weight").T,
            h + "attn.c_proj.bias": t(pre + "attn.o_proj.bias"),
            h + "ln_2.weight": t(pre + "mlp_norm.scale"),
            h + "ln_2.bias": t(pre + "mlp_norm.bias"),
            h + "mlp.c_fc.weight": t(pre + "mlp.up_proj.weight").T,
            h + "mlp.c_fc.bias": t(pre + "mlp.up_proj.bias"),
            h + "mlp.c_proj.weight": t(pre + "mlp.down_proj.weight").T,
            h + "mlp.c_proj.bias": t(pre + "mlp.down_proj.bias"),
        })
    return {n: v.contiguous() for n, v in sd.items()}


def _export_llama_family(model, params, mlp_block) -> dict:
    """The Llama-family export skeleton (inverse of ``_LlamaCommon``):
    the embedding, final norm and head, and each layer's attention and
    norms; ``mlp_block(t, pre, hf_pre, sd)`` adds the family's MLP."""
    cfg = model.cfg
    t = _exporter(model, params)
    emb = t("embed").contiguous()
    sd: dict[str, torch.Tensor] = {"model.embed_tokens.weight": emb,
                                   "model.norm.weight": t("final_norm.scale")}
    sd["lm_head.weight"] = (emb if cfg.tie_embeddings
                            else t("lm_head").T.contiguous())
    for i in range(cfg.n_layers):
        pre, h = f"layers.{i}.", f"model.layers.{i}."
        sd.update({
            h + "input_layernorm.weight": t(pre + "attn_norm.scale"),
            h + "self_attn.q_proj.weight": t(pre + "attn.q_proj.weight"),
            h + "self_attn.k_proj.weight": t(pre + "attn.k_proj.weight"),
            h + "self_attn.v_proj.weight": t(pre + "attn.v_proj.weight"),
            h + "self_attn.o_proj.weight": t(pre + "attn.o_proj.weight"),
            h + "post_attention_layernorm.weight": t(pre + "mlp_norm.scale"),
        })
        mlp_block(t, pre, h, sd)
    return {n: v.contiguous() for n, v in sd.items()}


def export_hf_llama(model, params: Mapping[str, torch.Tensor] | None = None
                    ) -> dict[str, torch.Tensor]:
    """The port's Llama -> an HF ``LlamaForCausalLM`` state dict (fp32
    tensors on the model's device).  Inverse of :func:`import_hf_llama`."""

    def mlp_block(t, pre, h, sd):
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{h}mlp.{proj}.weight"] = t(f"{pre}mlp.{proj}.weight")

    return _export_llama_family(model, params, mlp_block)


def export_hf_mixtral(model, params: Mapping[str, torch.Tensor] | None = None
                      ) -> dict[str, torch.Tensor]:
    """The port's ``MoELM`` -> an HF ``MixtralForCausalLM`` state dict.
    Inverse of :func:`import_hf_mixtral`.  Only swiglu MoE models map
    onto Mixtral's w1/w3/w2 expert layout (a gelu MoE has no
    ``experts_gate`` bank)."""
    cfg = model.cfg
    if cfg.act != "swiglu":
        raise ValueError(
            f"export_hf_mixtral needs act='swiglu' (Mixtral's w1/w3/w2 "
            f"layout); this model has act={cfg.act!r} and no "
            f"experts_gate bank")

    def mlp_block(t, pre, h, sd):
        sd[h + "block_sparse_moe.gate.weight"] = t(pre + "mlp.router.weight")
        banks = {w: t(f"{pre}mlp.experts_{bank}")
                 for w, bank in (("w1", "gate"), ("w3", "up"),
                                 ("w2", "down"))}
        for e in range(cfg.n_experts):
            for w, bank in banks.items():
                sd[f"{h}block_sparse_moe.experts.{e}.{w}.weight"] = bank[e].T

    return _export_llama_family(model, params, mlp_block)


def export_hf_bert(model, params: Mapping[str, torch.Tensor] | None = None
                   ) -> dict[str, torch.Tensor]:
    """The port's ``BertEncoder`` -> an HF ``BertForMaskedLM`` state dict
    (fp32 tensors on the model's device).  Inverse of
    :func:`import_hf_bert`; the decoder weight is the word embedding
    (tied) and its bias ``mlm_bias``."""
    cfg = model.cfg
    t = _exporter(model, params)
    wte = t("embed").contiguous()
    sd: dict[str, torch.Tensor] = {
        "bert.embeddings.word_embeddings.weight": wte,
        "bert.embeddings.position_embeddings.weight": t("pos_embed"),
        "bert.embeddings.token_type_embeddings.weight": t("seg_embed"),
        "bert.embeddings.LayerNorm.weight": t("embed_norm.scale"),
        "bert.embeddings.LayerNorm.bias": t("embed_norm.bias"),
        "cls.predictions.transform.dense.weight": t("mlm_dense.weight"),
        "cls.predictions.transform.dense.bias": t("mlm_dense.bias"),
        "cls.predictions.transform.LayerNorm.weight": t("mlm_norm.scale"),
        "cls.predictions.transform.LayerNorm.bias": t("mlm_norm.bias"),
        "cls.predictions.bias": t("mlm_bias"),
        "cls.predictions.decoder.weight": wte,
        "cls.predictions.decoder.bias": t("mlm_bias"),
    }
    for i in range(cfg.n_layers):
        pre, h = f"layers.{i}.", f"bert.encoder.layer.{i}."
        for port, hf in (("attn.q_proj", "attention.self.query"),
                         ("attn.k_proj", "attention.self.key"),
                         ("attn.v_proj", "attention.self.value"),
                         ("attn.o_proj", "attention.output.dense"),
                         ("mlp.up_proj", "intermediate.dense"),
                         ("mlp.down_proj", "output.dense")):
            for leaf in ("weight", "bias"):
                sd[f"{h}{hf}.{leaf}"] = t(f"{pre}{port}.{leaf}")
        for port, hf in (("attn_norm", "attention.output.LayerNorm"),
                         ("mlp_norm", "output.LayerNorm")):
            sd[f"{h}{hf}.weight"] = t(f"{pre}{port}.scale")
            sd[f"{h}{hf}.bias"] = t(f"{pre}{port}.bias")
    return {n: v.contiguous() for n, v in sd.items()}
