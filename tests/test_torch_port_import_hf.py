"""The HF imports and exports of the PyTorch port
(``models/import_hf.py``) against the JAX package's, on ``transformers``
models built from random configs (nothing is downloaded), each built
once for the module: GPT-2, Llama (untied with GQA, tied, and a bare
``LlamaModel``), Mistral (sliding window 8 over S 17, eps 1e-6),
Mixtral (4 experts top-2), BERT (token types, exact gelu; a bare
``BertModel``) and ViT (patch 8 on 32^2).

Tolerances (fp32, one intra-op thread): the port's imported logits
within 1e-5 absolute of JAX's imported logits (the same arithmetic in
another order; logits O(1)) and within 1e-4 of HF's own; every export
equal to JAX's export of the same weights bitwise (a layout change
only), and import -> export -> import round trips bitwise; an export
loaded into a fresh ``transformers`` model gives that model's logits
within 1e-5 of the source's.  The refusals (a raw Llama or BERT state
dict without a head count, an unknown ``hidden_act``, a gelu MoE
export) raise the JAX package's ``ValueError``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torch_automatic_distributed_neural_network_tpu.models import import_hf as J  # noqa: E402
from torch_automatic_distributed_neural_network_tpu_torch.models import import_hf as P  # noqa: E402
from torch_automatic_distributed_neural_network_tpu_torch.models import (  # noqa: E402
    MoE,
    TransformerConfig,
)

JAX_TOL = 1e-5
HF_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(hf):
    """``hf`` with every norm weight and bias drawn (HF initializes them
    to ones and zeros, which would hide a swapped or missing norm)."""
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name.lower() or name.endswith("bias"):
                p.copy_(p + 0.1 * torch.randn(p.shape, generator=g))
    return hf.eval()


def _gpt2():
    cfg = transformers.GPT2Config(
        vocab_size=160, n_positions=64, n_embd=128, n_layer=3, n_head=2,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg)


def _llama(tied=False):
    cfg = transformers.LlamaConfig(
        vocab_size=160, hidden_size=128, intermediate_size=224,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_dropout=0.0, tie_word_embeddings=tied)
    torch.manual_seed(3 if tied else 0)
    return transformers.LlamaForCausalLM(cfg)


def _mistral():
    cfg = transformers.MistralConfig(
        vocab_size=160, hidden_size=128, intermediate_size=224,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=1e6, sliding_window=8,
        attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.MistralForCausalLM(cfg)


def _mixtral():
    cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(7)
    return transformers.MixtralForCausalLM(cfg)


def _bert():
    cfg = transformers.BertConfig(
        vocab_size=180, hidden_size=128, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=224,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu")
    torch.manual_seed(0)
    return transformers.BertForMaskedLM(cfg)


def _vit():
    cfg = transformers.ViTConfig(
        hidden_size=128, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=224, image_size=32, patch_size=8, num_channels=3,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu", num_labels=5)
    torch.manual_seed(0)
    return transformers.ViTForImageClassification(cfg)


# family -> (HF model, port import, JAX import, kwargs)
FAMILIES = {
    "gpt2": (_gpt2, P.import_hf_gpt2, J.import_hf_gpt2, {}),
    "llama_gqa_untied": (_llama, P.import_hf_llama, J.import_hf_llama,
                         {"max_seq_len": 64}),
    "llama_tied": (functools.partial(_llama, True), P.import_hf_llama,
                   J.import_hf_llama, {"max_seq_len": 64}),
    "mistral_window": (_mistral, P.import_hf_llama, J.import_hf_llama, {}),
    "mixtral": (_mixtral, P.import_hf_mixtral, J.import_hf_mixtral, {}),
    "bert": (_bert, P.import_hf_bert, J.import_hf_bert, {}),
    "vit": (_vit, P.import_hf_vit, J.import_hf_vit, {}),
}
EXPORTS = {"gpt2": (P.export_hf_gpt2, J.export_hf_gpt2),
           "llama_gqa_untied": (P.export_hf_llama, J.export_hf_llama),
           "llama_tied": (P.export_hf_llama, J.export_hf_llama),
           "mistral_window": (P.export_hf_llama, J.export_hf_llama),
           "mixtral": (P.export_hf_mixtral, J.export_hf_mixtral),
           "bert": (P.export_hf_bert, J.export_hf_bert)}


@functools.lru_cache(maxsize=None)
def _imported(family):
    """(HF model, the port's model and params, JAX's model and variables)."""
    make, port_import, jax_import, kw = FAMILIES[family]
    hf = _perturbed(make())
    model, params = port_import(hf, dtype=torch.float32, device="cpu", **kw)
    jmodel, variables = jax_import(hf, dtype=jnp.float32, **kw)
    return hf, model, params, jmodel, variables


@functools.lru_cache(maxsize=None)
def _inputs(family):
    rs = np.random.RandomState(sorted(FAMILIES).index(family))
    if family == "vit":
        return {"images": rs.rand(2, 32, 32, 3).astype(np.float32)}
    vocab = _imported(family)[1].cfg.vocab_size
    out = {"tokens": rs.randint(0, vocab, (2, 17))}
    if family == "bert":
        out["segments"] = rs.randint(0, 2, (2, 17))
    return out


def _port_logits(family, model=None):
    model = model or _imported(family)[1]
    x = _inputs(family)
    with torch.no_grad():
        if family == "vit":
            return model(torch.from_numpy(x["images"])).numpy()
        if family == "bert":
            return model(torch.from_numpy(x["tokens"]),
                         segment_ids=torch.from_numpy(x["segments"])).numpy()
        out = model(torch.from_numpy(x["tokens"]))
        return (out[0] if isinstance(out, tuple) else out).numpy()


def _jax_logits(family):
    _, _, _, jmodel, variables = _imported(family)
    x = _inputs(family)
    if family == "vit":
        return np.asarray(jax.jit(jmodel.apply)(variables, x["images"]))
    if family == "bert":
        return np.asarray(jax.jit(jmodel.apply)(
            variables, x["tokens"], x["segments"]))
    out = jax.jit(jmodel.apply)(variables, x["tokens"])
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _hf_logits(family, hf=None):
    hf = hf or _imported(family)[0]
    x = _inputs(family)
    with torch.no_grad():
        if family == "vit":
            return hf(torch.from_numpy(
                x["images"].transpose(0, 3, 1, 2))).logits.numpy()
        if family == "bert":
            return hf(torch.from_numpy(x["tokens"]), token_type_ids=torch
                      .from_numpy(x["segments"])).logits.numpy()
        return hf(torch.from_numpy(x["tokens"])).logits.numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_imported_logits_match_jax_and_hf(family):
    got = _port_logits(family)
    np.testing.assert_allclose(got, _jax_logits(family), atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(got, _hf_logits(family), atol=HF_TOL, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_and_parameters_match_jax(family):
    """The imported config equals JAX's (the fields both have) and every
    parameter is JAX's leaf in the port's layout (the interop map)."""
    from torch_automatic_distributed_neural_network_tpu_torch import interop

    _, model, params, jmodel, variables = _imported(family)
    pc = model.cfg.core if family == "vit" else model.cfg
    jc = jmodel.cfg.core if family == "vit" else jmodel.cfg
    for f in dataclasses.fields(TransformerConfig):
        if f.name not in ("dtype", "attention_impl", "remat_policy"):
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert params == dict(model.named_parameters())
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in params.values())
    carried = interop.from_jax_params(
        jax.tree.map(np.asarray, variables["params"]), model, device="cpu")
    for name, t in carried.state_dict().items():
        assert torch.equal(t, params[name]), name


@pytest.mark.parametrize("family", sorted(EXPORTS))
def test_export_equals_jax_and_round_trips(family):
    hf, model, params, jmodel, variables = _imported(family)
    port_export, jax_export = EXPORTS[family]
    sd = port_export(model)
    jsd = jax_export(jmodel, variables)
    assert sorted(sd) == sorted(jsd)
    for key, arr in jsd.items():
        assert sd[key].dtype == torch.float32
        np.testing.assert_array_equal(sd[key].numpy(), arr, err_msg=key)
    # the export shares no storage with the model
    assert all(t.data_ptr() != p.data_ptr() for t in sd.values()
               for p in params.values())
    # HF -> port -> HF: the source's tensors, bitwise
    hf_sd = hf.state_dict()
    for key, t in sd.items():
        assert torch.equal(t, hf_sd[key].float()), key
    # port -> HF -> port: the parameters, bitwise (a raw state dict: the
    # head counts and what the config carries passed explicitly)
    _, port_import, _, kw = FAMILIES[family]
    kw = dict(kw)
    if family != "gpt2":
        kw["n_heads"] = model.cfg.n_heads
    if family in ("llama_gqa_untied", "llama_tied", "mistral_window",
                  "mixtral"):
        kw.update(n_kv_heads=model.cfg.kv_heads,
                  rope_theta=model.cfg.rope_theta)
    again, again_params = port_import(sd, dtype=torch.float32, device="cpu",
                                      **kw)
    assert sorted(again_params) == sorted(params)
    for name, t in params.items():
        assert torch.equal(again_params[name], t), name


@pytest.mark.parametrize("family", sorted(EXPORTS))
def test_export_loads_into_transformers(family):
    hf, model, _, _, _ = _imported(family)
    fresh = type(hf)(hf.config).eval()
    missing, unexpected = fresh.load_state_dict(EXPORTS[family][0](model),
                                                strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    np.testing.assert_allclose(_hf_logits(family, fresh), _hf_logits(family),
                               atol=JAX_TOL, rtol=0)


def test_export_of_a_mixed_state_takes_its_fp32_masters():
    """Under ``mixed`` the module holds bf16 copies: an export given the
    state's parameters (the fp32 masters) is the source's export
    bitwise; the module alone exports its bf16-rounded weights."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute, next_token_loss)

    hf, model, _, _, _ = _imported("gpt2")
    want = P.export_hf_gpt2(model)
    fresh, _ = P.import_hf_gpt2(hf, dtype=torch.float32, device="cpu")
    ad = AutoDistribute(fresh, loss_fn=next_token_loss, precision="mixed",
                        device="cpu")
    state = ad.init(None)
    assert fresh.embed.dtype == torch.bfloat16
    got = P.export_hf_gpt2(fresh, state.params)
    rounded = P.export_hf_gpt2(fresh)
    for key, t in want.items():
        assert torch.equal(got[key], t), key
        assert torch.equal(rounded[key], t.to(torch.bfloat16).float()), key


def test_mixtral_imports_at_the_no_drop_capacity():
    _, model, _, jmodel, _ = _imported("mixtral")
    assert model.cfg.n_experts == 4 and model.cfg.top_k == 2
    assert model.cfg.capacity_factor == jmodel.cfg.capacity_factor == 2.0
    _port_logits("mixtral")
    for layer in model.layers:
        assert float(layer.mlp.metrics["dropped_fraction"]) == 0.0


def test_mistral_window_binds():
    _, model, params, _, _ = _imported("mistral_window")
    assert model.cfg.sliding_window == 8 and model.cfg.rope_theta == 1e6
    assert model.cfg.norm_eps == pytest.approx(1e-6)
    with torch.device("meta"):
        full = type(model)(dataclasses.replace(model.cfg,
                                               sliding_window=None))
    full.load_state_dict(params, assign=True)
    assert np.abs(_port_logits("mistral_window", full)
                  - _port_logits("mistral_window")).max() > 1e-2


def test_tied_and_bare_heads_as_jax():
    assert _imported("llama_tied")[1].cfg.tie_embeddings is True
    assert "lm_head" not in _imported("llama_tied")[2]
    assert _imported("llama_gqa_untied")[1].cfg.tie_embeddings is False
    assert _imported("llama_gqa_untied")[1].cfg.kv_heads == 2
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=96,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=32, tie_word_embeddings=False)
    bare = transformers.LlamaModel(cfg)
    model, params = P.import_hf_llama(bare, max_seq_len=32, device="cpu")
    jmodel, _ = J.import_hf_llama(bare, max_seq_len=32)
    assert model.cfg.tie_embeddings is jmodel.cfg.tie_embeddings is True
    assert "lm_head" not in params
    # a raw state dict with a head equal to the embedding: tied by value
    sd = {k: v for k, v in _imported("llama_tied")[0].state_dict().items()}
    model, _ = P.import_hf_llama(sd, n_heads=4, n_kv_heads=2, device="cpu")
    assert model.cfg.tie_embeddings is True


def test_gpt2_head_count_sources():
    cfg = transformers.GPT2Config(vocab_size=64, n_positions=32, n_embd=256,
                                  n_layer=1, n_head=8)
    hf = transformers.GPT2LMHeadModel(cfg)
    assert P.import_hf_gpt2(hf, device="cpu")[0].cfg.n_heads == 8
    assert P.import_hf_gpt2(hf.state_dict(), device="cpu")[0].cfg.n_heads == 4


def test_bare_encoders_get_jax_defaults():
    """A bare BertModel gets the identity MLM head, a ViT without a
    classifier a zero one of one class, as JAX's imports."""
    bert = transformers.BertModel(_bert().config)
    model, params = P.import_hf_bert(bert, device="cpu")
    jp = J.import_hf_bert(bert)[1]["params"]
    want = {"mlm_dense.weight": np.asarray(jp["mlm_dense"]["kernel"]).T,
            "mlm_dense.bias": jp["mlm_dense"]["bias"],
            "mlm_norm.scale": jp["mlm_norm"]["scale"],
            "mlm_norm.bias": jp["mlm_norm"]["bias"],
            "mlm_bias": jp["mlm_bias"]}
    for name, arr in want.items():
        np.testing.assert_array_equal(params[name].detach().numpy(), arr,
                                      err_msg=name)
    vit = transformers.ViTModel(_vit().config, add_pooling_layer=False)
    model, params = P.import_hf_vit(vit, device="cpu")
    assert model.cfg.num_classes == 1
    assert not params["classifier.weight"].any()


def test_refusals_as_jax():
    hf = _imported("llama_gqa_untied")[0]
    for importer in (P.import_hf_llama, J.import_hf_llama):
        with pytest.raises(ValueError, match="n_heads"):
            importer(hf.state_dict(), max_seq_len=32)
    bert = _imported("bert")[0]
    for importer in (P.import_hf_bert, J.import_hf_bert):
        with pytest.raises(ValueError, match="n_heads"):
            importer(bert.state_dict())
    relu = transformers.BertForMaskedLM(transformers.BertConfig(
        **{**bert.config.to_dict(), "hidden_act": "relu"}))
    for importer in (P.import_hf_bert, J.import_hf_bert):
        with pytest.raises(ValueError, match="hidden_act"):
            importer(relu)
    with pytest.raises(ValueError, match="swiglu"):
        P.export_hf_mixtral(MoE("test", act="gelu", vocab_size=64))


def test_import_holds_no_storage_of_the_source():
    """The imported parameters are copies: training the port's model
    leaves the HF model as it was."""
    hf, _, params, _, _ = _imported("gpt2")
    ptrs = {t.data_ptr() for t in hf.state_dict().values()}
    assert not any(p.data_ptr() in ptrs for p in params.values())
