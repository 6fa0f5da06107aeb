"""The port's model zoo on the shared core: the decoder families (GPT-2,
Llama), BERT, ViT, the MT Transformer, MoE (at expert degree 1) and the
MNIST MLP."""

from .bert import Bert, BertClassifier, BertEncoder, bert_config
from .gpt2 import GPT2, gpt2_config
from .llama import Llama, llama_config
from .mlp import MLP
from .moe import MoE, MoEConfig, MoELM, moe_config
from .transformer_core import DecoderLM, TransformerConfig
from .transformer_mt import Seq2SeqTransformer, TransformerMT
from .vit import ViT, ViTConfig, ViTEncoder, vit_config

__all__ = [
    "MLP", "Bert", "BertClassifier", "BertEncoder", "bert_config", "GPT2",
    "gpt2_config", "Llama", "llama_config", "MoE", "MoEConfig", "MoELM",
    "moe_config", "DecoderLM", "TransformerConfig", "Seq2SeqTransformer",
    "TransformerMT", "ViT", "ViTConfig", "ViTEncoder", "vit_config",
]
