"""The port's model zoo on the shared core: the decoder families (GPT-2,
Llama), BERT, ViT, the MT Transformer, MoE and the MNIST MLP, and ResNet
with BatchNorm; and the migration path from torch: the HF imports and
exports (``import_hf.py``) and ``from_torch`` (``torch_bridge.py``)."""

from .bert import Bert, BertClassifier, BertEncoder, bert_config
from .gpt2 import GPT2, gpt2_config
from .import_hf import (
    export_hf_bert,
    export_hf_gpt2,
    export_hf_llama,
    export_hf_mixtral,
    import_hf_bert,
    import_hf_gpt2,
    import_hf_llama,
    import_hf_mixtral,
    import_hf_vit,
)
from .llama import Llama, llama_config
from .mlp import MLP
from .moe import MoE, MoEConfig, MoELM, moe_config
from .resnet import ResNet, ResNet18Thin, ResNet50, ResNetConfig
from .torch_bridge import TorchBridge, UnsupportedTorchModule, from_torch
from .transformer_core import DecoderLM, TransformerConfig
from .transformer_mt import Seq2SeqTransformer, TransformerMT
from .vit import ViT, ViTConfig, ViTEncoder, vit_config

__all__ = [
    "MLP", "Bert", "BertClassifier", "BertEncoder", "bert_config", "GPT2",
    "gpt2_config", "Llama", "llama_config", "MoE", "MoEConfig", "MoELM",
    "moe_config", "ResNet", "ResNet18Thin", "ResNet50", "ResNetConfig",
    "DecoderLM", "TransformerConfig", "Seq2SeqTransformer",
    "TransformerMT", "ViT", "ViTConfig", "ViTEncoder", "vit_config",
    "TorchBridge", "UnsupportedTorchModule", "from_torch", "export_hf_bert",
    "export_hf_gpt2", "export_hf_llama", "export_hf_mixtral",
    "import_hf_bert", "import_hf_gpt2", "import_hf_llama",
    "import_hf_mixtral", "import_hf_vit",
]
