"""Decoder model families (GPT-2, Llama) on the shared core."""

from .gpt2 import GPT2, gpt2_config
from .llama import Llama, llama_config
from .transformer_core import DecoderLM, TransformerConfig

__all__ = ["GPT2", "DecoderLM", "Llama", "TransformerConfig",
           "gpt2_config", "llama_config"]
