"""Inference: KV-cached decoding, int8 KV storage, and the serving
engine (``inference/serve``)."""
