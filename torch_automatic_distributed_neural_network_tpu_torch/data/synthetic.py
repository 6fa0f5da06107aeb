"""Synthetic LM data: the JAX package's ``data/synthetic.py::SyntheticLM``,
copied.  It is numpy from a seed, so both packages see the very same
batches."""

from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Deterministic token stream (GPT-2 / Llama shaped): a noisy copy task
    (next token depends on the previous one) so LM loss is reducible."""

    step_indexed = True  # Trainer protocol: .batch(i) is keyed by step

    def __init__(
        self,
        vocab_size: int = 32000,
        seq_len: int = 1024,
        batch_size: int = 8,
        seed: int = 0,
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed

    def batch(self, step: int) -> dict:
        rng = np.random.RandomState(self.seed + step + 1)
        first = rng.randint(0, self.vocab_size, size=(self.batch_size, 1))
        steps = rng.randint(0, 17, size=(self.batch_size, self.seq_len - 1))
        toks = np.concatenate(
            [first, np.cumsum(steps, axis=-1) + first], axis=-1
        ) % self.vocab_size
        return {"input_ids": toks.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
