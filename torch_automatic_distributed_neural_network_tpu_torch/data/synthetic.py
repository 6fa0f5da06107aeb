"""Synthetic datasets standing in for the example datasets (MNIST /
CIFAR-10 / WMT14 / LM corpora): the JAX package's ``data/synthetic.py``,
copied.  They are numpy from a seed, so both packages see the very same
batches; ``AutoDistribute`` moves them to the device."""

from __future__ import annotations

import numpy as np


class SyntheticClassification:
    """Deterministic image-classification stream (MNIST/CIFAR shaped).

    A fixed random linear teacher makes the task learnable so example
    loss curves actually decrease.
    """

    step_indexed = True  # Trainer protocol: .batch(i) is keyed by step

    def __init__(
        self,
        image_shape: tuple[int, ...] = (28, 28, 1),
        num_classes: int = 10,
        batch_size: int = 128,
        seed: int = 0,
    ):
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed)
        dim = int(np.prod(image_shape))
        self._teacher = np.random.RandomState(1234).randn(dim, num_classes) * 0.5

    def batch(self, step: int) -> dict:
        rng = np.random.RandomState(self._rng.randint(0, 2**31) if step is None
                                    else step + 1)
        x = rng.randn(self.batch_size, *self.image_shape).astype(np.float32)
        logits = x.reshape(self.batch_size, -1) @ self._teacher
        label = np.argmax(logits + 0.1 * rng.randn(*logits.shape), axis=-1)
        return {"x": x, "label": label.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


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


class SyntheticSeq2Seq:
    """Machine-translation shaped pairs (WMT14 stand-in): target is a
    deterministic transform (reverse + offset) of the source."""

    def __init__(
        self,
        vocab_size: int = 32000,
        src_len: int = 64,
        tgt_len: int = 64,
        batch_size: int = 64,
        seed: int = 0,
    ):
        self.vocab_size = vocab_size
        self.src_len = src_len
        self.tgt_len = tgt_len
        self.batch_size = batch_size
        self.seed = seed

    def batch(self, step: int) -> dict:
        rng = np.random.RandomState(self.seed + step + 1)
        src = rng.randint(
            2, self.vocab_size, size=(self.batch_size, self.src_len)
        )
        tgt = (src[:, ::-1] + 7) % self.vocab_size
        tgt = tgt[:, : self.tgt_len]
        return {
            "src": src.astype(np.int32),
            "tgt": tgt.astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class SyntheticMLM:
    """BERT-shaped masked-LM batches: the SyntheticLM cumsum stream with
    15% of positions masked out (80% [MASK], 10% random, 10% kept — the
    BERT recipe), labels carrying the original token at masked positions
    and -100 (ignore) elsewhere."""

    step_indexed = True

    def __init__(
        self,
        vocab_size: int = 30522,
        seq_len: int = 128,
        batch_size: int = 8,
        mask_token: int = 103,  # BERT's [MASK]
        mask_rate: float = 0.15,
        seed: int = 0,
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.mask_token = mask_token
        self.mask_rate = mask_rate
        self.seed = seed

    def batch(self, step: int) -> dict:
        # same learnable cumsum stream as SyntheticLM (ONE recipe — the
        # LM and MLM streams must not silently diverge), masked on top
        toks = SyntheticLM(
            self.vocab_size, self.seq_len, self.batch_size, self.seed
        ).batch(step)["input_ids"]
        rng = np.random.RandomState(self.seed + step + 1)
        pick = rng.random(toks.shape) < self.mask_rate
        labels = np.where(pick, toks, -100)
        kind = rng.random(toks.shape)
        inputs = toks.copy()
        inputs[pick & (kind < 0.8)] = self.mask_token
        rand_pos = pick & (kind >= 0.8) & (kind < 0.9)
        inputs[rand_pos] = rng.randint(
            0, self.vocab_size, size=int(rand_pos.sum())
        )
        return {
            "input_ids": inputs.astype(np.int32),
            "labels": labels.astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
