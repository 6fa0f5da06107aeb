"""Text -> token file, the port of the JAX package's ``data/text.py``
(pure numpy, copied): tokenization is one offline step that writes the
native loader's TADN flat token file (``data/loader.py``), so the
training hot path never touches Python string processing.

- :class:`ByteTokenizer`: a dependency-free byte-level tokenizer (vocab
  = 256 bytes + BOS/EOS), always available;
- :func:`load_tokenizer`: a ``transformers`` tokenizer by name or local
  path (``transformers`` is imported only then), else the byte one;
- :func:`tokenize_file`: streams a UTF-8 text file into a token file in
  bounded memory; ``python -m torch_automatic_distributed_neural_network_tpu_torch
  tokenize`` (``cli.py``).
"""

from __future__ import annotations

import sys
from typing import Any, Iterable

import numpy as np

from .loader import TokenFileWriter


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..255 are raw bytes, 256 = BOS,
    257 = EOS.  Lossless on any input, no vocabulary files needed."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if i < 256).decode(
            "utf-8", errors="replace")


def load_tokenizer(name: str | None = None) -> Any:
    """A tokenizer with ``.encode(str) -> list[int]``.

    ``name``: a ``transformers`` tokenizer name or local path; None (or
    'byte') gives :class:`ByteTokenizer`.  Local files are tried first
    (``local_files_only=True``), so an offline machine fails fast rather
    than hanging on a download."""
    if name in (None, "byte"):
        return ByteTokenizer()
    from transformers import AutoTokenizer

    try:
        return AutoTokenizer.from_pretrained(name, local_files_only=True)
    except Exception:
        return AutoTokenizer.from_pretrained(name)


def _encode(tok: Any, text: str) -> list[int]:
    """Encode WITHOUT special tokens: HF tokenizers insert [CLS]/[SEP]/BOS
    per ``encode`` call by default, which would corrupt the stream at
    every chunk boundary."""
    try:
        return tok.encode(text, add_special_tokens=False)
    except TypeError:
        return tok.encode(text)


def tokenize_file(
    input_path: str,
    output_path: str,
    *,
    tokenizer: Any | None = None,
    append_eos: bool = True,
    chunk_chars: int = 1 << 20,
    log: bool = True,
) -> int:
    """Stream ``input_path`` (UTF-8 text) into a TADN token file in
    bounded memory; returns the token count.

    Reads ``chunk_chars``-character chunks cut at line boundaries (so
    multi-byte sequences and BPE merges never straddle a cut mid-line),
    encodes each WITHOUT per-chunk special tokens and appends it to the
    output (``TokenFileWriter`` patches the header count on close), then
    one EOS where the tokenizer has one and ``append_eos`` is set.  The
    file holds uint16 ids when the vocabulary fits, else uint32."""
    tok = tokenizer if tokenizer is not None else ByteTokenizer()
    eos = getattr(tok, "eos_id", None)
    if eos is None:
        eos = getattr(tok, "eos_token_id", None)
    vocab = getattr(tok, "vocab_size", None)
    dtype = np.uint16 if (vocab is not None and vocab <= 2**16) else np.uint32
    with TokenFileWriter(output_path, dtype=dtype) as writer:
        with open(input_path, "r", encoding="utf-8", errors="replace") as f:
            buf = ""
            while True:
                chunk = f.read(chunk_chars)
                if not chunk:
                    break
                buf += chunk
                # cut at the last newline; the tail waits for the next chunk
                cut = buf.rfind("\n")
                if cut == -1:
                    continue
                writer.append(_encode(tok, buf[: cut + 1]))
                buf = buf[cut + 1:]
            if buf:
                writer.append(_encode(tok, buf))
        if append_eos and eos is not None:
            writer.append([eos])
        total = writer.n_tokens
    if log:
        print(f"tokenized {input_path} -> {output_path}: {total:,} tokens "
              f"(vocab {vocab if vocab is not None else '?'})",
              file=sys.stderr)
    return total
