"""MUSK text tokenization (a copy of ``moc_tpu/zeroshot/musk_tokenizer.py``;
numpy).

The XLM-Roberta sentencepiece protocol: encode, truncate to ``max_len - 2``,
wrap in ``<s> … </s>``, right-pad with the pad id, and return a padding mask
(True on pad positions, torchscale's convention). The sentencepiece model
ships with the MUSK release, not with this repository: pass its path as
``tokenizer_file``, which is read through ``transformers``. Without one, a
deterministic hash vocabulary gives the same ids as the JAX package's.
"""

from __future__ import annotations

import numpy as np


class MuskTokenizer:
    """``texts -> (ids [B, max_len] int32, padding_mask [B, max_len] bool)``."""

    def __init__(self, tokenizer_file: str | None = None, max_len: int = 100,
                 vocab_size: int = 64010):
        self.max_len = max_len
        self.vocab_size = vocab_size
        self._tk = None
        if tokenizer_file is not None:
            try:
                from transformers import XLMRobertaTokenizer
            except ImportError as e:
                raise ImportError(
                    f"tokenizer_file {tokenizer_file!r} is read through the transformers "
                    "package, which does not import on this host; install it, or leave "
                    "tokenizer_file out for the hash vocabulary") from e
            self._tk = XLMRobertaTokenizer(tokenizer_file)
        self.bos_id = 0 if self._tk is None else self._tk.bos_token_id
        self.eos_id = 2 if self._tk is None else self._tk.eos_token_id
        self.pad_id = 1 if self._tk is None else self._tk.pad_token_id

    def __call__(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), self.max_len), self.pad_id, np.int32)
        pad_mask = np.ones((len(texts), self.max_len), bool)
        for i, text in enumerate(texts):
            if self._tk is not None:
                tokens = self._tk.encode(text, add_special_tokens=False)
            else:
                tokens = self._hash_encode(text)
            tokens = tokens[: self.max_len - 2]
            row = [self.bos_id] + list(tokens) + [self.eos_id]
            ids[i, : len(row)] = row
            pad_mask[i, : len(row)] = False
        return ids, pad_mask

    def _hash_encode(self, text: str) -> list[int]:
        """One id in [3, vocab_size - 1) per lower-cased whitespace word."""
        out = []
        for w in text.lower().split():
            h = 0
            for ch in w.encode():
                h = (h * 131 + ch) % (self.vocab_size - 4)
            out.append(3 + h)
        return out
