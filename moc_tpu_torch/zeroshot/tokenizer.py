"""The CONCH tokenization protocol: pad to 127 ids, append one placeholder
pad (a copy of ``moc_tpu/zeroshot/tokenizer.py``; numpy).

The vocabulary file (a byte-level BPE ``tokenizer.json``) ships with the
CONCH release, not with this repository: pass its path as
``tokenizer_file``, which is read through ``transformers``. Without one, a
deterministic hash vocabulary gives the same ids as the JAX package's, for
tests and for runs without the released files.
"""

from __future__ import annotations

import numpy as np

CONTEXT_LEN = 128  # model context; the last slot is the CLS embedding's
TEXT_LEN = 127  # ids produced per prompt
HASH_VOCAB = 32007  # the CONCH vocabulary size


class ConchTokenizer:
    """A ``tokenizer.json`` (or the hash vocabulary) with the 127 + 1
    padding protocol."""

    def __init__(self, tokenizer_file: str | None = None, pad_id: int = 0):
        self.pad_id = pad_id
        self._tk = None
        if tokenizer_file is not None:
            try:
                from transformers import PreTrainedTokenizerFast
            except ImportError as e:
                raise ImportError(
                    f"--tokenizer_file {tokenizer_file!r} is read through the transformers "
                    "package, which does not import on this host; install it, or leave "
                    "--tokenizer_file out for the hash vocabulary") from e
            self._tk = PreTrainedTokenizerFast(tokenizer_file=tokenizer_file,
                                               bos_token="<start_of_text>",
                                               eos_token="<end_of_text>", pad_token="<pad>")
            self.pad_id = self._tk.pad_token_id

    def __call__(self, texts: list[str]) -> np.ndarray:
        """texts → int32 ids ``[B, 128]`` (127 slots + the placeholder pad)."""
        if self._tk is not None:
            enc = self._tk.batch_encode_plus(texts, max_length=TEXT_LEN, add_special_tokens=True,
                                             return_token_type_ids=False, truncation=True,
                                             padding="max_length")
            ids = np.asarray(enc["input_ids"], dtype=np.int32)
        else:
            ids = np.stack([self._hash_encode(t) for t in texts])
        placeholder = np.full((ids.shape[0], 1), self.pad_id, np.int32)
        return np.concatenate([ids, placeholder], axis=1)

    def _hash_encode(self, text: str, vocab_size: int = HASH_VOCAB) -> np.ndarray:
        """Each lower-cased word to a stable bucket of its UTF-8 bytes, in
        ``[3, vocab_size - 1)``, between BOS 1 and EOS ``vocab_size - 1`` (the
        largest id, as in the real vocabulary); at most 125 words."""
        words = text.lower().split()[: TEXT_LEN - 2]
        ids = [1]
        for w in words:
            h = 0
            for ch in w.encode():
                h = (h * 131 + ch) % (vocab_size - 4)
            ids.append(3 + h)
        ids.append(vocab_size - 1)
        out = np.full((TEXT_LEN,), self.pad_id, np.int32)
        out[: len(ids)] = np.asarray(ids[:TEXT_LEN], np.int32)
        return out
