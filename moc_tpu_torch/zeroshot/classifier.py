"""Zero-shot classifier weights with an on-disk cache (PyTorch port of
``moc_tpu/zeroshot/classifier.py``).

For every class, the alias × template prompts go through the text tower
(L2-normalised embeddings); their mean over (aliases × templates) is
renormalised, and the class columns stack into ``W [D, C]``. The mean and
the renormalisation run in numpy in the JAX package's order, so identical
embeddings give a bit-identical ``W``. The cache is an ``.npz`` with the key
``weights``, which both packages read and write.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from moc_tpu_torch.zeroshot.prompts import PromptBank
from moc_tpu_torch.zeroshot.tokenizer import ConchTokenizer

EncodeText = Callable[[np.ndarray], np.ndarray]


def build_zero_shot_classifier(encode_text: EncodeText, tokenizer: ConchTokenizer,
                               bank: PromptBank) -> np.ndarray:
    """``encode_text``: token ids ``[B, 128]`` → L2-normalised ``[B, D]``
    (numpy, or anything ``np.asarray`` takes). Returns f32 ``W [D, C]``."""
    class_embeddings = []
    for c in range(bank.n_classes):
        per_alias = [np.asarray(encode_text(tokenizer(texts)))
                     for texts in bank.texts_for_class(c)]
        mean = np.stack(per_alias).mean(axis=(0, 1))
        mean /= np.linalg.norm(mean)
        class_embeddings.append(mean)
    return np.stack(class_embeddings, axis=1).astype(np.float32)


def cached_zero_shot_classifier(cache_path: str, encode_text: EncodeText,
                                tokenizer: ConchTokenizer, bank: PromptBank, *,
                                use_cache: bool = True) -> np.ndarray:
    """``W`` from ``cache_path`` when ``use_cache`` and it exists; else built
    by ``build_zero_shot_classifier`` and written there."""
    if use_cache and os.path.exists(cache_path):
        with np.load(cache_path) as f:
            return f["weights"]
    w = build_zero_shot_classifier(encode_text, tokenizer, bank)
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez(cache_path, weights=w)
    return w


def make_encode_text_fn(model, device: str | torch.device | None = None) -> EncodeText:
    """``encode_text`` over a ``CoCa`` on ``device`` (the model's own when
    None): ids in, L2-normalised f32 embeddings out as numpy. Runs without
    autograd and in full f32, TF32 off: a few ulp in ``W`` already flip
    near-tied selections at the top-j boundary."""
    from moc_tpu_torch.moc.core import _full_f32

    dev = next(model.parameters()).device if device is None else torch.device(device)

    def encode(ids: np.ndarray) -> np.ndarray:
        _full_f32()
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
            return model.encode_text(x).float().cpu().numpy()

    return encode
