"""Memory-bounded end-to-end MIL: streaming attention pooling over chunks
(PyTorch port of ``moc_tpu/train/accum.py``).

Attention-MIL pooling is a softmax-weighted mean, so it streams exactly as
flash attention does: a loop over patch chunks carrying the running (max,
sum of exponentials, weighted sum) triple. With ``remat`` each chunk's step
runs under ``torch.utils.checkpoint`` (non-reentrant), so the backward
recomputes one chunk's encoder activations at a time: exact forward and
gradients, peak activation memory O(chunk × encoder) instead of O(bag ×
encoder). JAX runs the loop as one ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

NEG_INF = -1e30


def streaming_attention_pool(embed_fn: Callable[[torch.Tensor], torch.Tensor],
                             score_fn: Callable[[torch.Tensor], torch.Tensor],
                             chunks: torch.Tensor, chunk_valid: torch.Tensor, *,
                             remat: bool = True):
    """Exact masked attention pooling ``M = Σᵢ softmax(score(hᵢ))·hᵢ`` over a
    chunked bag.

    ``embed_fn``: a chunk ``[Ck, ...]`` → embeddings ``[Ck, D]`` (gradients
    flow through it); ``score_fn``: ``[Ck, D]`` → raw scores ``[Ck]`` (or
    ``[Ck, 1]``); ``chunks [K, Ck, ...]`` with validity ``chunk_valid [K,
    Ck]``. Returns ``(pooled [D], logsumexp scalar)``; an all-pad bag pools
    to zeros."""

    def step(m, s, acc, x, v):
        h = embed_fn(x)
        # zero (not just down-weight) invalid rows: pads may hold NaN/inf and
        # 0·NaN = NaN
        h = torch.where(v[:, None], h, 0.0)
        a = torch.where(v, score_fn(h).reshape(-1), NEG_INF)
        m_new = torch.maximum(m, torch.amax(a))
        scale = torch.exp(m - m_new)
        e = torch.where(v, torch.exp(a - m_new), 0.0)  # pads contribute exactly 0
        return m_new, s * scale + torch.sum(e), acc * scale + e @ h

    dev = chunks.device
    m = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((), dtype=torch.float32, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)  # broadcasts to [D] at once
    for x, v in zip(chunks, chunk_valid):
        if remat and torch.is_grad_enabled():
            m, s, acc = torch.utils.checkpoint.checkpoint(step, m, s, acc, x, v,
                                                          use_reentrant=False)
        else:
            m, s, acc = step(m, s, acc, x, v)
    s = torch.clamp(s, min=1e-30)
    return acc / s, m + torch.log(s)


def chunk_bag(feats: torch.Tensor, valid: torch.Tensor, chunk: int):
    """Split ``[N, ...]`` into ``[K, chunk, ...]`` (zero-padded) plus the
    matching ``[K, chunk]`` validity."""
    n = feats.shape[0]
    k = -(-n // chunk)
    pad = k * chunk - n
    feats = torch.cat([feats, feats.new_zeros((pad,) + tuple(feats.shape[1:]))])
    valid = torch.cat([valid, valid.new_zeros((pad,))])
    return feats.reshape((k, chunk) + tuple(feats.shape[1:])), valid.reshape(k, chunk)
