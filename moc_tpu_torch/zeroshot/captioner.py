"""The CoCa caption decoder: autoregressive text over the vision tower's
caption tokens (PyTorch port of ``moc_tpu/zeroshot/captioner.py``).

A token embedding, learned positions, a causal ``nn.decoder.Decoder`` whose
layers cross-attend the ``[B, 256, width]`` caption tokens of
``zeroshot.vision_tower.VisionTower`` (its ``attn_pool_caption`` and
``ln_caption``), and an LM head. ``caption_loss`` is the shifted
cross-entropy over non-pad targets; ``generate_caption`` decodes greedily,
by beam search or by top-k / top-p sampling (from a ``torch.Generator``).
No kernel runs here: the decoder's attention is a dense masked softmax, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from moc_tpu_torch.models.layers import softmax_cross_entropy
from moc_tpu_torch.nn.decoder import (Decoder, DecoderConfig, beam_generate, greedy_generate,
                                      sample_generate)


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    """``eot_id`` defaults to the largest id, the CONCH tokenizer's EOT."""
    vocab_size: int = 32007
    width: int = 768
    layers: int = 12
    heads: int = 12
    context_length: int = 128
    sot_id: int = 1
    eot_id: int = 32006


class CoCaCaptioner(nn.Module):
    def __init__(self, cfg: CaptionerConfig = CaptionerConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.positional_embedding = nn.Parameter(torch.zeros(c.context_length, c.width))
        self.decoder = Decoder(DecoderConfig(embed_dim=c.width, ffn_dim=4 * c.width,
                                             layers=c.layers, heads=c.heads,
                                             cross_attention=True))
        self.lm_head = nn.Linear(c.width, c.vocab_size)

    def forward(self, token_ids, caption_tokens, caption_mask=None):
        """Teacher-forced next-token logits ``[B, L, vocab]`` of ``token_ids
        [B, L]`` over caption tokens ``[B, N, width]`` (``caption_mask`` True
        at valid tokens)."""
        x = self.token_embedding(token_ids) + self.positional_embedding[: token_ids.shape[1]]
        h, _ = self.decoder(x, caption_tokens, caption_mask)
        return self.lm_head(h)

    def caption_loss(self, token_ids, caption_tokens, pad_id: int = 0, caption_mask=None):
        """The shifted cross-entropy over the targets that are not ``pad_id``."""
        logits = self(token_ids[:, :-1], caption_tokens, caption_mask)
        targets = token_ids[:, 1:]
        ce = softmax_cross_entropy(logits, targets)
        w = (targets != pad_id).to(torch.float32)
        return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


@torch.no_grad()
def generate_caption(captioner: CoCaCaptioner, caption_tokens: torch.Tensor, *,
                     seq_len: int = 30, mode: str = "greedy",
                     generator: torch.Generator | None = None, beam_size: int = 4,
                     length_penalty: float = 1.0, top_k: int | None = 1,
                     top_p: float | None = None, temperature: float = 1.0,
                     min_seq_len: int = 5, repetition_penalty: float = 1.0,
                     caption_mask=None) -> torch.Tensor:
    """Caption token ids ``[B, seq_len]`` from caption tokens ``[B, N,
    width]``: ``mode`` is ``greedy``, ``beam`` or ``sample`` (which needs
    ``generator``), with ``coca_model.generate``'s defaults (``min_seq_len``
    5, ``repetition_penalty`` 1)."""
    cfg = captioner.cfg
    batch = caption_tokens.shape[0]

    def embed_fn(tokens, idx):
        emb = captioner.token_embedding(tokens) + captioner.positional_embedding[idx]
        return emb[:, None, :]

    def logits_fn(h):
        return captioner.lm_head(h[:, 0])

    common = dict(batch=batch, seq_len=seq_len, bos_id=cfg.sot_id, eos_id=cfg.eot_id,
                  memory=caption_tokens, memory_mask=caption_mask)
    if mode == "greedy":
        return greedy_generate(captioner.decoder, embed_fn, logits_fn, **common)
    if mode == "beam":
        return beam_generate(captioner.decoder, embed_fn, logits_fn, beam_size=beam_size,
                             length_penalty=length_penalty, **common)
    if mode != "sample":
        raise ValueError(f"unknown mode {mode!r}: greedy, beam or sample")
    if generator is None:
        raise ValueError("mode='sample' needs a torch.Generator")
    return sample_generate(captioner.decoder, embed_fn, logits_fn, generator, top_k=top_k,
                           top_p=top_p, temperature=temperature, min_len=min_seq_len,
                           repetition_penalty=repetition_penalty,
                           vocab_size=cfg.vocab_size if repetition_penalty != 1.0 else None,
                           **common)
