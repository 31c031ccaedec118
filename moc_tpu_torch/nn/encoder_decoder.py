"""Seq2seq: the encoder stack and a cross-attending decoder (PyTorch port of
``moc_tpu/nn/encoder_decoder.py``).

Source tokens go through ``nn.encoder.Encoder`` (its flash path: K2 forward
and K3/K4 backward on the GPU), target tokens through the causal
``nn.decoder.Decoder`` cross-attending the encoder's output, and a
bias-free projection gives the vocabulary logits. ``share_all_embeddings``
makes the target reuse the source table and ties the projection to it;
``share_decoder_input_output_embed`` ties the projection to the target
table. A shared table is held once, under ``src_embed``, as flax holds it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from moc_tpu_torch.nn.decoder import Decoder, DecoderConfig
from moc_tpu_torch.nn.encoder import Encoder, EncoderConfig


@dataclasses.dataclass(frozen=True)
class EncoderDecoderConfig:
    src_vocab: int = 1024
    tgt_vocab: int = 1024
    max_len: int = 512
    share_all_embeddings: bool = False
    share_decoder_input_output_embed: bool = False
    encoder: EncoderConfig = EncoderConfig(embed_dim=256, ffn_dim=1024, layers=4, heads=8)
    decoder: DecoderConfig = DecoderConfig(embed_dim=256, ffn_dim=1024, layers=4, heads=8,
                                           cross_attention=True)


class EncoderDecoder(nn.Module):
    def __init__(self, cfg: EncoderDecoderConfig = EncoderDecoderConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        self.src_embed = nn.Embedding(c.src_vocab, c.encoder.embed_dim)
        if c.share_all_embeddings:
            if c.src_vocab != c.tgt_vocab or c.encoder.embed_dim != c.decoder.embed_dim:
                raise ValueError("share_all_embeddings needs one vocabulary and one width")
            self.tgt_embed = None
        else:
            self.tgt_embed = nn.Embedding(c.tgt_vocab, c.decoder.embed_dim)
        self.src_pos = nn.Parameter(torch.zeros(c.max_len, c.encoder.embed_dim))
        self.tgt_pos = nn.Parameter(torch.zeros(c.max_len, c.decoder.embed_dim))
        self.encoder = Encoder(c.encoder)
        self.decoder = Decoder(c.decoder)
        self.output_projection = (None if self._tied()
                                  else nn.Linear(c.decoder.embed_dim, c.tgt_vocab, bias=False))

    def _tied(self) -> bool:
        return self.cfg.share_all_embeddings or self.cfg.share_decoder_input_output_embed

    def _tgt_table(self) -> nn.Embedding:
        return self.src_embed if self.tgt_embed is None else self.tgt_embed

    def project(self, h):
        """Vocabulary logits of decoder states ``h``."""
        if self._tied():
            return h @ self._tgt_table().weight.T
        return self.output_projection(h)

    def encode(self, src_ids, src_padding_mask=None):
        """``(memory [B, Ls, D], moe_aux)``; ``src_padding_mask`` True = pad."""
        x = self.src_embed(src_ids) + self.src_pos[: src_ids.shape[1]]
        return self.encoder(x, src_padding_mask)

    def forward(self, src_ids, tgt_ids, src_padding_mask=None):
        """Teacher-forced ``(logits [B, Lt, tgt_vocab], moe_aux)``."""
        memory, aux = self.encode(src_ids, src_padding_mask)
        memory_valid = None if src_padding_mask is None else ~src_padding_mask
        y = self._tgt_table()(tgt_ids) + self.tgt_pos[: tgt_ids.shape[1]]
        h, _ = self.decoder(y, memory, memory_valid)
        return self.project(h), aux
