"""CONCH text tower: a 12-layer transformer with an appended CLS slot
(PyTorch port of ``moc_tpu/zeroshot/text_tower.py``).

The conch_ViT-B-16 text configuration: context 128, vocabulary 32007, width
768, 12 heads, 12 layers, output 512, pad id 0. The open_clip quirks a
pretrained checkpoint depends on are reproduced exactly:

* the input is 127 token ids; a learned ``cls_emb`` is appended as
  position 127;
* the attention mask is causal, and the CLS row (only it) also masks pad
  columns, with the non-pad window **shifted right by one column**: column
  0 is always open, and column j opens iff ``token_ids[:, j - 1]`` is not
  pad;
* the pooled output is ``ln_final`` of the last (CLS) position, projected
  by ``text_projection`` into the 512-d contrastive space.

Attention is dense (an additive mask rules out flash), with exact GELU and
LayerNorm eps 1e-5, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from moc_tpu_torch.nn.transformer import LayerNorm, Transformer


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 128  # includes the appended CLS slot
    vocab_size: int = 32007
    width: int = 768
    heads: int = 12
    layers: int = 12
    output_dim: int = 512
    pad_id: int = 0


def text_attention_mask(token_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Additive mask ``[B, 1, L + 1, L + 1]`` (0 or −inf) for ``token_ids
    [B, L]`` plus the CLS slot: causal on every row; on the CLS row also the
    pad columns, shifted right by one (column 0 open, column j open iff
    ``token_ids[:, j - 1] != pad_id``)."""
    b, seq = token_ids.shape
    full = seq + 1
    dev = token_ids.device
    causal = torch.ones((full, full), dtype=torch.bool, device=dev).tril()
    col_ok = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                        token_ids != pad_id], dim=1)  # [B, full]
    not_cls = torch.arange(full, device=dev) != full - 1
    allowed = causal & (col_ok[:, None, :] | not_cls[None, :, None])  # [B, full, full]
    if not bool(allowed.any(-1).all()):
        raise RuntimeError("text attention mask has a row with every column masked")
    mask = torch.zeros(allowed.shape, dtype=torch.float32, device=dev)
    return mask.masked_fill(~allowed, float("-inf"))[:, None]


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig = TextConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.cls_emb = nn.Parameter(torch.randn(c.width) * 0.01)
        self.positional_embedding = nn.Parameter(torch.randn(c.context_length, c.width) * 0.01)
        self.transformer = Transformer(c.width, c.layers, c.heads)
        self.ln_final = LayerNorm(c.width)
        self.text_projection = nn.Parameter(torch.randn(c.width, c.output_dim) * c.width ** -0.5)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids ``[B, 127]`` → pooled text embedding ``[B, output_dim]``.
        (``CoCa.encode_text`` drops the placeholder pad of the 128-id
        protocol before calling.)"""
        b, seq = token_ids.shape
        x = torch.cat([self.token_embedding(token_ids.long()),
                       self.cls_emb.expand(b, 1, -1)], dim=1)
        x = x + self.positional_embedding[: seq + 1]
        x = self.transformer(x, text_attention_mask(token_ids, self.cfg.pad_id))
        return self.ln_final(x[:, -1]) @ self.text_projection
