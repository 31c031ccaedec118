"""MUSK, the BEiT-3 multiway dual tower, in PyTorch (port of
``moc_tpu/models/musk.py``).

One multiway encoder runs over a ``[vision; text]`` token stream: conv
patchified image tokens (with a cls token) first, then text tokens. Branch A
of every multiway module serves the vision positions and branch B the text
ones, so a vision call runs A alone (``split=None``), a text call B alone
(``split=0``) and a mixed call both (``split = n_vis``). Bias-free vision
and language heads over the cls tokens give the contrastive embeddings,
beside ``exp(logit_scale)``. ``multiscale_image_features`` is MUSK's
multiscale chessboard inference.

Images are NHWC, as in the JAX package. The attention is the encoder's
flash path: kernel K2 on the GPU, with the text padding carried as segment
ids. Parameter names follow the torchscale release (``beit3.encoder.layers.
{i}.self_attn.q_proj.A.weight`` ...), but for the two position tables,
``beit3.vision_pos`` and ``beit3.text_pos``, which hold the release's
``embed_positions.A`` / ``.B`` without fairseq's two reserved rows
(``zeroshot.convert_musk``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.models.layers import l2norm
from moc_tpu_torch.nn.encoder import Encoder, EncoderConfig

MUSK_LARGE_ENCODER = EncoderConfig(embed_dim=1024, ffn_dim=4096, layers=24, heads=16,
                                   multiway=True)


@dataclasses.dataclass(frozen=True)
class MuskConfig:
    image_size: int = 384
    patch_size: int = 16
    vocab_size: int = 64010
    max_text_len: int = 100
    embed_dim: int = 1024
    out_dim: int = 1024  # contrastive embedding width
    encoder: EncoderConfig = MUSK_LARGE_ENCODER

    @property
    def n_vision_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class VisionEmbedding(nn.Module):
    """Conv patchify and a cls token. The mask token of masked pretraining is
    held (the release's ``contain_mask_token=True``), so checkpoints load
    whole, but no call here masks."""

    def __init__(self, cfg: MuskConfig):
        super().__init__()
        d = cfg.embed_dim
        self.proj = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.randn(1, 1, d) * 0.02)
        self.mask_token = nn.Parameter(torch.randn(1, 1, d) * 0.02)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images ``[B, H, W, 3]`` → tokens ``[B, 1 + HW/p², D]``."""
        x = self.proj(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        return torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)


class BEiT3(nn.Module):
    """The multiway encoder over ``[vision; text]`` (JAX :57-100). Returns
    ``(tokens [B, L, D], moe_aux)``."""

    def __init__(self, cfg: MuskConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.vision_embed = VisionEmbedding(cfg)
        self.vision_pos = nn.Parameter(torch.randn(cfg.n_vision_tokens, d) * 0.02)
        self.text_embed = nn.Embedding(cfg.vocab_size, d)
        self.text_pos = nn.Parameter(torch.randn(cfg.max_text_len, d) * 0.02)
        self.encoder = Encoder(dataclasses.replace(cfg.encoder, embed_dim=d))

    def forward(self, textual_tokens=None, visual_tokens=None, text_padding_mask=None):
        if textual_tokens is None and visual_tokens is None:
            raise ValueError("BEiT3 needs textual_tokens, visual_tokens or both")
        parts = []
        split = None if textual_tokens is None else 0
        if visual_tokens is not None:
            v = self.vision_embed(visual_tokens)
            parts.append(v + self.vision_pos[: v.shape[1]].to(v.dtype))
            split = v.shape[1] if textual_tokens is not None else None
        if textual_tokens is not None:
            t = self.text_embed(textual_tokens)
            parts.append(t + self.text_pos[: t.shape[1]].to(t.dtype))
        x = torch.cat(parts, dim=1)
        padding = None  # without text padding every key is real: K2 runs unsegmented
        if text_padding_mask is not None:
            vision = x.new_zeros((x.shape[0], x.shape[1] - text_padding_mask.shape[1]),
                                 dtype=torch.bool)
            padding = torch.cat([vision, text_padding_mask.bool()], dim=1)
        return self.encoder(x, padding_mask=padding,
                            split=split if self.cfg.encoder.multiway else None)


class MUSK(nn.Module):
    """Vision and language heads over BEiT-3's cls tokens, and the logit
    scale (JAX :106-130)."""

    def __init__(self, cfg: MuskConfig = MuskConfig()):
        super().__init__()
        self.cfg = cfg
        self.beit3 = BEiT3(cfg)
        self.vision_head = nn.Linear(cfg.embed_dim, cfg.out_dim, bias=False)
        self.language_head = nn.Linear(cfg.embed_dim, cfg.out_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.log(torch.tensor(1 / 0.07)))

    def forward(self, images=None, token_ids=None, text_padding_mask=None,
                normalize: bool = True):
        """``(vision_cls [B, out] or None, text_cls [B', out] or None,
        exp(logit_scale))``: each tower runs on its own."""
        vision_cls = text_cls = None
        if images is not None:
            out, _ = self.beit3(visual_tokens=images)
            vision_cls = self.vision_head(out[:, 0])
            if normalize:
                vision_cls = l2norm(vision_cls)
        if token_ids is not None:
            out, _ = self.beit3(textual_tokens=token_ids, text_padding_mask=text_padding_mask)
            text_cls = self.language_head(out[:, 0])
            if normalize:
                text_cls = l2norm(text_cls)
        return vision_cls, text_cls, torch.exp(self.logit_scale)


def split_chessboard(x: torch.Tensor, num_split: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B·s², H/s, W/s, C]``, tiles in the order
    (tile row, tile column, image)."""
    b, h, w, c = x.shape
    s = num_split
    x = x.reshape(b, s, h // s, s, w // s, c)
    return x.permute(1, 3, 0, 2, 4, 5).reshape(b * s * s, h // s, w // s, c)


def multiscale_image_features(apply_fn, images: torch.Tensor, scales=(1, 2)) -> torch.Tensor:
    """MUSK's multiscale inference (JAX :140-171): at each scale s the images
    are resized to s × their size, split into s² tiles of the base size,
    encoded by ``apply_fn`` and the tiles' embeddings averaged; the scales'
    features are concatenated. The upsample is torch's bicubic
    (``align_corners=False``, Keys a = -0.75), the matrix the JAX package
    imitates."""
    b, base, _, _ = images.shape
    feats = []
    for s in scales:
        tiles = images
        if s != 1:
            big = F.interpolate(images.permute(0, 3, 1, 2), size=(base * s, base * s),
                                mode="bicubic", align_corners=False)
            tiles = split_chessboard(big.permute(0, 2, 3, 1), s)
        emb = apply_fn(tiles)  # [B·s², D]
        feats.append(emb.reshape(s * s, b, -1).mean(dim=0))
    return torch.cat(feats, dim=-1)
