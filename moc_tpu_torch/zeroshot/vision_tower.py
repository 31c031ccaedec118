"""CONCH vision tower: ViT trunk + attentional pooling heads (PyTorch port of
``moc_tpu/zeroshot/vision_tower.py``).

The conch_ViT-B-16 configuration: a 448 px / patch 16 ViT-B trunk returning
all tokens; a 1-query attentional pooler + LayerNorm + learned projection
for the 512-d contrastive embedding; a 256-query pooler + LayerNorm for the
768-d caption tokens; ``forward_project`` maps patch tokens into the
contrastive space.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from moc_tpu_torch.nn.transformer import AttentionalPooler, LayerNorm
from moc_tpu_torch.nn.vit import VisionTransformer


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 448
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim_contrast: int = 512
    embed_dim_caption: int = 768
    pooler_heads: int = 8
    n_queries_caption: int = 256
    # "flash" = kernel K2 in the trunk on the GPU; "dense" materialises the
    # [B, H, L, L] scores (1.9 GB per layer in f32 at 448 px, batch 64).
    # Their times on the card are in PERF.md.
    attn_impl: str = "dense"


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig = VisionConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.trunk = VisionTransformer(c.image_size, c.patch_size, c.width, c.layers, c.heads,
                                       attn_impl=c.attn_impl)
        self.attn_pool_contrast = AttentionalPooler(c.embed_dim_contrast, c.width,
                                                    c.pooler_heads, n_queries=1)
        self.ln_contrast = LayerNorm(c.embed_dim_contrast)
        self.proj_contrast = nn.Parameter(
            torch.randn(c.embed_dim_contrast, c.embed_dim_contrast) * c.width ** -0.5)
        self.attn_pool_caption = AttentionalPooler(c.embed_dim_caption, c.width,
                                                   c.pooler_heads, c.n_queries_caption)
        self.ln_caption = LayerNorm(c.embed_dim_caption)

    def forward(self, images):
        """images ``[B, H, W, 3]`` → (contrast ``[B, 512]``, caption tokens
        ``[B, 256, 768]``)."""
        tokens = self.trunk(images)
        pooled = self.attn_pool_contrast(tokens)[:, 0]
        pooled = self.ln_contrast(pooled) @ self.proj_contrast
        caption = self.ln_caption(self.attn_pool_caption(tokens))
        return pooled, caption

    def forward_no_head(self, images):
        """Pooled embedding before the contrastive projection."""
        tokens = self.trunk(images)
        return self.ln_contrast(self.attn_pool_contrast(tokens)[:, 0])

    def forward_project(self, x):
        """Project arbitrary features into the contrastive space."""
        return x @ self.proj_contrast
