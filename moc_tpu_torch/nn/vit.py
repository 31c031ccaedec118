"""A timm-style Vision Transformer trunk (PyTorch port of ``moc_tpu/nn/vit.py``).

The CONCH vision trunk: conv patchify, a prepended cls token, learned
absolute position embeddings, pre-LN blocks and a final LayerNorm; the
forward returns all tokens ``[B, 1 + HW, D]``. Images are NHWC, as in the
JAX package; tokens are flattened row-major over the patch grid.

The LoRA options (``lora_rank``, ``lora_last_n``, ``block_lora_rank``,
``lora_experts``) and ``remat`` pass through to ``nn.transformer.Transformer``;
a mixture-of-LoRA trunk appends its router gates to ``gates``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.nn.transformer import LayerNorm, Transformer


class VisionTransformer(nn.Module):
    def __init__(self, image_size: int = 448, patch_size: int = 16, dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 attn_impl: str = "dense", *, remat: bool = False, lora_rank: int = 0,
                 lora_last_n: int | None = None, block_lora_rank: int = 0,
                 lora_experts: int = 1):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, self.grid ** 2 + 1, dim) * 0.02)
        self.blocks = Transformer(dim, num_layers, num_heads, mlp_ratio, attn_impl, remat=remat,
                                  lora_rank=lora_rank, lora_last_n=lora_last_n,
                                  block_lora_rank=block_lora_rank, lora_experts=lora_experts)
        self.norm = LayerNorm(dim)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    def forward(self, images: torch.Tensor, gates: list | None = None) -> torch.Tensor:
        """images ``[B, H, W, 3]`` (NHWC) → tokens ``[B, 1 + HW/p², D]``."""
        x = self.patch_embed(images.permute(0, 3, 1, 2))  # [B, D, H/p, W/p]
        x = x.flatten(2).transpose(1, 2)  # [B, HW, D], row-major over the grid
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]]
        return self.norm(self.blocks(x, None, gates))


def resample_pos_embed(pos_embed: torch.Tensor, new_grid: int,
                       num_prefix: int = 1) -> torch.Tensor:
    """Bilinear position-embedding resampling between image sizes (timm's
    ``resample_abs_pos_embed``: ``align_corners=False``, no antialiasing even
    when downsampling). Prefix (cls) rows pass through. ``[1, P + g², D]``
    → ``[1, P + new_grid², D]``."""
    prefix, grid_part = pos_embed[:, :num_prefix], pos_embed[:, num_prefix:]
    old_grid = int(round(grid_part.shape[1] ** 0.5))
    d = grid_part.shape[-1]
    grid_part = grid_part.reshape(1, old_grid, old_grid, d).permute(0, 3, 1, 2)
    grid_part = F.interpolate(grid_part, size=(new_grid, new_grid), mode="bilinear",
                              align_corners=False, antialias=False)
    grid_part = grid_part.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, d)
    return torch.cat([prefix, grid_part], dim=1)
