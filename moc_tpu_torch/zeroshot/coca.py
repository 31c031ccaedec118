"""The CoCa model in the CONCH configuration, used as frozen encoders
(PyTorch port of ``moc_tpu/zeroshot/coca.py``).

``encode_text`` drops the final placeholder pad of the 128-id protocol to
make room for the CLS slot and L2-normalises; ``encode_image`` returns the
L2-normalised contrastive embedding. ``encode_image`` runs the trunk and the
contrast pooler only: the JAX package also runs the 256-query caption pooler
and drops its tokens, and skipping it leaves the embedding the same. The
caption decoder is not part of the model (no MOC workload runs it).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from moc_tpu_torch.models.layers import l2norm
from moc_tpu_torch.zeroshot.text_tower import TextConfig, TextTower
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig, VisionTower


@dataclasses.dataclass(frozen=True)
class CoCaConfig:
    text: TextConfig = TextConfig()
    vision: VisionConfig = VisionConfig()


CONCH_VITB16 = CoCaConfig()  # the conch_ViT-B-16.json configuration


class CoCa(nn.Module):
    def __init__(self, cfg: CoCaConfig = CONCH_VITB16):
        super().__init__()
        self.cfg = cfg
        self.text = TextTower(cfg.text)
        self.visual = VisionTower(cfg.vision)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_text(self, token_ids: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """token_ids ``[B, 128]`` (127 ids + the placeholder pad) →
        ``[B, output_dim]``."""
        pooled = self.text(token_ids[:, :-1])
        return l2norm(pooled) if normalize else pooled

    def encode_image(self, images, normalize: bool = True, proj_contrast: bool = True):
        """images ``[B, H, W, 3]`` → ``[B, 512]`` (``[B, 512]`` before the
        projection with ``proj_contrast=False``)."""
        pooled = self.visual.forward_no_head(images)
        if proj_contrast:
            pooled = self.visual.forward_project(pooled)
        return l2norm(pooled) if normalize else pooled

    def forward(self, images, token_ids):
        """(image embeddings, text embeddings, ``exp(logit_scale)``)."""
        return self.encode_image(images), self.encode_text(token_ids), self.logit_scale.exp()
