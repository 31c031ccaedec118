"""The CLAM-legacy ResNet-50 patch encoder (PyTorch port of the trunk in
``moc_tpu/nn/resnet.py``).

ImageNet ResNet-50 truncated after its third stage (3, 4 and 6 bottleneck
blocks of widths 64, 128 and 256, output 1024 channels) and averaged over
the spatial grid: ``[B, 1024]`` features a patch. BatchNorm runs in eval
mode (the running statistics). Module names are torchvision's
(``layer2.0.downsample.1.running_mean`` ...), so a torchvision state dict
loads by key (``models.convert_resnet``). Images are NHWC, as in the JAX
package. ``vit_small`` and ``vit_large`` build the ViT-S/16 and ViT-L/16
trunks of ``nn.vit.VisionTransformer`` (JAX :79-90).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from moc_tpu_torch.nn.vit import VisionTransformer


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6)  # blocks of stages 1-3 (the reference's truncation)
    widths: Sequence[int] = (64, 128, 256)


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 (stride, padding 1 on every side) → 1x1, with a projection
    shortcut where the width or the stride changes (JAX :21-49)."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.relu = nn.ReLU()
        self.downsample = None
        if in_features != out or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(in_features, out, 1, stride=stride,
                                                      bias=False), nn.BatchNorm2d(out))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        return self.relu(self.bn3(self.conv3(y)) + residual)


class ResNet50Trunk(nn.Module):
    """ResNet-50 up to its third stage and a global average pool →
    ``[B, 1024]`` (JAX :58-76, the reference's ``resnet50_baseline``); a
    ``cfg`` with other stages gives ``layer1`` to ``layer<n>`` and
    ``4 × widths[-1]`` features."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_features = 64
        for stage, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
            blocks = []
            for block in range(n_blocks):
                blocks.append(BottleneckBlock(in_features, width,
                                              2 if block == 0 and stage > 0 else 1))
                in_features = width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images ``[B, H, W, 3]`` (NHWC) → ``[B, 1024]``."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(images.permute(0, 3, 1, 2)))))
        for stage in range(len(self.cfg.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))


def vit_small(image_size: int = 224, **kw) -> VisionTransformer:
    """ViT-S/16 (the Lunit-DINO class of backbone): 12 layers of 384, 6 heads."""
    return VisionTransformer(image_size=image_size, patch_size=16, dim=384, num_layers=12,
                             num_heads=6, **kw)


def vit_large(image_size: int = 224, patch_size: int = 16, **kw) -> VisionTransformer:
    """ViT-L/16 (the UNI / DeCUR class of backbone): 24 layers of 1024, 16 heads."""
    return VisionTransformer(image_size=image_size, patch_size=patch_size, dim=1024,
                             num_layers=24, num_heads=16, **kw)
