"""torchvision ResNet-50 checkpoint → the port's ``ResNet50Trunk`` (PyTorch
port of ``moc_tpu/models/convert_resnet.py``).

The reference's CLAM-legacy encoder loads torchvision's ImageNet
``resnet50`` file with ``strict=False``: stages 1-3 of the standard layout,
``layer4`` and ``fc`` unused. The port's trunk keeps torchvision's names, so
loading keeps the trunk's keys (dropping ``layer4``, ``fc`` and a
``module.`` prefix) and reads them strictly: a missing trunk key raises.
``random_resnet50_state_dict`` fabricates a torchvision-layout file from a
seed, for runs without the released weights.
"""

from __future__ import annotations

import math

import torch

from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.nn.resnet import ResNet50Trunk, ResNetConfig

_TRUNK = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.")


def convert_resnet50(state_dict) -> dict[str, torch.Tensor]:
    """A torchvision ``resnet50`` state dict → the trunk's state dict (f32
    tensors; integer buffers kept)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    out = {}
    for k, v in sd.items():
        if k.startswith(_TRUNK):
            v = torch.as_tensor(v)
            out[k] = v.float() if v.is_floating_point() else v
    return out


def load_resnet50(path: str, device: str | torch.device | None = None) -> ResNet50Trunk:
    """A torch ``.pth`` (a bare state dict, or ``{"state_dict": ...}``) →
    ``ResNet50Trunk`` on ``device`` (the GPU unless ``device="cpu"``), in
    eval mode."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = ResNet50Trunk()
    model.load_state_dict(convert_resnet50(sd))
    return model.to(dev).eval()


def random_resnet50_state_dict(seed: int = 0) -> dict[str, torch.Tensor]:
    """A torchvision-layout ResNet-50 state dict from ``seed``, ``layer4`` and
    ``fc`` included: He-normal convolutions (fan-out, as torchvision
    initialises them), BatchNorm scales 1 ± 0.1 but the last of each block's
    branch, 0.1–0.3 (small, as in trained networks, so the residual stream
    keeps features near 1 over 13 blocks), shifts and running means within
    ±0.1, running variances in [0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}

    def conv(key, out, cin, k):
        sd[f"{key}.weight"] = torch.randn(out, cin, k, k, generator=g) * math.sqrt(
            2.0 / (out * k * k))

    def bn(key, n, scale=(0.9, 1.1)):
        lo, hi = scale
        sd[f"{key}.weight"] = lo + (hi - lo) * torch.rand(n, generator=g)
        sd[f"{key}.bias"] = 0.1 * (2 * torch.rand(n, generator=g) - 1)
        sd[f"{key}.running_mean"] = 0.1 * (2 * torch.rand(n, generator=g) - 1)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(n, generator=g)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    cfg = ResNetConfig()
    for stage, (n_blocks, width) in enumerate(zip((*cfg.stage_sizes, 3), (*cfg.widths, 512))):
        for block in range(n_blocks):
            p = f"layer{stage + 1}.{block}"
            conv(f"{p}.conv1", width, cin, 1)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3)
            bn(f"{p}.bn2", width)
            conv(f"{p}.conv3", width * 4, width, 1)
            bn(f"{p}.bn3", width * 4, (0.1, 0.3))
            if block == 0:
                conv(f"{p}.downsample.0", width * 4, cin, 1)
                bn(f"{p}.downsample.1", width * 4)
            cin = width * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd
