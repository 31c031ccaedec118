"""Device choice for the port's entry points: the GPU unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for an entry point: ``cuda`` when ``device`` is None.
    A CUDA request on a host without a GPU raises; it never falls back to the
    CPU, which runs only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
