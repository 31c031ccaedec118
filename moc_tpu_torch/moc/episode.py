"""MOC batch evaluation (PyTorch port of ``eval_batch`` in
``moc_tpu/moc/episode.py``; training comes in a later slice)."""

from __future__ import annotations

from typing import Mapping

import torch

from moc_tpu_torch.convert import senet_from_state_dict
from moc_tpu_torch.data.batching import BagBatch
from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.moc.core import MOCConfig, moc_slide_logits_masked


def eval_batch(params_or_module: SENet | Mapping[str, torch.Tensor], batch: BagBatch,
               w: torch.Tensor, w_ext: torch.Tensor, cfg: MOCConfig) -> torch.Tensor:
    """Pooled slide logits ``[B, C]`` for a padded batch (no patch mask):
    the exact masked forward, on the device the batch lies on. The SENet
    comes as a module or as its state dict."""
    senet = (params_or_module if isinstance(params_or_module, SENet)
             else senet_from_state_dict(params_or_module))
    senet = senet.to(batch.features.device)
    with torch.inference_mode():
        return moc_slide_logits_masked(senet, batch.features, batch.mask,
                                       w, w_ext, cfg)
