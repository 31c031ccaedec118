"""moc_tpu_torch.moc — the MOC serving forward on a batch of padded bags."""

from moc_tpu_torch.moc.core import (CLASSIFIER_NAMES, MOCConfig, fuse_views,
                                    moc_slide_logits_masked, views_from_logits)
from moc_tpu_torch.moc.episode import eval_batch

__all__ = ["CLASSIFIER_NAMES", "MOCConfig", "eval_batch", "fuse_views",
           "moc_slide_logits_masked", "views_from_logits"]
