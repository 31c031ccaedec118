"""moc_tpu_torch.moc — the MOC forward on padded bags, few-shot episodes and
their result files."""

from moc_tpu_torch.moc.core import (CLASSIFIER_NAMES, MOCConfig, SlideViews,
                                    ablation_slide_logits, fuse_views, fuse_views_fixed,
                                    moc_slide_logits, moc_slide_logits_masked,
                                    selection_capacity_for, slide_process, views_from_logits)
from moc_tpu_torch.moc.episode import (EpisodeResult, EvalMetrics, ablation_evaluation,
                                       eval_batch, init_senet, make_optimizer, run_episode,
                                       train_epoch, zs_pooled_logits)

__all__ = ["CLASSIFIER_NAMES", "EpisodeResult", "EvalMetrics", "MOCConfig", "SlideViews",
           "ablation_evaluation", "ablation_slide_logits", "eval_batch", "fuse_views",
           "fuse_views_fixed", "init_senet", "make_optimizer", "moc_slide_logits",
           "moc_slide_logits_masked", "run_episode", "selection_capacity_for", "slide_process",
           "train_epoch", "views_from_logits", "zs_pooled_logits"]
