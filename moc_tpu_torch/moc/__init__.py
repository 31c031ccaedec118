"""moc_tpu_torch.moc — the MOC forward on padded bags, few-shot episodes, the
fused episode sweep and their result files."""

from moc_tpu_torch.moc.core import (CLASSIFIER_NAMES, EvalPack, MOCConfig, SlideViews,
                                    ablation_slide_logits, fuse_views, fuse_views_fixed,
                                    moc_logits_packed, moc_slide_logits,
                                    moc_slide_logits_dense, moc_slide_logits_masked,
                                    precompute_eval_pack, selection_capacity_for, slide_process,
                                    views_from_logits)
from moc_tpu_torch.moc.episode import (EpisodeResult, EvalMetrics, ablation_evaluation,
                                       eval_batch, init_senet, make_optimizer, run_episode,
                                       train_epoch, zs_eval_batches, zs_pooled_logits)
from moc_tpu_torch.moc.sweep import (EpisodeIndex, PooledEpisodes, StackedEpisode, SweepResult,
                                     assemble_episode, episode_from_bags, episode_index,
                                     make_sweep_fn, pack_slide_pool, pad_and_stack_episodes,
                                     pool_episode_bags, pool_episode_splits,
                                     pooled_bytes_estimate, run_sweep, run_sweep_pooled,
                                     stack_episode_bags, stack_episodes, sweep_episode_results,
                                     sweep_step, unique_split_ids)

__all__ = ["CLASSIFIER_NAMES", "EpisodeIndex", "EpisodeResult", "EvalMetrics", "EvalPack",
           "MOCConfig", "PooledEpisodes", "SlideViews", "StackedEpisode", "SweepResult",
           "ablation_evaluation", "ablation_slide_logits", "assemble_episode",
           "episode_from_bags", "episode_index", "eval_batch", "fuse_views", "fuse_views_fixed",
           "init_senet", "make_optimizer", "make_sweep_fn", "moc_logits_packed",
           "moc_slide_logits", "moc_slide_logits_dense", "moc_slide_logits_masked", "pack_slide_pool",
           "pad_and_stack_episodes", "pool_episode_bags", "pool_episode_splits",
           "pooled_bytes_estimate", "precompute_eval_pack", "run_episode", "run_sweep",
           "run_sweep_pooled", "selection_capacity_for", "slide_process", "stack_episode_bags",
           "stack_episodes", "sweep_episode_results", "sweep_step", "train_epoch",
           "unique_split_ids",
           "views_from_logits", "zs_eval_batches", "zs_pooled_logits"]
