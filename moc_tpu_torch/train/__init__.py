"""moc_tpu_torch.train — trainers: masked-token encoder pretraining and the
MIL baselines, one fold at a time or all folds of a shot fused."""

from moc_tpu_torch.train.losses import bag_loss_fn, cross_entropy, smooth_top1_svm
from moc_tpu_torch.train.mil import (AccuracyLogger, EarlyStopping, FoldResult, MilTrainConfig,
                                     build_model, evaluate_model, evaluate_patch_level,
                                     make_optimizer, train_fold, weighted_order)
from moc_tpu_torch.train.pretrain import (
    MaskedTokenModel,
    PretrainConfig,
    make_pretrain_state,
    make_train_step,
    masked_token_loss,
    run_pretrain,
)

__all__ = [
    "AccuracyLogger",
    "EarlyStopping",
    "FoldResult",
    "MaskedTokenModel",
    "MilTrainConfig",
    "PretrainConfig",
    "bag_loss_fn",
    "build_model",
    "cross_entropy",
    "evaluate_model",
    "evaluate_patch_level",
    "make_optimizer",
    "make_pretrain_state",
    "make_train_step",
    "masked_token_loss",
    "run_pretrain",
    "smooth_top1_svm",
    "train_fold",
    "weighted_order",
]
