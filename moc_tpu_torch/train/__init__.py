"""moc_tpu_torch.train — trainers: masked-token encoder pretraining (with
the bf16-parameter recipe) and MUSK's contrastive step, the MIL baselines (one fold at a time or all folds of a shot fused), ViLa-MIL,
LoRA fine-tuning and chunked-bag attention pooling."""

from moc_tpu_torch._lazy import lazy_exports
from moc_tpu_torch.train.accum import chunk_bag, streaming_attention_pool
from moc_tpu_torch.train.lora_finetune import (LoraFinetuneConfig, make_lora_train_step,
                                               run_lora_finetune, streamed_slide_logits,
                                               update_queue)

from moc_tpu_torch.train.losses import bag_loss_fn, cross_entropy, smooth_top1_svm
from moc_tpu_torch.train.mil import (AccuracyLogger, EarlyStopping, FoldResult, MilTrainConfig,
                                     build_model, evaluate_model, evaluate_patch_level,
                                     half_precision_params, init_classifier_from_weights,
                                     make_optimizer, train_fold, weighted_order)
from moc_tpu_torch.train.pretrain import (
    MaskedTokenModel,
    MasterAdam,
    PretrainConfig,
    cast_params_for_storage,
    clip_contrastive_loss,
    encoder_param_shardings,
    make_musk_contrastive_step,
    make_pretrain_state,
    make_sharded_train_step,
    make_train_step,
    masked_token_loss,
    run_pretrain,
)
from moc_tpu_torch.train.vila import (VilaFoldResult, VilaTrainConfig, evaluate_vila,
                                      train_vila_fold)

__all__ = [
    "LoraFinetuneConfig",
    "VilaFoldResult",
    "VilaTrainConfig",
    "chunk_bag",
    "evaluate_vila",
    "make_lora_train_step",
    "run_lora_finetune",
    "streamed_slide_logits",
    "streaming_attention_pool",
    "train_vila_fold",
    "update_queue",
    "AccuracyLogger",
    "EarlyStopping",
    "FoldResult",
    "MaskedTokenModel",
    "MasterAdam",
    "cast_params_for_storage",
    "clip_contrastive_loss",
    "make_musk_contrastive_step",
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
    "encoder_param_shardings",
    "half_precision_params",
    "init_classifier_from_weights",
    "make_sharded_train_step",
    "FusedFoldResult",
    "run_mil_folds_fused",
    "run_mil_folds_fused_pooled",
]

# the fused MIL folds import the MOC core (its episode sweep)
__getattr__ = lazy_exports(__name__, {name: "moc_tpu_torch.train.mil_fused" for name in (
    "FusedFoldResult", "run_mil_folds_fused", "run_mil_folds_fused_pooled")})
