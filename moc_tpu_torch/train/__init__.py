"""moc_tpu_torch.train — trainers: masked-token encoder pretraining."""

from moc_tpu_torch.train.pretrain import (
    MaskedTokenModel,
    PretrainConfig,
    make_pretrain_state,
    make_train_step,
    masked_token_loss,
    run_pretrain,
)

__all__ = [
    "MaskedTokenModel",
    "PretrainConfig",
    "make_pretrain_state",
    "make_train_step",
    "masked_token_loss",
    "run_pretrain",
]
