"""moc_tpu_torch.metrics — slide-level classification metrics and AUC."""

from moc_tpu_torch.metrics.auc import (auc_binary, auc_from_probs, auc_ovo_macro, auc_ovr_macro,
                                      roc_auc_host, roc_auc_ovr_host)
from moc_tpu_torch.metrics.classification import (CONCH_TEMPERATURE, accuracy,
                                                  balanced_accuracy, softmax_probs)

__all__ = ["CONCH_TEMPERATURE", "accuracy", "auc_binary", "auc_from_probs", "auc_ovo_macro",
           "auc_ovr_macro", "balanced_accuracy", "roc_auc_host", "roc_auc_ovr_host", "softmax_probs"]
