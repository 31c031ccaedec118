"""moc_tpu_torch.metrics — slide-level classification metrics."""

from moc_tpu_torch.metrics.classification import (CONCH_TEMPERATURE, accuracy,
                                                  softmax_probs)

__all__ = ["CONCH_TEMPERATURE", "accuracy", "softmax_probs"]
