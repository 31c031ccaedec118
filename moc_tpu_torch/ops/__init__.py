"""moc_tpu_torch.ops — masked selection and pooling ops, and kernel K1.

PyTorch counterpart of ``moc_tpu.ops``. Every op takes a padded bag plus a
boolean validity mask, with the slide batch as a leading dimension. The exact
top-k membership search runs in the hand-written CUDA kernel K1
(``ops.topk_kernel``) on the GPU and in its plain PyTorch version on the CPU.
"""

from moc_tpu_torch.ops.masking import (
    NEG_INF,
    masked_col_topk,
    masked_col_topk_mask,
    masked_logits,
    masked_row_margin,
    threshold_topk_mask,
    topk_mean,
)
from moc_tpu_torch.ops.pooling import topj_pooling
from moc_tpu_torch.ops.selection import (
    selection_capacity,
    topk_threshold_mask,
    union_selection_threshold,
)

__all__ = [
    "NEG_INF",
    "masked_col_topk",
    "masked_col_topk_mask",
    "masked_logits",
    "masked_row_margin",
    "threshold_topk_mask",
    "topk_mean",
    "topj_pooling",
    "selection_capacity",
    "topk_threshold_mask",
    "union_selection_threshold",
]
