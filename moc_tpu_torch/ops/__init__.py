"""moc_tpu_torch.ops — masked selection and pooling ops, flash attention,
and kernels K1 to K4.

PyTorch counterpart of ``moc_tpu.ops``. Every selection and pooling op takes
a padded bag plus a boolean validity mask, with the slide batch as a leading
dimension. The exact top-k membership search runs in the hand-written CUDA
kernel K1 (``ops.topk_kernel``) on the GPU and in its plain PyTorch version
on the CPU. The int8 serving tier's W8A8 product (``ops.quant``) runs in
``torch._int_mm``. Flash attention (``ops.flash_attention``) runs its forward in K2
and its backward in K3 and K4 (``ops.flash_kernel``) on the GPU, and in
``mha_reference`` and ``flash_bwd_reference`` on the CPU.
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
from moc_tpu_torch.ops.pooling import (
    FOREGROUND_POOLINGS,
    POOLING_REGISTRY,
    bottomk_irrel_delta_diff_pooling,
    bottomk_irrel_delta_softmax_pooling,
    bottomk_irrel_pooling,
    delta_diff_pooling,
    delta_softmax_pooling,
    topj_bottomk_irrel_delta_diff_pooling,
    topj_bottomk_irrel_delta_softmax_pooling,
    topj_delta_diff_pooling,
    topj_delta_softmax_pooling,
    topj_pooling,
)
from moc_tpu_torch.ops.quant import (
    dequantize_rows,
    int8_row_matmul,
    quantize_columns,
    quantize_rows_device,
    quantize_rows_host,
)
from moc_tpu_torch.ops.selection import (
    gather_selected,
    select_and_gather,
    select_bottomk_irrel,
    select_delta_diff,
    select_delta_softmax,
    select_topj,
    selection_capacity,
    topk_threshold_mask,
    union_selection,
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
    "FOREGROUND_POOLINGS",
    "POOLING_REGISTRY",
    "bottomk_irrel_delta_diff_pooling",
    "bottomk_irrel_delta_softmax_pooling",
    "bottomk_irrel_pooling",
    "delta_diff_pooling",
    "delta_softmax_pooling",
    "topj_bottomk_irrel_delta_diff_pooling",
    "topj_bottomk_irrel_delta_softmax_pooling",
    "topj_delta_diff_pooling",
    "topj_delta_softmax_pooling",
    "topj_pooling",
    "dequantize_rows",
    "int8_row_matmul",
    "quantize_columns",
    "quantize_rows_device",
    "quantize_rows_host",
    "gather_selected",
    "select_and_gather",
    "select_bottomk_irrel",
    "select_delta_diff",
    "select_delta_softmax",
    "select_topj",
    "selection_capacity",
    "topk_threshold_mask",
    "union_selection",
    "union_selection_threshold",
]
