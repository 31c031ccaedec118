"""moc_tpu_torch.viz — host-side visualisation (PyTorch port of
``moc_tpu/viz``): per-class top-k patch extraction from patch logits,
coordinate-grid overlays and heatmaps, raw-pixel crops, and the patch maps
of trained MIL heads and MOC SENets (computed on the device)."""

from moc_tpu_torch.viz.model_maps import trained_patch_maps
from moc_tpu_torch.viz.topk import (
    crop_patches,
    render_heatmap,
    render_topk_overlay,
    slide_extent,
    topk_patch_coords,
)

__all__ = [
    "topk_patch_coords",
    "crop_patches",
    "render_heatmap",
    "render_topk_overlay",
    "slide_extent",
    "trained_patch_maps",
]
