"""Tensor operations; ``nms_cuda`` and ``cgm_cuda`` wrap the CUDA kernels.

The package re-exports the JAX package's ``ops`` names, each the plain
PyTorch function; importing it loads neither kernel wrapper and builds
nothing."""

from .adaptive_pool import adaptive_avg_pool2d, adaptive_pool_matrix
from .roi_align import roi_align, multilevel_roi_align
from .nms import nms_mask, batched_nms_mask, keep_top_scores
from .correlation import depthwise_correlate_1x1, depthwise_correlate_1x3_3x1, cgm_correlate
from .losses import (
    binary_heatmap_focal_loss,
    heatmap_focal_loss,
    iou_loss_ltrb,
    smooth_l1_loss,
    softmax_cross_entropy,
)

__all__ = [
    "adaptive_avg_pool2d",
    "adaptive_pool_matrix",
    "roi_align",
    "multilevel_roi_align",
    "nms_mask",
    "batched_nms_mask",
    "keep_top_scores",
    "depthwise_correlate_1x1",
    "depthwise_correlate_1x3_3x1",
    "cgm_correlate",
    "binary_heatmap_focal_loss",
    "heatmap_focal_loss",
    "iou_loss_ltrb",
    "smooth_l1_loss",
    "softmax_cross_entropy",
]
