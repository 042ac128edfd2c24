"""ROIAlignV2 (aligned=True) as separable bilinear matrix products
(counterpart of ``faster_orefsdet_tpu/ops/roi_align.py``).

For each box, two interpolation matrices A_y [P, H] and A_x [P, W] (each row
the mean of S bilinear hat rows) give out = A_y . feat . A_x^T per channel.
``sampling_ratio=0`` is ROIAlignV2's adaptive mode, ceil(roi_size/out_size)
samples per bin, laid out on a masked static grid of ADAPTIVE_S_MAX samples:
ratios above the cap clamp to it (unlike torchvision's uncapped count).

This composition is the plain version of the gather kernel in
``roi_align_cuda``, which the serving paths take on the card, and the
differentiable route that training takes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..structures.boxes import area

ADAPTIVE_S_MAX = 8


def _interp_matrix(start, size, axis_len: int, out_size: int, sampling_ratio: int):
    """Mean-of-samples bilinear weights [..., out_size, axis_len] for rois with
    start / size [...] (already scaled and half-pixel shifted)."""
    dev = start.device
    bin_size = (size / out_size)[..., None, None]  # [...,1,1]
    start = start[..., None, None]
    p = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]  # [P,1]
    if sampling_ratio > 0:
        s = sampling_ratio
        iy = (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s  # [1,S]
        y = start + (p + iy) * bin_size  # [...,P,S]
        sample_w = torch.full((1, s), 1.0 / s, device=dev)
    else:
        s = ADAPTIVE_S_MAX
        s_dyn = torch.clamp(torch.ceil(bin_size), 1.0, float(s))  # [...,1,1]
        idx = torch.arange(s, dtype=torch.float32, device=dev)[None, :]  # [1,S]
        iy = (idx + 0.5) / s_dyn
        y = start + (p + iy) * bin_size
        sample_w = torch.where(idx < s_dyn, 1.0 / s_dyn, torch.zeros((), device=dev))
    # torchvision bilinear_interpolate: zero outside [-1, axis_len], clamp to
    # [0, axis_len-1], hat weights over the integer grid
    inrange = (y >= -1.0) & (y <= axis_len)
    yc = y.clamp(0.0, axis_len - 1.0)
    grid = torch.arange(axis_len, dtype=torch.float32, device=dev)
    hat = torch.relu(1.0 - torch.abs(yc[..., None] - grid))  # [...,P,S,L]
    hat = torch.where(inrange[..., None], hat, torch.zeros((), device=dev))
    return torch.sum(hat * sample_w[..., None], dim=-2)  # [...,P,L]


def roi_align(
    feature: torch.Tensor,
    boxes: torch.Tensor,
    spatial_scale: float,
    output_size: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """ROIAlignV2 over one level. feature [B, C, H, W]; boxes [B, R, 4] xyxy
    image coords -> [B, R, P, P, C] channel-last, in the feature's dtype (the
    products run in f32, or f64 for an f64 feature)."""
    hh, ww = feature.shape[-2], feature.shape[-1]
    b = boxes.float()
    sx = b[..., 0] * spatial_scale - 0.5
    sy = b[..., 1] * spatial_scale - 0.5
    ex = b[..., 2] * spatial_scale - 0.5
    ey = b[..., 3] * spatial_scale - 0.5
    w = torch.clamp(ex - sx, min=1e-6)
    h = torch.clamp(ey - sy, min=1e-6)
    ay = _interp_matrix(sy, h, hh, output_size, sampling_ratio)  # [B,R,P,H]
    ax = _interp_matrix(sx, w, ww, output_size, sampling_ratio)  # [B,R,P,W]
    dt = torch.promote_types(feature.dtype, torch.float32)
    feat = feature.permute(0, 2, 3, 1).to(dt)  # [B,H,W,C]
    t = torch.einsum("brph,bhwc->brpwc", ay.to(dt), feat).to(feature.dtype)
    out = torch.einsum("brqw,brpwc->brpqc", ax.to(dt), t.to(dt))
    return out.to(feature.dtype)


def assign_levels(
    boxes: torch.Tensor,
    min_level: int,
    max_level: int,
    canonical_box_size: int = 224,
    canonical_level: int = 4,
) -> torch.Tensor:
    """FPN level of each box (FPN paper eqn. 1, d2 poolers.py)."""
    sizes = torch.sqrt(torch.clamp(area(boxes.float()), min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(sizes / canonical_box_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    strides: Sequence[int],
    output_size: int,
    sampling_ratio: int = 2,
    canonical_box_size: int = 224,
    canonical_level: int = 4,
) -> torch.Tensor:
    """ROIPooler: pool every box at every level and keep the level its size
    assigns. features: [B, C, H_l, W_l] per level; boxes [B, R, 4] ->
    [B, R, P, P, C]."""
    min_level = int(math.log2(strides[0]))
    max_level = int(math.log2(strides[-1]))
    lvl = assign_levels(boxes, min_level, max_level, canonical_box_size, canonical_level)
    return pool_at_levels(features, boxes, lvl - min_level, [1.0 / s for s in strides], output_size,
                          sampling_ratio)


def pool_at_levels(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Pool every box at every level (scale `scales[i]` for features[i]) and
    keep each box's own: levels [B, R] indices into `features` (a box whose
    index matches no level pools to zeros) -> [B, R, P, P, C]."""
    out = None
    for i, (feat, scale) in enumerate(zip(features, scales)):
        pooled = roi_align(feat, boxes, scale, output_size, sampling_ratio)
        mask = (levels == i).to(pooled.dtype)[..., None, None, None]
        out = pooled * mask if out is None else out + pooled * mask
    return out
