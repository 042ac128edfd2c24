"""CenterNet grid geometry and ground-truth target rendering (counterpart of
``faster_orefsdet_tpu/ops/heatmap.py``).

The targets are batched over images on the device, where the JAX package
vmaps them: per pixel the ltrb regression target of the nearest (weighted
center distance) box, the agnostic heatmap, and the flat indices of the
positive pixels. Ground truth is a fixed-N padded set with a validity mask,
so every [B, M, N] matrix has a static shape.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import device_constant
from .losses import iou_loss_ltrb

INF = 1e8


def level_grid_shapes(canvas_hw: Tuple[int, int], strides: Sequence[int]):
    """[(h_l, w_l)] for each stride of a canvas padded to divisibility."""
    h, w = canvas_hw
    return [(h // s, w // s) for s in strides]


def _level_bases(canvas_hw, strides) -> np.ndarray:
    return np.cumsum([0] + [hl * wl for hl, wl in level_grid_shapes(canvas_hw, strides)])[:-1]


@device_constant
def compute_grids(canvas_hw: Tuple[int, int], strides: Tuple[int, ...]) -> np.ndarray:
    """Concatenated [M, 2] grid-point (x, y) image coords: per level
    (j * stride, i * stride) + stride // 2, row-major. A constant on
    `device=`, made once per (canvas, strides, device)."""
    out = []
    for (hl, wl), s in zip(level_grid_shapes(canvas_hw, strides), strides):
        xs = np.arange(wl, dtype=np.float32) * s + s // 2
        ys = np.arange(hl, dtype=np.float32) * s + s // 2
        gx, gy = np.meshgrid(xs, ys)
        out.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1))
    return np.concatenate(out, axis=0)


@device_constant
def flat_strides(canvas_hw: Tuple[int, int], strides: Tuple[int, ...]) -> np.ndarray:
    """[M] stride of each concatenated grid point, a constant on `device=`."""
    reps = [hl * wl for (hl, wl) in level_grid_shapes(canvas_hw, strides)]
    return np.repeat(np.asarray(strides, np.float32), reps)


@device_constant
def flat_size_ranges(canvas_hw: Tuple[int, int], strides: Tuple[int, ...],
                     sizes_of_interest: Tuple[Tuple[float, float], ...]) -> np.ndarray:
    """[M, 2] size-of-interest range of each grid point, a constant on `device=`."""
    reps = [hl * wl for (hl, wl) in level_grid_shapes(canvas_hw, strides)]
    return np.repeat(np.asarray(sizes_of_interest, np.float32), reps, axis=0)


class CenterNetTargets(NamedTuple):
    reg_targets: torch.Tensor  # [B, M, 4] ltrb / stride; -INF rows = no target
    heatmap: torch.Tensor  # [B, M] agnostic heatmap in [0, 1]
    pos_inds: torch.Tensor  # [B, L*N] padded flat indices of positive pixels (int64)
    pos_mask: torch.Tensor  # [B, L*N] validity


def render_targets(
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    canvas_hw: Tuple[int, int],
    strides: Sequence[int],
    sizes_of_interest: Sequence[Tuple[float, float]],
    *,
    hm_min_overlap: float = 0.8,
    min_radius: int = 4,
) -> CenterNetTargets:
    """CenterNet targets for a batch: gt_boxes [B, N, 4] padded xyxy,
    gt_valid [B, N] bool, on the device the targets are wanted on."""
    dev = gt_boxes.device
    key = (tuple(canvas_hw), tuple(strides))
    grids = compute_grids(*key, device=dev)
    strides_m = flat_strides(*key, device=dev)
    size_ranges = flat_size_ranges(*key, tuple(tuple(float(v) for v in r) for r in sizes_of_interest), device=dev)
    m = grids.shape[0]
    delta = (1.0 - hm_min_overlap) / (1.0 + hm_min_overlap)

    gx = grids[None, :, 0, None]  # [1, M, 1]
    gy = grids[None, :, 1, None]
    bx1 = gt_boxes[:, None, :, 0]  # [B, 1, N]
    by1 = gt_boxes[:, None, :, 1]
    bx2 = gt_boxes[:, None, :, 2]
    by2 = gt_boxes[:, None, :, 3]

    l = gx - bx1
    t = gy - by1
    r = bx2 - gx
    b = by2 - gy
    reg = torch.stack([l, t, r, b], dim=3)  # [B, M, N, 4]

    boxes_area = ((bx2 - bx1) * (by2 - by1)).clamp(min=0.0)[:, 0]  # [B, N]
    cx = (bx1 + bx2) / 2.0  # [B, 1, N]
    cy = (by1 + by2) / 2.0
    sm = strides_m[None, :, None]  # [1, M, 1]
    # the center snapped to this pixel's stride grid
    cdx = (cx / sm).to(torch.int32).float() * sm + sm / 2.0  # [B, M, N]
    cdy = (cy / sm).to(torch.int32).float() * sm + sm / 2.0

    is_peak = ((gx - cdx) ** 2 + (gy - cdy) ** 2) == 0
    is_in_boxes = reg.amin(dim=3) > 0
    is_center3x3 = (torch.abs(gx - cdx) <= sm) & (torch.abs(gy - cdy) <= sm) & is_in_boxes
    crit = torch.sqrt((l + r) ** 2 + (t + b) ** 2) / 2.0
    is_cared = (crit >= size_ranges[None, :, 0:1]) & (crit <= size_ranges[None, :, 1:2])
    reg_mask = is_center3x3 & is_cared & gt_valid[:, None, :]

    dist2 = (gx - cx) ** 2 + (gy - cy) ** 2
    dist2 = torch.where(is_peak, torch.zeros_like(dist2), dist2)
    radius2 = (delta ** 2 * 2.0 * boxes_area).clamp(min=float(min_radius ** 2))  # [B, N]
    weighted_dist2 = dist2 / radius2[:, None, :]
    inf = torch.full_like(weighted_dist2, INF)

    # reg targets: the nearest (weighted) masked box of each pixel
    min_dist, min_inds = torch.where(reg_mask, weighted_dist2, inf).min(dim=2)  # [B, M]
    reg_targets = torch.gather(reg, 2, min_inds[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0]
    reg_targets = torch.where((min_dist == INF)[..., None], torch.full_like(reg_targets, -INF), reg_targets)
    reg_targets = reg_targets / strides_m[None, :, None]

    # agnostic heatmap: min over the valid boxes only
    heatmap = torch.exp(-torch.where(gt_valid[:, None, :], weighted_dist2, inf).amin(dim=2))
    heatmap = torch.where(heatmap < 1e-4, torch.zeros_like(heatmap), heatmap)

    # positive indices: flat index = level_base + iy * w_l + ix, the level
    # chosen by the box's half diagonal
    shapes = level_grid_shapes(canvas_hw, strides)
    bases = _level_bases(canvas_hw, strides)
    cxn, cyn = cx[:, 0], cy[:, 0]  # [B, N]
    diag = torch.sqrt((bx2 - bx1) ** 2 + (by2 - by1) ** 2)[:, 0] / 2.0
    pos_list, mask_list = [], []
    for li, s in enumerate(strides):
        wl = shapes[li][1]
        ix = (cxn / s).to(torch.int32)
        iy = (cyn / s).to(torch.int32)
        idx = int(bases[li]) + iy * wl + ix
        lo, hi = sizes_of_interest[li]
        pos_list.append(idx.clamp(0, m - 1).long())
        mask_list.append((diag >= lo) & (diag <= hi) & gt_valid)
    return CenterNetTargets(reg_targets, heatmap, torch.cat(pos_list, dim=1), torch.cat(mask_list, dim=1))


def more_pos_inds(
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    reg_pred: torch.Tensor,
    canvas_hw: Tuple[int, int],
    strides: Sequence[int],
    sizes_of_interest: Sequence[Tuple[float, float]],
    *,
    more_pos_topk: int = 9,
    more_pos_thresh: float = 0.2,
    loc_loss_type: str = "giou",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MORE_POS positive mining: the pixels of each box's center 3x3 region,
    on every level, whose regression loss is below the box's k-th smallest
    (capped at more_pos_thresh) become positives. gt_boxes [B, N, 4];
    reg_pred [B, M, 4] in stride units, detached by the caller. Returns
    (pos_inds [B, N*L*9] int64, pos_mask [B, N*L*9])."""
    shapes = level_grid_shapes(canvas_hw, strides)
    bases = _level_bases(canvas_hw, strides)
    bsz, n = gt_boxes.shape[:2]
    m = reg_pred.shape[1]
    num_l, k = len(strides), 9
    dev = gt_boxes.device
    dx = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], dtype=torch.int32, device=dev)
    dy = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], dtype=torch.int32, device=dev)
    dxf, dyf = dx.float(), dy.float()

    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2.0  # [B, N]
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2.0
    diag = torch.sqrt((gt_boxes[..., 2] - gt_boxes[..., 0]) ** 2 + (gt_boxes[..., 3] - gt_boxes[..., 1]) ** 2) / 2.0

    inds_l, mask_l, regs_l, level_ok_l = [], [], [], []
    for li, s in enumerate(strides):
        hl, wl = shapes[li]
        ix = (cx / s).to(torch.int32)
        iy = (cy / s).to(torch.int32)
        gx = ix.float() * s + s // 2  # the center pixel's grid coords
        gy = iy.float() * s + s // 2
        reg = torch.stack([(gx - gt_boxes[..., 0]) / s, (gy - gt_boxes[..., 1]) / s,
                           (gt_boxes[..., 2] - gx) / s, (gt_boxes[..., 3] - gy) / s], dim=-1)  # [B, N, 4]
        lo, hi = sizes_of_interest[li]
        level_ok_l.append((reg.amin(dim=-1) >= 0) & (diag >= lo) & (diag <= hi) & gt_valid)

        cix = ix[..., None] + dx  # [B, N, 9]
        ciy = iy[..., None] + dy
        idx = int(bases[li]) + ciy * wl + cix
        inb = (cix >= 0) & (cix < wl) & (ciy >= 0) & (ciy < hl)
        # the regression targets of the 3x3 offsets: l - dx, t - dy, r + dx, b + dy
        c33 = torch.stack([reg[..., None, 0] + dxf * -1.0, reg[..., None, 1] + dyf * -1.0,
                           reg[..., None, 2] + dxf, reg[..., None, 3] + dyf], dim=-1)  # [B, N, 9, 4]
        mask_l.append(inb & (c33.amin(dim=-1) >= 0))
        inds_l.append(idx.clamp(0, m - 1).long())
        regs_l.append(c33)

    inds = torch.stack(inds_l, dim=2)  # [B, N, L, 9]
    masks = torch.stack(mask_l, dim=2)
    regs = torch.stack(regs_l, dim=2)  # [B, N, L, 9, 4]
    level_ok = torch.stack(level_ok_l, dim=2)  # [B, N, L]

    flat_inds = inds.reshape(bsz, -1)
    pred = torch.gather(reg_pred, 1, flat_inds[..., None].expand(-1, -1, 4)).reshape(bsz, n, num_l, k, 4)
    loss = iou_loss_ltrb(pred, regs.clamp(min=0.0), None, loss_type=loc_loss_type)
    loss = torch.where(masks & gt_valid[:, :, None, None], loss, torch.full_like(loss, INF))
    # the true center gets loss 0 where the level carries the object
    center = torch.where(level_ok, torch.zeros_like(loss[..., 4]), loss[..., 4])
    loss = torch.cat([loss[..., :4], center[..., None], loss[..., 5:]], dim=-1)
    kth = torch.sort(loss.reshape(bsz, n, num_l * k), dim=-1).values[..., min(more_pos_topk, num_l * k) - 1]
    thresh = kth.clamp(max=more_pos_thresh)
    new_pos = loss < thresh[..., None, None]
    return flat_inds, (new_pos & gt_valid[:, :, None, None]).reshape(bsz, -1)
