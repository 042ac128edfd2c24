"""Headless debug overlays: CenterNet's debug_train / debug_test /
debug_second_stage as PNG files (counterpart of
``faster_orefsdet_tpu/utils/debug_vis.py``).

The reference (CenterNet2/centernet/modeling/debug.py:73-258, gated by
cfg.DEBUG) pops cv2 windows; these write PNGs to a directory instead.
Heatmaps are drawn per level with a jet colormap and blended over the
denormalized canvas; boxes follow the reference's colors (ground truth red,
positives blue markers, proposals green, detections red with their scores).

Inputs may be numpy arrays or CPU tensors; a canvas is [H, W, 3] (numpy) or
the port's [3, H, W] tensor. cv2 is imported only when something is drawn.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch


def _cv2():
    import cv2

    return cv2


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def level_shapes(canvas_hw: Tuple[int, int], strides: Sequence[int]) -> List[Tuple[int, int]]:
    return [(canvas_hw[0] // s, canvas_hw[1] // s) for s in strides]


def split_levels(flat, canvas_hw, strides) -> List[np.ndarray]:
    """A flat per-pixel vector [M, ...] over the levels -> per-level maps
    [H_l, W_l, ...] (debug.py:33-48 _decompose_level)."""
    flat = _np(flat)
    out, off = [], 0
    for h, w in level_shapes(canvas_hw, strides):
        out.append(flat[off:off + h * w].reshape(h, w, *flat.shape[1:]))
        off += h * w
    return out


def denormalize(image, pixel_mean, pixel_std) -> np.ndarray:
    """A normalized canvas -> uint8 [H, W, 3] in the config's channel order
    (BGR for the reference weights)."""
    if isinstance(image, torch.Tensor) and image.dim() == 3 and image.shape[0] == 3:
        image = image.permute(1, 2, 0)
    img = _np(image) * np.asarray(pixel_std) + np.asarray(pixel_mean)
    return np.clip(img, 0, 255).astype(np.uint8)


def heatmap_color(hm) -> np.ndarray:
    """[H, W] in [0, 1] -> jet color image (debug.py:9-18)."""
    cv2 = _cv2()
    return cv2.applyColorMap((np.clip(_np(hm), 0, 1) * 255).astype(np.uint8), cv2.COLORMAP_JET)


def blend_heatmaps(image: np.ndarray, hms: Sequence, a: float = 0.7) -> np.ndarray:
    """Blend per-level heatmaps resized onto the image (debug.py:20-31)."""
    cv2 = _cv2()
    out = image.astype(np.float32)
    for hm in hms:
        cm = cv2.resize(heatmap_color(hm), (image.shape[1], image.shape[0]))
        out = out * a + cm.astype(np.float32) * (1 - a)
    return np.clip(out, 0, 255).astype(np.uint8)


def _draw_boxes(img, boxes, color, thickness=2, scores=None):
    cv2 = _cv2()
    for i, b in enumerate(_np(boxes).reshape(-1, 4)):
        x0, y0, x1, y1 = [int(round(float(v))) for v in b]
        cv2.rectangle(img, (x0, y0), (x1, y1), color, thickness, cv2.LINE_AA)
        if scores is not None:
            cv2.putText(img, f"{float(scores[i]):.2f}", (x0, max(y0 - 3, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1, cv2.LINE_AA)
    return img


def debug_train(image, targets, gt_boxes, gt_valid, canvas_hw: Tuple[int, int], strides: Sequence[int],
                out_dir: str, prefix: str = "train", pixel_mean=(0, 0, 0), pixel_std=(1, 1, 1)) -> List[str]:
    """The ground-truth heatmap per level, and its blend with the gt boxes
    and the positive locations (debug.py:73-138). targets: one image's
    ``ops.heatmap.CenterNetTargets`` (heatmap [M], pos_inds, pos_mask)."""
    cv2 = _cv2()
    os.makedirs(out_dir, exist_ok=True)
    img = denormalize(image, pixel_mean, pixel_std)
    hms = [h[..., 0] if h.ndim == 3 else h for h in split_levels(targets.heatmap, canvas_hw, strides)]
    paths = []
    for lv, hm in enumerate(hms):
        p = os.path.join(out_dir, f"{prefix}_gthm_{lv}.png")
        cv2.imwrite(p, heatmap_color(hm))
        paths.append(p)
    blend = blend_heatmaps(img, hms)
    _draw_boxes(blend, _np(gt_boxes)[_np(gt_valid)], (0, 0, 255), 3)
    # positive locations (blue markers, debug.py:117-121)
    shapes = level_shapes(canvas_hw, strides)
    offs = np.concatenate([[0], np.cumsum([h * w for h, w in shapes])])
    for ind in _np(targets.pos_inds)[_np(targets.pos_mask)]:
        lv = int(np.searchsorted(offs, ind, side="right") - 1)
        y, x = divmod(int(ind - offs[lv]), shapes[lv][1])
        center = (int((x + 0.5) * strides[lv]), int((y + 0.5) * strides[lv]))
        cv2.drawMarker(blend, center, (255, 0, 0), cv2.MARKER_CROSS, 8, 2)
    p = os.path.join(out_dir, f"{prefix}_blend.png")
    cv2.imwrite(p, blend)
    paths.append(p)
    return paths


def debug_test(image, agn_hms: Sequence, proposals, out_dir: str, prefix: str = "test", vis_thresh: float = 0.3,
               pixel_mean=(0, 0, 0), pixel_std=(1, 1, 1)) -> List[str]:
    """The predicted heatmap per level, and its blend with the proposals
    above vis_thresh (debug.py:141-215). agn_hms: per-level [H_l, W_l, 1]
    sigmoided maps; proposals: one image's Proposals."""
    cv2 = _cv2()
    os.makedirs(out_dir, exist_ok=True)
    img = denormalize(image, pixel_mean, pixel_std)
    hms = [_np(h)[..., 0] for h in agn_hms]
    paths = []
    for lv, hm in enumerate(hms):
        p = os.path.join(out_dir, f"{prefix}_predhm_{lv}.png")
        cv2.imwrite(p, heatmap_color(hm))
        paths.append(p)
    blend = blend_heatmaps(img, hms)
    scores = _np(proposals.scores)
    keep = _np(proposals.valid) & (scores > vis_thresh)
    _draw_boxes(blend, _np(proposals.boxes)[keep], (0, 255, 0), 2, scores=scores[keep])
    p = os.path.join(out_dir, f"{prefix}_proposals.png")
    cv2.imwrite(p, blend)
    paths.append(p)
    return paths


def debug_second_stage(image, detections, out_dir: str, prefix: str = "stage2", vis_thresh: float = 0.3,
                       pixel_mean=(0, 0, 0), pixel_std=(1, 1, 1)) -> str:
    """The final detections above vis_thresh (debug.py:218-258)."""
    cv2 = _cv2()
    os.makedirs(out_dir, exist_ok=True)
    img = denormalize(image, pixel_mean, pixel_std).copy()
    scores = _np(detections.scores)
    keep = _np(detections.valid) & (scores > vis_thresh)
    _draw_boxes(img, _np(detections.boxes)[keep], (0, 0, 255), 2, scores=scores[keep])
    p = os.path.join(out_dir, f"{prefix}_detections.png")
    cv2.imwrite(p, img)
    return p
