"""Box operations on plain ``[..., 4]`` xyxy tensors (counterpart of
``faster_orefsdet_tpu/structures/boxes.py``). Box arithmetic runs in f32."""

from __future__ import annotations

import math

import torch

# d2's Box2BoxTransform scale clamp: log(1000/16)
SCALE_CLAMP = math.log(1000.0 / 16.0)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape [..., 4] -> [...]."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def nonempty_mask(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Boxes [..., 4] whose width and height both exceed `threshold`."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., N, M] between xyxy box sets [..., N, 4] and [..., M, 4],
    zero where the boxes do not intersect.

    The operation order (union = (a1 + a2) - inter, then one division) is the
    JAX package's; the NMS kernel repeats it in round-to-nearest intrinsics so
    that its keep mask equals this one bit for bit.
    """
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(inter > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Clip xyxy boxes [..., K, 4] to [0, w] x [0, h]; image_hw [..., 2] = (h, w)."""
    h = image_hw[..., 0, None]
    w = image_hw[..., 1, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def encode_deltas(src_boxes: torch.Tensor, target_boxes: torch.Tensor, weights) -> torch.Tensor:
    """Box2BoxTransform.get_deltas: the (dx, dy, dw, dh) [..., 4] that map
    src (proposal) boxes onto target (gt) boxes, scaled by `weights`."""
    sw = src_boxes[..., 2] - src_boxes[..., 0]
    sh = src_boxes[..., 3] - src_boxes[..., 1]
    scx = src_boxes[..., 0] + 0.5 * sw
    scy = src_boxes[..., 1] + 0.5 * sh

    tw = target_boxes[..., 2] - target_boxes[..., 0]
    th = target_boxes[..., 3] - target_boxes[..., 1]
    tcx = target_boxes[..., 0] + 0.5 * tw
    tcy = target_boxes[..., 1] + 0.5 * th

    wx, wy, ww, wh = weights
    eps = 1e-12
    dx = wx * (tcx - scx) / sw.clamp(min=eps)
    dy = wy * (tcy - scy) / sh.clamp(min=eps)
    dw = ww * torch.log(tw.clamp(min=eps) / sw.clamp(min=eps))
    dh = wh * torch.log(th.clamp(min=eps) / sh.clamp(min=eps))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: decode class-agnostic deltas [..., 4]
    onto boxes [..., 4] (f32)."""
    deltas = deltas.float()
    boxes = boxes.float()
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=SCALE_CLAMP)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w,
            pred_ctr_y + 0.5 * pred_h,
        ],
        dim=-1,
    )


def ltrb_to_xyxy(grids: torch.Tensor, ltrb: torch.Tensor) -> torch.Tensor:
    """Decode (l, t, r, b) distances at grid centers to xyxy boxes, with the
    +0.01 min-extent guard of the reference decode."""
    x1 = grids[..., 0] - ltrb[..., 0]
    y1 = grids[..., 1] - ltrb[..., 1]
    x2 = grids[..., 0] + ltrb[..., 2]
    y2 = grids[..., 1] + ltrb[..., 3]
    x2 = torch.maximum(x2, x1 + 0.01)
    y2 = torch.maximum(y2, y1 + 0.01)
    return torch.stack([x1, y1, x2, y2], dim=-1)
