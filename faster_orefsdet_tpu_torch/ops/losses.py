"""Loss functions of the CenterNet proposal stage and the cascade ROI stage
(counterpart of ``faster_orefsdet_tpu/ops/losses.py``), in f32 as the JAX
package computes them.

Every function takes any leading batch axes: the positive pixels are fixed
-size padded index arrays with a validity mask, and the sums run over the
trailing axes only, so a batch of images gives one value per image.
"""

from __future__ import annotations

from typing import Optional

import torch


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    # the JAX package's explicit 1 / (1 + exp(-x)), for the same roundings
    return 1.0 / (1.0 + torch.exp(-x))


def binary_heatmap_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pos_inds: torch.Tensor,
    pos_mask: torch.Tensor,
    hm_mask: torch.Tensor,
    *,
    beta: float = 4.0,
    gamma: float = 2.0,
    sigmoid_clamp: float = 1e-4,
    ignore_high_fp: float = -1.0,
):
    """Agnostic-heatmap focal loss. logits / targets [..., M] (heatmap in
    [0, 1]); pos_inds [..., P] padded flat positive indices, pos_mask [..., P];
    hm_mask [..., M] the valid pixels. Returns (pos_loss_sum, neg_loss_sum)
    [...]; the caller applies the weights and the num_pos normalizer."""
    pred = torch.clamp(_sigmoid(logits), sigmoid_clamp, 1.0 - sigmoid_clamp)
    neg_weights = torch.pow(1.0 - targets, beta)
    pos_pred = torch.gather(pred, -1, pos_inds.long())
    pos_loss = torch.log(pos_pred) * torch.pow(1.0 - pos_pred, gamma)
    pos_loss = torch.where(pos_mask, pos_loss, torch.zeros_like(pos_loss))
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, gamma) * neg_weights
    if ignore_high_fp > 0:
        neg_loss = neg_loss * (pred < ignore_high_fp).to(neg_loss.dtype)
    neg_loss = torch.where(hm_mask, neg_loss, torch.zeros_like(neg_loss))
    return -pos_loss.sum(-1), -neg_loss.sum(-1)


def heatmap_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pos_inds: torch.Tensor,
    labels: torch.Tensor,
    pos_mask: torch.Tensor,
    hm_mask: torch.Tensor,
    *,
    alpha: float = 0.25,
    beta: float = 4.0,
    gamma: float = 2.0,
    sigmoid_clamp: float = 1e-4,
    ignore_high_fp: float = -1.0,
):
    """Class-aware heatmap focal loss: logits / targets [..., M, C], labels
    [..., P] the class of each positive. Returns (pos, neg) sums [...]."""
    pred = torch.clamp(_sigmoid(logits), sigmoid_clamp, 1.0 - sigmoid_clamp)
    neg_weights = torch.pow(1.0 - targets, beta)
    rows = torch.gather(pred, -2, pos_inds.long()[..., None].expand(*pos_inds.shape, pred.shape[-1]))
    pos_pred = torch.gather(rows, -1, labels.long()[..., None])[..., 0]
    pos_loss = torch.log(pos_pred) * torch.pow(1.0 - pos_pred, gamma)
    pos_loss = torch.where(pos_mask, pos_loss, torch.zeros_like(pos_loss))
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, gamma) * neg_weights
    if ignore_high_fp > 0:
        neg_loss = neg_loss * (pred < ignore_high_fp).to(neg_loss.dtype)
    neg_loss = torch.where(hm_mask[..., None], neg_loss, torch.zeros_like(neg_loss))
    pos_sum, neg_sum = pos_loss.sum(-1), neg_loss.sum((-2, -1))
    if alpha >= 0:
        return -alpha * pos_sum, -(1.0 - alpha) * neg_sum
    return -pos_sum, -neg_sum


def iou_loss_ltrb(
    pred: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    loss_type: str = "giou",
) -> torch.Tensor:
    """IoU loss on (l, t, r, b) distances [..., 4] -> elementwise [...]; rows
    without a target are masked by a zero weight."""
    pl_, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = target.unbind(-1)

    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl_ + pr) * (pt + pb)

    w_intersect = torch.minimum(pl_, tl) + torch.minimum(pr, tr)
    h_intersect = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_w = torch.maximum(pl_, tl) + torch.maximum(pr, tr)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w * g_h

    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect
    ious = (area_intersect + 1.0) / (area_union + 1.0)
    if loss_type == "iou":
        losses = -torch.log(ious.clamp(min=1e-12))
    elif loss_type == "linear_iou":
        losses = 1.0 - ious
    elif loss_type == "giou":
        gious = ious - (ac_union - area_union) / ac_union.clamp(min=1e-12)
        losses = 1.0 - gious
    else:
        raise ValueError(loss_type)
    if weight is not None:
        losses = losses * weight
    return losses


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """fvcore smooth_l1_loss, elementwise; beta <= 0 is |x| (the live setting)."""
    diff = torch.abs(pred - target)
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid rows: logits [..., K, C], labels /
    valid [..., K] -> [...]."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.where(valid, logz - ll, torch.zeros_like(logz))
    return loss.sum(-1) / valid.sum(-1).clamp(min=1)
