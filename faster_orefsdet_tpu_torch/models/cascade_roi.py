"""Cascade ROI head with support-conditioned DSA fusion, its training-side
sampling and losses, and the final detection stage (counterpart of
``faster_orefsdet_tpu/models/cascade_roi.py``).

The head runs in f32, as the JAX package's does (its Dense layers promote the
pooled features against f32 parameters). Pooled features are channel-last
[.., P, P, C] and fc1 flattens them in HWC order, the JAX package's order,
so its weight carries over by a plain transpose.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import ROIConfig
from ..ops.losses import smooth_l1_loss, softmax_cross_entropy
from ..ops.nms_cuda import nms_mask
from ..ops.roi_align import multilevel_roi_align
from ..structures.boxes import clip_boxes, encode_deltas, pairwise_iou
from ..structures.instances import Detections, GroundTruth
from .centernet import stable_topk
from .layers import at_least_f32, linear

ROI_STRIDES = (8, 16, 32)


class StageOutput(NamedTuple):
    scores: torch.Tensor  # [..., K, 2] class logits (fg, bg)
    deltas: torch.Tensor  # [..., K, 4] class-agnostic box deltas


class DSACascadeHead(nn.Module):
    def __init__(self, cfg: ROIConfig, channels: int = 128):
        super().__init__()
        self.cfg = cfg
        c = channels
        p = cfg.pooler_resolution
        self.dsa_conv1 = nn.Linear(c, c // 2)
        self.dsa_conv2 = nn.Linear(c, c // 2)
        self.dsa_conv3 = nn.Linear(2 * c, c)
        for st in range(len(cfg.cascade_ious)):
            self.add_module(f"stage{st}_fc1", nn.Linear(p * p * c, cfg.fc_dim))
            self.add_module(f"stage{st}_cls", nn.Linear(cfg.fc_dim, cfg.num_classes + 1))
            self.add_module(f"stage{st}_bbox", nn.Linear(cfg.fc_dim, 4))

    def forward(self, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                support_8: torch.Tensor, support_4: torch.Tensor, stage: int) -> StageOutput:
        """features: [B, C, H_l, W_l] per level; boxes [B, K, 4]; support_8
        the shot-mean support ROI features, [P, P, C] for every row or
        [B, P, P, C] one per row (the multiclass path's classes). support_4
        feeds only the reference's discarded 4x4 branch and is not used."""
        cfg = self.cfg
        q8 = multilevel_roi_align(
            features, boxes, ROI_STRIDES, cfg.pooler_resolution, cfg.pooler_sampling_ratio,
            cfg.canonical_box_size, cfg.canonical_level,
        )  # [B, K, P, P, C]
        s8 = support_8.to(q8.dtype)
        if s8.dim() == 4:
            s8 = s8[:, None]
        s8 = s8.expand(q8.shape)
        fused = linear(torch.cat([q8, s8], dim=-1), self.dsa_conv3)
        branch = torch.cat([linear(q8, self.dsa_conv1), linear(s8, self.dsa_conv2)], dim=-1)
        attn8 = fused + branch
        x = attn8.reshape(*attn8.shape[:2], -1)  # HWC flatten
        x = at_least_f32(torch.relu(linear(x, getattr(self, f"stage{stage}_fc1"))))
        scores = linear(x, getattr(self, f"stage{stage}_cls"))
        deltas = linear(x, getattr(self, f"stage{stage}_bbox"))
        return StageOutput(scores=scores, deltas=deltas)


# ------------------------------------------------------------------ sampling

def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, K] -> [B, K, ...]."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(*idx.shape, *x.shape[2:]))


def match_proposals(prop_boxes: torch.Tensor, prop_valid: torch.Tensor, gt: GroundTruth,
                    iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """d2 Matcher([thr], [0, 1], allow_low_quality=False) over a batch:
    prop_boxes [B, K, 4], prop_valid [B, K], gt [B, N] -> (matched gt index
    [B, K] int64, fg [B, K]): fg iff the best IoU with a valid gt box is >= thr
    (ties to the lower gt index)."""
    iou = pairwise_iou(gt.boxes, prop_boxes)  # [B, N, K]
    iou = torch.where(gt.valid[..., None], iou, torch.full_like(iou, -1.0))
    matched_iou, matched_idx = iou.max(dim=1)
    return matched_idx, (matched_iou >= iou_threshold) & prop_valid


def label_proposals(boxes: torch.Tensor, slot_valid: torch.Tensor, gt: GroundTruth,
                    iou_threshold: float, num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(class targets [B, K] int64, num_classes = background; box targets
    [B, K, 4]) of a fixed proposal set matched at `iou_threshold`."""
    midx, fg = match_proposals(boxes, slot_valid, gt, iou_threshold)
    cls_t = torch.where(fg & slot_valid, torch.gather(gt.classes.long(), 1, midx),
                        torch.full_like(midx, num_classes))
    return cls_t, _gather_rows(gt.boxes, midx)


def subsample_proposals(generator: Optional[torch.Generator], prop_boxes: torch.Tensor,
                        prop_valid: torch.Tensor, gt: GroundTruth, cfg: ROIConfig,
                        rows: Optional[Tuple[int, int]] = None):
    """label_and_sample_proposals with PROPOSAL_APPEND_GT, batched: append
    the gt boxes to the proposals, match at cascade_ious[0], then take
    `batch_size_per_image` of them, at most `positive_fraction` positive.
    Each candidate gets a uniform key drawn from `generator` on its own
    device (the model's, or the CPU's to give the card and the CPU the same
    draws; the keys are then moved to the boxes' device); positives and
    negatives are ranked by it separately and the first num_pos / num_neg of
    each kept, then the selection is compacted into exactly
    `batch_size_per_image` slots.

    rows = (first, total): the keys are drawn for the `total` images of a
    global batch, and these B images keep rows first .. first + B of them
    (a data-parallel rank's share: N ranks then draw what one rank draws
    over the global batch).

    Returns (boxes [B, R, 4], class targets [B, R] int64 (num_classes =
    background), box targets [B, R, 4], slot_valid [B, R])."""
    boxes = torch.cat([prop_boxes, gt.boxes], dim=1)
    valid = torch.cat([prop_valid, gt.valid], dim=1)
    matched_idx, fg = match_proposals(boxes, valid, gt, cfg.cascade_ious[0])

    batch = cfg.batch_size_per_image
    max_pos = int(batch * cfg.positive_fraction)
    b, k = boxes.shape[:2]
    first, total = rows or (0, b)
    dev = generator.device if generator is not None else boxes.device
    r = torch.rand((total, k), generator=generator, device=dev)[first:first + b].to(boxes.device)
    two = torch.full_like(r, 2.0)
    neg = valid & ~fg
    # the rank of each positive among the positives, each negative among the negatives
    pos_rank = torch.argsort(torch.argsort(torch.where(fg, r, two), dim=1, stable=True), dim=1, stable=True)
    neg_rank = torch.argsort(torch.argsort(torch.where(neg, r, two), dim=1, stable=True), dim=1, stable=True)
    num_pos = fg.sum(1, keepdim=True).clamp(max=max_pos)
    num_neg = torch.minimum(neg.sum(1, keepdim=True), batch - num_pos)
    selected = (fg & (pos_rank < num_pos)) | (neg & (neg_rank < num_neg))

    # compact: the selected first, in the order of their keys
    order = torch.argsort(torch.where(selected, r, two), dim=1, stable=True)[:, :batch]
    slot_valid = torch.gather(selected, 1, order)
    s_match = torch.gather(matched_idx, 1, order)
    s_fg = torch.gather(fg, 1, order)
    gt_classes = torch.where(s_fg & slot_valid, torch.gather(gt.classes.long(), 1, s_match),
                             torch.full_like(s_match, cfg.num_classes))
    return _gather_rows(boxes, order), gt_classes, _gather_rows(gt.boxes, s_match), slot_valid


# ------------------------------------------------------------------ losses

def stage_losses(out: StageOutput, prop_boxes: torch.Tensor, gt_classes: torch.Tensor,
                 gt_boxes: torch.Tensor, slot_valid: torch.Tensor, cfg: ROIConfig,
                 stage: int) -> Dict[str, torch.Tensor]:
    """FastRCNNOutputLayers.losses per image: the mean CE over the sampled
    rows, and L1 (smooth_l1 at beta 0) over the foreground deltas divided by
    the sampled count. All inputs [B, R, ...] -> {name: [B]}."""
    loss_cls = softmax_cross_entropy(out.scores, gt_classes, slot_valid)
    fg = slot_valid & (gt_classes < cfg.num_classes)
    target_deltas = encode_deltas(prop_boxes, gt_boxes, cfg.cascade_bbox_reg_weights[stage])
    reg = smooth_l1_loss(out.deltas, target_deltas, cfg.smooth_l1_beta)
    reg = torch.where(fg[..., None], reg, torch.zeros_like(reg))
    loss_reg = reg.sum((-2, -1)) / slot_valid.sum(-1).clamp(min=1)
    return {f"loss_cls_stage{stage}": loss_cls, f"loss_box_reg_stage{stage}": loss_reg}


# ------------------------------------------------------------------ inference

def roi_inference(
    stage_outputs: Sequence[StageOutput],
    final_boxes: torch.Tensor,
    prop_valid: torch.Tensor,
    image_hw: torch.Tensor,
    cfg: ROIConfig,
    proposal_scores: torch.Tensor | None = None,
) -> Detections:
    """Cascade score averaging + fast_rcnn_inference for a batch:
    final_boxes [B, K, 4], prop_valid [B, K], image_hw [B, 2] ->
    Detections [B, detections_per_image, ...]."""
    probs = [torch.softmax(o.scores, dim=-1) for o in stage_outputs]
    scores = sum(probs) / len(probs)
    if cfg.mult_proposal_score and proposal_scores is not None:
        scores = torch.sqrt(torch.clamp(scores * proposal_scores[..., None], min=0.0))
    s = scores[..., 0]  # the single foreground class
    boxes = clip_boxes(final_boxes, image_hw)
    finite = torch.isfinite(s) & torch.isfinite(boxes).all(dim=-1)
    valid = prop_valid & (s > cfg.score_thresh_test) & finite
    keep = nms_mask(boxes.contiguous(), s.contiguous(), valid.contiguous(), cfg.nms_thresh_test)
    topk = min(cfg.detections_per_image, s.shape[-1])
    sel_scores, sel_idx = stable_topk(torch.where(keep, s, torch.full_like(s, -1.0)), topk)
    sel_boxes = torch.gather(boxes, 1, sel_idx[..., None].expand(-1, -1, 4))
    return Detections(
        boxes=sel_boxes,
        scores=torch.clamp(sel_scores, min=0.0),
        classes=torch.zeros(sel_idx.shape, dtype=torch.int32, device=s.device),
        valid=sel_scores > 0.0,
    )
