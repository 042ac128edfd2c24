"""Cascade ROI head with support-conditioned DSA fusion, eval mode, and the
final detection stage (counterpart of the inference half of
``faster_orefsdet_tpu/models/cascade_roi.py``).

The head runs in f32, as the JAX package's does (its Dense layers promote the
pooled features against f32 parameters). Pooled features are channel-last
[.., P, P, C] and fc1 flattens them in HWC order, the JAX package's order,
so its weight carries over by a plain transpose.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn

from ..config import ROIConfig
from ..ops.nms_cuda import nms_mask
from ..ops.roi_align import multilevel_roi_align
from ..structures.boxes import clip_boxes
from ..structures.instances import Detections
from .centernet import stable_topk
from .layers import linear

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
        x = torch.relu(linear(x, getattr(self, f"stage{stage}_fc1"))).float()
        scores = linear(x, getattr(self, f"stage{stage}_cls"))
        deltas = linear(x, getattr(self, f"stage{stage}_bbox"))
        return StageOutput(scores=scores, deltas=deltas)


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
