"""CenterNet proposal decode and training losses, batched (counterpart of
``faster_orefsdet_tpu/models/centernet.py``).

Decode, per image: sqrt(sigmoid) scores, per-level score threshold and
pre-NMS top-k, cross-level concat, the NMS working-set cap, class-agnostic
NMS (the NMS kernel on the card), the kthvalue post-NMS trim, and compaction
to the post-NMS capacity. Top-k here is a stable descending sort, so ties
resolve to the lower index as XLA's top_k does. The training decode uses
the train budgets: at the full canvas the NMS kernel sees [B, 2048].
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CenterNetConfig
from ..ops.heatmap import CenterNetTargets, compute_grids, level_grid_shapes
from ..ops.losses import binary_heatmap_focal_loss, iou_loss_ltrb
from ..ops.nms import keep_top_scores
from ..ops.nms_cuda import nms_mask
from ..structures.boxes import ltrb_to_xyxy
from ..structures.instances import Proposals
from .layers import at_least_f32


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, D], idx [B, K] -> [B, K, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _level_valid_mask(canvas_hw, strides, image_hw: torch.Tensor) -> torch.Tensor:
    """[B, M] mask of the grid cells the reference would have produced: the
    reference pads each image only to a multiple of 32, so cells beyond
    ceil32(image size) do not exist there."""
    h32 = torch.ceil(image_hw[:, 0] / 32.0) * 32.0
    w32 = torch.ceil(image_hw[:, 1] / 32.0) * 32.0
    dev = image_hw.device
    masks = []
    for (hl, wl), s in zip(level_grid_shapes(canvas_hw, strides), strides):
        iy = torch.arange(hl, dtype=torch.float32, device=dev)[None, :, None]
        ix = torch.arange(wl, dtype=torch.float32, device=dev)[None, None, :]
        m = (iy < (h32 / s)[:, None, None]) & (ix < (w32 / s)[:, None, None])
        masks.append(m.reshape(m.shape[0], -1))
    return torch.cat(masks, dim=1)


def decode_proposals(
    agn_hms: Sequence[torch.Tensor],
    bbox_regs: Sequence[torch.Tensor],
    cfg: CenterNetConfig,
    canvas_hw: Tuple[int, int],
    image_hw: torch.Tensor,
    *,
    training: bool = False,
    nms_budget: Optional[int] = None,
) -> Proposals:
    """agn_hms[l] [B,1,H_l,W_l] logits, bbox_regs[l] [B,4,H_l,W_l] (relu'd,
    stride units), image_hw [B,2] -> Proposals [B, post_nms_topk, ...], with
    the test or (training=True) the train top-k sizes and NMS threshold.
    nms_budget caps the candidates entering NMS: the inference builders pass
    cfg.static.nms_budget_test; by default it is max(2048, post_nms_topk_train)
    in training, else 1024."""
    pre_topk = cfg.pre_nms_topk_train if training else cfg.pre_nms_topk_test
    post_topk = cfg.post_nms_topk_train if training else cfg.post_nms_topk_test
    nms_th = cfg.nms_thresh_train if training else cfg.nms_thresh_test
    if nms_budget is None:
        nms_budget = max(2048, post_topk) if training else 1024
    strides = cfg.fpn_strides
    dev = agn_hms[0].device
    grids = compute_grids(tuple(canvas_hw), tuple(strides), device=dev)
    valid_canvas = _level_valid_mask(canvas_hw, strides, image_hw)
    shapes = level_grid_shapes(canvas_hw, strides)
    offsets = np.cumsum([0] + [hl * wl for hl, wl in shapes])

    cand_scores, cand_boxes, cand_valid = [], [], []
    for li, s in enumerate(strides):
        b = agn_hms[li].shape[0]
        hm = torch.sigmoid(agn_hms[li].reshape(b, -1).float())
        reg = bbox_regs[li].permute(0, 2, 3, 1).reshape(b, -1, 4).float() * s
        g = grids[offsets[li]:offsets[li + 1]]
        vmask = valid_canvas[:, offsets[li]:offsets[li + 1]]
        cand = (hm > cfg.score_thresh) & vmask
        k = min(pre_topk, hm.shape[1])
        top_scores, top_idx = stable_topk(torch.where(cand, hm, torch.full_like(hm, -1.0)), k)
        cand_boxes.append(ltrb_to_xyxy(g[top_idx], _gather_rows(reg, top_idx)))
        cand_scores.append(torch.sqrt(torch.clamp(top_scores, min=0.0)))
        cand_valid.append(top_scores > 0.0)

    scores = torch.cat(cand_scores, dim=1)
    boxes = torch.cat(cand_boxes, dim=1)
    valid = torch.cat(cand_valid, dim=1)

    if scores.shape[1] > nms_budget:
        scores, top_idx = stable_topk(torch.where(valid, scores, torch.full_like(scores, -1.0)), nms_budget)
        boxes = _gather_rows(boxes, top_idx)
        valid = scores > 0.0

    keep = nms_mask(boxes.contiguous(), scores.contiguous(), valid.contiguous(), nms_th)
    post_topk = min(post_topk, scores.shape[1])
    keep = keep_top_scores(scores, keep, post_topk)
    sel_scores, sel_idx = stable_topk(torch.where(keep, scores, torch.full_like(scores, -1.0)), post_topk)
    return Proposals(
        boxes=_gather_rows(boxes, sel_idx),
        scores=torch.clamp(sel_scores, min=0.0),
        valid=sel_scores > 0.0,
    )


def centernet_losses(
    agn_hms: Sequence[torch.Tensor],
    bbox_regs: Sequence[torch.Tensor],
    targets: CenterNetTargets,
    cfg: CenterNetConfig,
    canvas_valid: torch.Tensor,
    *,
    num_pos_avg: torch.Tensor,
    reg_norm: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The proposal stage's training losses per image: agn_hms / bbox_regs
    as the head gives them, targets for the batch, canvas_valid [B, M] (the
    cells that exist in the reference), num_pos_avg the mean positive count
    (computed once by the caller). The localization loss is normalized by
    reg_norm (a scalar or [B], e.g. a mean count over data-parallel ranks),
    by default each image's own count of pixels with a regression target.
    Returns {name: [B]}; the caller takes the mean over images."""
    b = agn_hms[0].shape[0]
    agn_flat = at_least_f32(torch.cat([h.reshape(b, -1) for h in agn_hms], dim=1))
    reg_flat = at_least_f32(torch.cat([r.permute(0, 2, 3, 1).reshape(b, -1, 4) for r in bbox_regs], dim=1))

    # localization: gIoU over the pixels with a target; unit weights (NOT_NORM_REG)
    reg_valid = (targets.reg_targets.amax(dim=-1) >= 0) & canvas_valid
    weights = reg_valid.float()
    reg_losses = iou_loss_ltrb(reg_flat.clamp(min=0.0), targets.reg_targets.clamp(min=0.0), weights,
                               loss_type=cfg.loc_loss_type)
    if reg_norm is None:
        reg_norm = weights.sum(-1).clamp(min=1.0)
    loss_loc = cfg.reg_weight * reg_losses.sum(-1) / reg_norm

    pos_sum, neg_sum = binary_heatmap_focal_loss(
        agn_flat, targets.heatmap, targets.pos_inds, targets.pos_mask, canvas_valid,
        beta=cfg.hm_focal_beta, gamma=cfg.loss_gamma, sigmoid_clamp=cfg.sigmoid_clamp,
        ignore_high_fp=cfg.ignore_high_fp,
    )
    return {
        "loss_centernet_loc": loss_loc,
        "loss_centernet_agn_pos": cfg.pos_weight * pos_sum / num_pos_avg,
        "loss_centernet_agn_neg": cfg.neg_weight * neg_sum / num_pos_avg,
    }
