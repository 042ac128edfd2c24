"""Fixed-capacity masked non-maximum suppression, plain PyTorch (counterpart
of ``faster_orefsdet_tpu/ops/nms.py``).

These are the plain twin and the oracle of the NMS kernel
(``ops/nms_cuda.py``). Semantics, shared by all three:

- greedy suppression in descending score order, ties to the lower index;
- a kept box suppresses another when their IoU is strictly greater than the
  threshold;
- invalid boxes neither suppress nor survive.

Every function takes an optional leading batch axis: boxes [..., K, 4],
scores [..., K], valid [..., K] bool.
"""

from __future__ import annotations

import torch

from ..structures.boxes import pairwise_iou


def _higher(scores: torch.Tensor) -> torch.Tensor:
    """higher[..., i, j]: box i ranks before box j (score, then lower index)."""
    k = scores.shape[-1]
    idx = torch.arange(k, device=scores.device)
    si = scores[..., :, None]
    sj = scores[..., None, :]
    return (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))


def nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy NMS keep mask by the peeling fixpoint over the rank-ordered
    suppression DAG: each round keeps every undecided box that no live
    higher-ranked box overlaps, then removes every undecided box a kept box
    overlaps. No sort; O(depth) rounds of K-wide reductions."""
    valid = valid.bool()
    iou = pairwise_iou(boxes, boxes)
    e = (iou > iou_threshold) & _higher(scores) & valid[..., :, None] & valid[..., None, :]
    kept = torch.zeros_like(valid)
    undecided = valid.clone()
    while bool(undecided.any()):
        active = kept | undecided
        blocked = (e & active[..., :, None]).any(dim=-2)
        kept = kept | (undecided & ~blocked)
        crushed = (e & kept[..., :, None]).any(dim=-2)
        undecided = undecided & ~kept & ~crushed
    return kept


def nms_mask_sequential(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy NMS for one image [K] by a K-step loop in rank order (oracle)."""
    valid = valid.bool()
    k = scores.shape[0]
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.sort(torch.where(valid, scores, neg_inf), descending=True, stable=True).indices
    suppress = pairwise_iou(boxes[order], boxes[order]) > iou_threshold
    svalid = valid[order]
    keep_sorted = torch.zeros(k, dtype=torch.bool)
    suppressed = torch.zeros(k, dtype=torch.bool)
    for i in range(k):
        keep_i = bool(svalid[i]) and not bool(suppressed[i])
        keep_sorted[i] = keep_i
        if keep_i:
            suppressed |= suppress[i]
    keep = torch.zeros(k, dtype=torch.bool)
    keep[order] = keep_sorted
    return keep


def class_offset_boxes(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The coordinate-offset trick of d2's batched_nms: shift each box by its
    class times one more than the largest valid coordinate of its row, so
    that boxes of different classes never overlap. boxes [..., K, 4],
    classes [..., K] -> shifted boxes [..., K, 4]."""
    masked = torch.where(valid[..., None], boxes, torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    max_coord = masked.amax(dim=(-2, -1), keepdim=True) + 1.0  # [..., 1, 1]
    return boxes + classes.to(boxes.dtype)[..., None] * max_coord


def batched_nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Class-aware NMS keep mask: ``nms_mask`` on the class-offset boxes."""
    if boxes.shape[-2] == 0:
        return valid.bool()
    return nms_mask(class_offset_boxes(boxes, classes, valid), scores, valid, iou_threshold)


def keep_top_scores(scores: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Keep entries whose score is >= the k-th largest valid score (the
    reference's kthvalue trim: ties at the k-th value are all kept). No trim
    where there are at most k valid entries."""
    valid = valid.bool()
    n = scores.shape[-1]
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    kth = torch.sort(masked, dim=-1, descending=True).values[..., min(k, n) - 1, None]
    num_valid = valid.sum(dim=-1, keepdim=True)
    return torch.where(num_valid > k, valid & (masked >= kth), valid)
