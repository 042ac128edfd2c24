"""The AttentionRPN baseline (FsodRCNN) pipelines: support cache, inference
and the episodic training loss (counterpart of
``faster_orefsdet_tpu/pipelines/attention_rpn.py``).

  cache      res4 of each shot, its box pooled to 14x14, res5 on that; the
             dense-relation enhancement of both, shot-averaged, per class
  inference  per class: attention RPN -> proposals (the NMS kernel on the
             card, one launch for every class) -> 14x14 ROI pooling ->
             res5 -> relation head; then the class-aware NMS across classes
             (the NMS kernel again) and the top detections
  training   the same per image with the RPN's anchor losses, the ROI
             sampler and the relation head's hard-negative CE; on the card a
             step is ``baseline_loss_fn`` + ``backward`` + ``solver.sgd_update``

Batches are the port's ``TrainBatch`` of normalized float tensors, NCHW:
images [B, 3, H, W], support_images [B, S, 3, h, w], support_boxes [B, S, 4].
Builders run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..config import ROIConfig
from ..models.attention_rpn import (
    FsodRCNN, generate_anchors, rpn_label_anchors, rpn_losses, rpn_predict_proposals,
)
from ..models.cascade_roi import label_proposals, subsample_proposals
from ..models.centernet import stable_topk
from ..ops import nms_cuda
from ..ops.losses import smooth_l1_loss
from ..ops.roi_align import roi_align
from ..structures.boxes import apply_deltas, clip_boxes, encode_deltas
from ..structures.instances import Detections, GroundTruth
from ..utils.device import resolve_device
from .graphs import PinnedFn
from .train_step import TrainBatch


@dataclass(frozen=True)
class BaselineConfig:
    """Effective knobs of Base-FSOD-C4.yaml (a copy of the JAX package's,
    guarded against drift by tests/test_torch_config.py)."""

    depth: int = 50
    stride: int = 16
    pooler_resolution: int = 14
    sampling_ratio: int = 0  # adaptive ROIAlignV2 sampling (ops/roi_align.py)
    # RPN
    rpn_pre_nms_topk_train: int = 2000
    rpn_post_nms_topk_train: int = 512
    rpn_pre_nms_topk_test: int = 1000
    rpn_post_nms_topk_test: int = 100
    rpn_nms_thresh: float = 0.7
    rpn_batch_size: int = 256
    rpn_positive_fraction: float = 0.5
    # ROI
    roi_batch_size: int = 128
    roi_positive_fraction: float = 0.5
    roi_iou_threshold: float = 0.5
    num_classes: int = 1
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    smooth_l1_beta: float = 0.0
    test_score_thresh: float = 0.05
    test_nms_thresh: float = 0.5
    detections_per_image: int = 100
    support_shot: int = 10
    compute_dtype: str = "float32"


class BaselineSupportCache(NamedTuple):
    res4_avg: torch.Tensor  # [N, 1, 14, 14, 1024] per class, the enhanced RPN support map
    res5_avg: torch.Tensor  # [N, 1, 7, 7, 2048] per class, the enhanced ROI-head support


def make_fsod_rcnn(cfg: BaselineConfig, params: Optional[Mapping[str, torch.Tensor]] = None, *,
                   device="cuda") -> FsodRCNN:
    """The baseline model on `device` in eval mode, with `params` (a
    state_dict, loaded strictly) when given."""
    dev = resolve_device(device)
    dtype = None if cfg.compute_dtype in (None, "", "float32") else getattr(torch, cfg.compute_dtype)
    model = FsodRCNN(depth=cfg.depth, dtype=dtype)
    if params is not None:
        model.load_state_dict(params, strict=True)
    return model.to(dev).eval()


def _pool_supports(model: FsodRCNN, support_images: torch.Tensor, support_boxes: torch.Tensor,
                   cfg: BaselineConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shot's box pooled from its res4 [S, 14, 14, 1024], and res5 on
    that [S, 7, 7, 2048] (channel-last)."""
    res4 = model.features(support_images)
    pooled14 = roi_align(res4, support_boxes.reshape(-1, 1, 4), 1.0 / cfg.stride, cfg.pooler_resolution,
                         cfg.sampling_ratio)[:, 0]
    return pooled14, model.res5_transform(pooled14)


def _enhanced(model: FsodRCNN, pooled14: torch.Tensor, res5: torch.Tensor):
    s = pooled14.shape[0]
    return (model.enhance_support_rpn(pooled14.reshape(s, 196, pooled14.shape[-1])),
            model.enhance_support_rcnn(res5.reshape(s, 49, res5.shape[-1])))


@torch.inference_mode()
def baseline_cache_from_model(model: FsodRCNN, support_images: torch.Tensor, support_boxes: torch.Tensor,
                              cfg: BaselineConfig) -> BaselineSupportCache:
    """One class's cache. support_images [S, 3, Hs, Ws] normalized, padded
    to a multiple of 32; support_boxes [S, 4]; both on the model's device."""
    res4_avg, res5_avg = _enhanced(model, *_pool_supports(model, support_images, support_boxes.float(), cfg))
    return BaselineSupportCache(res4_avg[None], res5_avg[None])


def build_baseline_cache(cfg: BaselineConfig, params: Mapping[str, torch.Tensor], support_images: torch.Tensor,
                         support_boxes: torch.Tensor, *, device="cuda") -> BaselineSupportCache:
    """Build the baseline with `params` on `device` and encode the shots into
    a one-class cache on that device."""
    model = make_fsod_rcnn(cfg, params, device=device)
    dev = next(model.parameters()).device
    return baseline_cache_from_model(model, support_images.to(dev), support_boxes.to(dev), cfg)


@torch.inference_mode()
def baseline_inference_single(model: FsodRCNN, cache: BaselineSupportCache, image: torch.Tensor,
                              image_hw: torch.Tensor, cfg: BaselineConfig) -> Detections:
    """One canvas [3, H, W] through the per-class protocol -> Detections
    [detections_per_image] (classes index the cache's classes)."""
    res4 = model.features(image[None])  # [1, 1024, h, w]
    feat_hw = tuple(res4.shape[-2:])
    anchors = generate_anchors(feat_hw, cfg.stride, device=res4.device)
    n_cls = cache.res4_avg.shape[0]
    heads = [model.rpn_head(model.rpn_attention(res4, cache.res4_avg[c])) for c in range(n_cls)]
    props = rpn_predict_proposals(anchors, torch.stack([h[0] for h in heads]), torch.stack([h[1] for h in heads]),
                                  image_hw, pre_nms_topk=cfg.rpn_pre_nms_topk_test,
                                  post_nms_topk=cfg.rpn_post_nms_topk_test, nms_thresh=cfg.rpn_nms_thresh)
    r = props.boxes.shape[1]
    pooled = roi_align(res4.expand(n_cls, -1, -1, -1), props.boxes, 1.0 / cfg.stride, cfg.pooler_resolution,
                       cfg.sampling_ratio)  # [N, R, 14, 14, 1024]
    box_feats = model.res5_transform(pooled.reshape(n_cls * r, *pooled.shape[2:])).reshape(n_cls, r, 7, 7, -1)
    preds = [model.relation(box_feats[c], cache.res5_avg[c]) for c in range(n_cls)]
    probs = torch.stack([torch.softmax(p.scores, dim=-1)[:, 0] for p in preds]).reshape(-1)  # fg probability
    deltas = torch.stack([p.deltas for p in preds])
    boxes = clip_boxes(apply_deltas(deltas, props.boxes, cfg.bbox_reg_weights), image_hw).reshape(-1, 4)
    classes = torch.arange(n_cls, device=res4.device, dtype=torch.int32).repeat_interleave(r)
    valid = props.valid.reshape(-1) & (probs > cfg.test_score_thresh)
    keep = nms_cuda.batched_nms_mask(boxes[None], probs[None], classes[None], valid[None], cfg.test_nms_thresh)[0]
    sel_scores, sel_idx = stable_topk(torch.where(keep, probs, torch.full_like(probs, -1.0)),
                                      cfg.detections_per_image)
    return Detections(boxes=boxes[sel_idx], scores=sel_scores.clamp(min=0.0), classes=classes[sel_idx],
                      valid=sel_scores > 0.0)


def _check_baseline_cache(cache: BaselineSupportCache, dev: torch.device) -> BaselineSupportCache:
    if any(t.device != dev for t in cache):
        raise ValueError(f"baseline cache on {cache.res4_avg.device}, the model on {dev}: "
                         f"build it with device={str(dev)!r}")
    return cache


def build_baseline_inference_fn(cfg: BaselineConfig, params: Mapping[str, torch.Tensor], *, device="cuda"):
    """(cache, image [3, H, W], image_hw (h, w)) -> Detections, on `device`
    (the card unless the caller asks for the CPU). The cache must live there."""
    model = make_fsod_rcnn(cfg, params, device=device)
    dev = next(model.parameters()).device

    def fn(cache: BaselineSupportCache, image: torch.Tensor, image_hw) -> Detections:
        hw = torch.as_tensor(image_hw, dtype=torch.float32).to(dev)
        return baseline_inference_single(model, _check_baseline_cache(cache, dev), image.to(dev).contiguous(), hw,
                                         cfg)

    return fn


class _PinnedBaselineFn(PinnedFn):
    """fn(image, image_hw) -> Detections (see
    ``build_pinned_baseline_inference_fn``)."""

    def __init__(self, cfg: BaselineConfig, params: Mapping[str, torch.Tensor], cache: BaselineSupportCache, *,
                 device="cuda"):
        model = make_fsod_rcnn(cfg, params, device=device)
        dev = next(model.parameters()).device
        cache = _check_baseline_cache(cache, dev)
        super().__init__(lambda image, hw: baseline_inference_single(model, cache, image, hw, cfg), dev)

    def __call__(self, image: torch.Tensor, image_hw) -> Detections:
        # (h, w) goes to the graph's static buffer from a host tensor
        return super().__call__(image, torch.as_tensor(image_hw, dtype=torch.float32))


def build_pinned_baseline_inference_fn(cfg: BaselineConfig, params: Mapping[str, torch.Tensor],
                                       cache: BaselineSupportCache, *, device="cuda"):
    """``build_baseline_inference_fn`` with the weights and the cache fixed
    at build time: fn(image [3, H, W], image_hw (h, w)) -> Detections, one
    CUDA graph per (canvas, dtype) on the card (``PinnedFn``). Rebuild the
    function after changing the weights or the cache. On the CPU it runs the
    eager path."""
    return _PinnedBaselineFn(cfg, params, cache, device=device)


# ------------------------------------------------------------------ training
def hard_negative_ce(scores: torch.Tensor, gt_classes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """FsodFastRCNNOutputs' CE over the foreground and the hardest
    backgrounds (by foreground probability), 2 x num_fg (at most n / 4) of
    them in the first half of the slots and num_fg in the second. scores
    [..., n, 2]; gt_classes, valid [..., n] -> [...]. Ranks break ties to the
    lower slot, as the JAX package's stable argsort."""
    n = scores.shape[-2]
    fg_prob = torch.softmax(scores, dim=-1)[..., 0]
    fg = valid & (gt_classes == 0)
    bg = valid & (gt_classes == 1)
    num_fg = fg.sum(-1, keepdim=True)
    bg_num_0 = (num_fg * 2).clamp(max=n // 4).clamp(min=1)
    bg_num_1 = torch.minimum(num_fg, bg_num_0).clamp(min=1)
    idx = torch.arange(n, device=scores.device)

    def topk_mask(mask, k):
        key = torch.where(mask, fg_prob, torch.full_like(fg_prob, -1.0))
        rank = torch.argsort(torch.argsort(-key, dim=-1, stable=True), dim=-1, stable=True)
        return mask & (rank < k)

    selected = fg | topk_mask(bg & (idx < n // 2), bg_num_0) | topk_mask(bg & (idx >= n // 2), bg_num_1)
    ll = torch.gather(scores, -1, gt_classes.long()[..., None])[..., 0]
    loss = torch.where(selected, torch.logsumexp(scores, dim=-1) - ll, torch.zeros_like(ll))
    return loss.sum(-1) / selected.sum(-1).clamp(min=1)


def _roi_cfg(cfg: BaselineConfig) -> ROIConfig:
    return ROIConfig(cascade_ious=(cfg.roi_iou_threshold,), batch_size_per_image=cfg.roi_batch_size,
                     positive_fraction=cfg.roi_positive_fraction, num_classes=cfg.num_classes)


def baseline_loss_fn(model: FsodRCNN, batch: TrainBatch, cfg: BaselineConfig,
                     generator: Optional[torch.Generator] = None, *,
                     injected_rois: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {loss: scalar}) of one episodic batch, each loss the mean over
    its images. `generator` draws the anchor and ROI samples; it may live
    on the CPU while the model is on the card (the draws are moved), so that
    both devices see the same samples. The proposal NMS runs without
    gradient (the NMS kernel on the card, one launch for the batch).

    injected_rois=(boxes [B, R, 4], valid [B, R]) replaces the proposals and
    the ROI sampling by a fixed set, labelled by the matcher at
    roi_iou_threshold like a sampled one (as ``train_step.loss_fn``'s hook),
    so that two devices can be held to one ROI set."""
    b, s = batch.support_images.shape[:2]
    dev = batch.images.device
    res4 = model.features(batch.images)
    pooled14, sup_res5 = _pool_supports(model, batch.support_images.reshape(b * s, *batch.support_images.shape[2:]),
                                        batch.support_boxes.reshape(b * s, 4), cfg)
    feat_hw = tuple(res4.shape[-2:])
    anchors = generate_anchors(feat_hw, cfg.stride, device=dev)
    image_hw = torch.tensor([feat_hw[0] * cfg.stride, feat_hw[1] * cfg.stride], dtype=torch.float32, device=dev)
    gt = GroundTruth(batch.gt_boxes, torch.zeros_like(batch.gt_classes), batch.gt_valid)

    per_image, logits_all, deltas_all, res5_avgs = [], [], [], []
    for i in range(b):
        res4_avg, res5_avg = _enhanced(model, pooled14[i * s:(i + 1) * s], sup_res5[i * s:(i + 1) * s])
        logits, deltas = model.rpn_head(model.rpn_attention(res4[i:i + 1], res4_avg))
        labels, matched = rpn_label_anchors(anchors, GroundTruth(*(t[i] for t in gt)), generator,
                                            cfg.rpn_batch_size, cfg.rpn_positive_fraction)
        per_image.append(rpn_losses(anchors, logits, deltas, labels, matched, cfg.rpn_batch_size,
                                    cfg.smooth_l1_beta))
        logits_all.append(logits.detach())
        deltas_all.append(deltas.detach())
        res5_avgs.append(res5_avg)

    if injected_rois is None:
        with torch.no_grad():
            props = rpn_predict_proposals(anchors, torch.stack(logits_all), torch.stack(deltas_all), image_hw,
                                          pre_nms_topk=cfg.rpn_pre_nms_topk_train,
                                          post_nms_topk=cfg.rpn_post_nms_topk_train, nms_thresh=cfg.rpn_nms_thresh)
        boxes, gt_cls, gt_boxes, slot_valid = subsample_proposals(generator, props.boxes, props.valid, gt,
                                                                  _roi_cfg(cfg))
    else:
        boxes, slot_valid = injected_rois
        gt_cls, gt_boxes = label_proposals(boxes, slot_valid, gt, cfg.roi_iou_threshold, cfg.num_classes)
    r = boxes.shape[1]
    pooled = roi_align(res4, boxes, 1.0 / cfg.stride, cfg.pooler_resolution, cfg.sampling_ratio)
    box_feats = model.res5_transform(pooled.reshape(b * r, *pooled.shape[2:]))
    fg = slot_valid & (gt_cls == 0)
    tgt = encode_deltas(boxes, gt_boxes, cfg.bbox_reg_weights)
    for i in range(b):
        pred = model.relation(box_feats[i * r:(i + 1) * r], res5_avgs[i])
        per_image[i]["loss_cls"] = hard_negative_ce(pred.scores, gt_cls[i], slot_valid[i])
        reg = smooth_l1_loss(pred.deltas, tgt[i], cfg.smooth_l1_beta)
        per_image[i]["loss_box_reg"] = (torch.where(fg[i, :, None], reg, torch.zeros_like(reg)).sum()
                                        / slot_valid[i].sum().clamp(min=1))
    losses = {k: torch.stack([d[k] for d in per_image]).mean() for k in per_image[0]}
    return sum(losses.values()), losses
