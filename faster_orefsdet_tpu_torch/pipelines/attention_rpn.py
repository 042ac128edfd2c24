"""The AttentionRPN baseline (FsodRCNN) pipelines: support cache, inference
and the episodic training loss (counterpart of
``faster_orefsdet_tpu/pipelines/attention_rpn.py``).

  cache      res4 of each shot, its box pooled to 14x14, res5 on that; the
             dense-relation enhancement of both, shot-averaged, per class
  inference  a batch of canvases, per class: attention RPN -> proposals
             (the NMS kernel on the card, one launch for every image and
             class) -> 14x14 ROI pooling (the ROIAlign gather kernel on the
             card, one launch) -> res5 -> relation head; then the
             class-aware NMS across classes (the NMS kernel again, one
             launch for the batch) and the top detections
             (``baseline_query_path``); raw camera frames resized, normalized
             and padded on the card first, the boxes scaled back to the
             frame after (``build_pinned_baseline_serving_fn``, through
             ``inference.raw_frame_body``)
  training   the same per image with the RPN's anchor losses, the ROI
             sampler and the relation head's hard-negative CE; on the card a
             step is ``baseline_loss_fn`` + ``backward`` + ``solver.sgd_update``

Batches are the port's ``TrainBatch`` of normalized float tensors, NCHW:
images [B, 3, H, W], support_images [B, S, 3, h, w], support_boxes [B, S, 4].
Builders run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..config import InputConfig, ROIConfig
from ..models.attention_rpn import (
    FsodRCNN, generate_anchors, rpn_label_anchors, rpn_losses, rpn_predict_proposals,
)
from ..models.cascade_roi import label_proposals, subsample_proposals
from ..models.centernet import stable_topk
from ..ops import nms_cuda
from ..ops.losses import smooth_l1_loss
from ..ops.roi_align_cuda import roi_pool
from ..structures.boxes import apply_deltas, clip_boxes, encode_deltas
from ..structures.instances import Detections, GroundTruth
from ..utils import profiling
from ..utils.device import resolve_device
from .graphs import PinnedFn
from .inference import PinnedImagesFn, raw_frame_body
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
    pooled14 = roi_pool(res4, support_boxes.reshape(-1, 1, 4), 1.0 / cfg.stride, cfg.pooler_resolution,
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
def baseline_query_path(model: FsodRCNN, cache: BaselineSupportCache, images: torch.Tensor,
                        image_hw: torch.Tensor, cfg: BaselineConfig) -> Detections:
    """Canvases [B, 3, H, W] normalized and their image_hw [B, 2] (h, w)
    before padding, through the per-class protocol -> Detections
    [B, min(detections_per_image, N x rpn_post_nms_topk_test)] (classes
    index the cache's N classes). The batch runs through every phase, the
    NMS kernel included: one launch for the B x N proposal rows, one for
    the B class-aware rows. Each phase is a ``utils.profiling.stage``."""
    b = images.shape[0]
    n_cls = cache.res4_avg.shape[0]
    with profiling.stage("features"):
        res4 = model.features(images)  # [B, 1024, h, w]
    with profiling.stage("attention_rpn"):
        heads = [model.rpn_head(model.rpn_attention(res4, cache.res4_avg[c])) for c in range(n_cls)]
        logits = torch.stack([h[0] for h in heads], 1)  # [B, N, K]: row b*N + c once flattened
        deltas = torch.stack([h[1] for h in heads], 1)
    with profiling.stage("proposals"):
        anchors = generate_anchors(tuple(res4.shape[-2:]), cfg.stride, device=res4.device)
        props = rpn_predict_proposals(anchors, logits.flatten(0, 1), deltas.flatten(0, 1),
                                      image_hw.repeat_interleave(n_cls, dim=0),
                                      pre_nms_topk=cfg.rpn_pre_nms_topk_test,
                                      post_nms_topk=cfg.rpn_post_nms_topk_test, nms_thresh=cfg.rpn_nms_thresh)
    r = props.boxes.shape[1]
    proposals = props.boxes.reshape(b, n_cls * r, 4)
    with profiling.stage("roi_pool"):
        pooled = roi_pool(res4, proposals, 1.0 / cfg.stride, cfg.pooler_resolution,
                          cfg.sampling_ratio)  # [B, N*R, 14, 14, 1024]
    with profiling.stage("res5"):
        box_feats = model.res5_transform(pooled.flatten(0, 1)).reshape(b, n_cls, r, 7, 7, -1)
    with profiling.stage("relation"):
        preds = [model.relation(box_feats[:, c].flatten(0, 1), cache.res5_avg[c]) for c in range(n_cls)]
    with profiling.stage("detections"):
        # fg probability and boxes [B, N*R], class-major within an image
        probs = torch.stack([torch.softmax(p.scores, dim=-1)[:, 0].reshape(b, r) for p in preds], 1).flatten(1)
        deltas = torch.stack([p.deltas.reshape(b, r, 4) for p in preds], 1).flatten(1, 2)
        boxes = clip_boxes(apply_deltas(deltas, proposals, cfg.bbox_reg_weights), image_hw)
        classes = torch.arange(n_cls, device=res4.device, dtype=torch.int32).repeat_interleave(r).expand(b, -1)
        valid = props.valid.reshape(b, n_cls * r) & (probs > cfg.test_score_thresh)
        keep = nms_cuda.batched_nms_mask(boxes, probs, classes, valid, cfg.test_nms_thresh)
        sel_scores, sel_idx = stable_topk(torch.where(keep, probs, torch.full_like(probs, -1.0)),
                                          cfg.detections_per_image)
        return Detections(boxes=torch.gather(boxes, 1, sel_idx[..., None].expand(-1, -1, 4)),
                          scores=sel_scores.clamp(min=0.0),
                          classes=torch.gather(classes, 1, sel_idx), valid=sel_scores > 0.0)


def baseline_inference_single(model: FsodRCNN, cache: BaselineSupportCache, image: torch.Tensor,
                              image_hw: torch.Tensor, cfg: BaselineConfig) -> Detections:
    """One canvas [3, H, W] and its image_hw [2]: ``baseline_query_path`` at
    batch 1 -> Detections [detections_per_image]."""
    det = baseline_query_path(model, cache, image[None], image_hw[None], cfg)
    return Detections(*(t[0] for t in det))


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


def _baseline_query(cfg: BaselineConfig, params: Mapping[str, torch.Tensor], cache: BaselineSupportCache,
                    device) -> Tuple[torch.device, Callable[..., Detections]]:
    """The baseline of `cfg` on its card `dev` -> (dev, query): query(images
    [B, 3, H, W], image_hw [B, 2]) -> ``baseline_query_path`` over `cache`,
    refused here unless it lives on `dev`."""
    model = make_fsod_rcnn(cfg, params, device=device)
    dev = next(model.parameters()).device
    cache = _check_baseline_cache(cache, dev)
    return dev, lambda images, image_hw: baseline_query_path(model, cache, images, image_hw, cfg)


def build_pinned_baseline_inference_fn(cfg: BaselineConfig, params: Mapping[str, torch.Tensor],
                                       cache: BaselineSupportCache, *, device="cuda") -> PinnedImagesFn:
    """``build_baseline_inference_fn`` with the weights and the cache fixed
    at build time: fn(image [3, H, W], image_hw (h, w)) -> Detections, or a
    batch [B, 3, H, W] with image_hw [B, 2] -> [B, ...]
    (``baseline_query_path`` at batch B), one CUDA graph per (batch, canvas,
    dtype) on the card (``PinnedFn``). Rebuild the function after changing
    the weights or the cache. On the CPU it runs the eager path."""
    dev, query = _baseline_query(cfg, params, cache, device)
    return PinnedImagesFn(query, dev)


def build_pinned_baseline_serving_fn(cfg: BaselineConfig, params: Mapping[str, torch.Tensor],
                                     cache: BaselineSupportCache, input_hw: Tuple[int, int], input_cfg: InputConfig,
                                     *, device="cuda") -> Tuple[PinnedFn, Tuple[int, int]]:
    """Raw frames [B, 3, H0, W0] (uint8 or float) of a camera of fixed size
    input_hw -> Detections [B, ...] in frame coordinates, with the weights
    and the cache fixed at build time: the frames resized to `input_cfg`'s
    test size (the shorter side to min_size_test, the longer capped at
    max_size_test), normalized by its pixel statistics and padded to its
    size divisibility on the device, then ``baseline_query_path``, then the
    boxes scaled back to the frame (``inference.raw_frame_body``), in one
    CUDA graph per (batch, dtype) on the card (``PinnedFn``).
    ``BaselineConfig`` holds no input settings (it is the JAX package's
    field for field), so they come in as `input_cfg`: Base-FSOD-C4.yaml's
    INPUT is min 600, max 1000. Returns (fn, canvas_hw). Rebuild the
    function after changing the weights or the cache. On the CPU it runs
    the eager path."""
    dev, query = _baseline_query(cfg, params, cache, device)
    run, canvas_hw = raw_frame_body(query, input_hw, input_cfg, dev)
    return PinnedFn(run, dev), canvas_hw


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
        logits, deltas = (t[0] for t in model.rpn_head(model.rpn_attention(res4[i:i + 1], res4_avg)))
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
    pooled = roi_pool(res4, boxes, 1.0 / cfg.stride, cfg.pooler_resolution, cfg.sampling_ratio)
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
