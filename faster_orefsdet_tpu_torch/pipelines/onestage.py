"""The one-stage CenterNet detector (counterpart of
``faster_orefsdet_tpu/pipelines/onestage.py``): VoVNet + FPN + the
class-aware CenterNet head, with no support matching and no ROI stage.

Its decode is class-aware: per level the heatmap is sigmoid(class logits)
times sigmoid(agnostic heatmap), the top-k runs over (location, class)
pairs, then the class-aware NMS (the NMS kernel on the card, over the class
offset boxes), the kthvalue trim and the final top-k. Top-k is a stable
descending sort, so ties go to the lower index as XLA's top_k does.

Over P3-P7 (``fpn.top_levels=2``, strides 8-128) the stride-2 P6/P7 convs
round their maps up while the grids floor ``h // s``: a canvas that is not a
multiple of the coarsest stride would pair cells with the wrong grid points,
so the decode refuses it (pad with ``input.size_divisibility``: a VGA frame
at short side 320 serves on a 384x512 canvas at P7).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..config import Config
from ..models.centernet import _gather_rows, _level_valid_mask, stable_topk
from ..models.centernet_head import CenterNetHead
from ..models.detector import compute_dtype
from ..models.fpn import FPN
from ..models.vovnet import VoVNet
from ..ops import nms_cuda
from ..ops.heatmap import compute_grids, level_grid_shapes
from ..ops.nms import keep_top_scores
from ..structures.boxes import ltrb_to_xyxy
from ..structures.instances import Detections
from ..utils.device import resolve_device
from .inference import PinnedImagesFn, _hw


class OneStageCenterNet(nn.Module):
    """Backbone + FPN + class-aware CenterNet head (at least one class conv)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        cn = cfg.centernet
        self.backbone = VoVNet(cfg.vovnet.conv_body, cfg.vovnet.out_features, dtype=self.dtype)
        chans = VoVNet.out_channels(cfg.vovnet.conv_body)
        self.fpn = FPN([chans[f] for f in cfg.fpn.in_features], cfg.fpn.in_features, cfg.fpn.out_channels,
                       top_levels=cfg.fpn.top_levels, dtype=self.dtype)
        self.head = CenterNetHead(
            in_channels=cfg.fpn.out_channels, num_levels=len(cn.in_features),
            num_cls_convs=max(cn.num_cls_convs, 1), num_classes=cn.num_classes,
            num_box_convs=cn.num_box_convs, with_agn_hm=cn.with_agn_hm, only_proposal=False,
            prior_prob=cn.prior_prob, dtype=self.dtype,
        )

    def cast_compute_weights(self) -> "OneStageCenterNet":
        """Store the weights of the layers that run in the compute dtype in
        that dtype (the cast those layers apply at each use)."""
        if self.dtype is not None:
            self.backbone.to(self.dtype)
            for m in self.fpn.compute_convs() + self.head.tower_convs():
                m.to(self.dtype)
        return self

    def forward(self, images: torch.Tensor):
        """images [B, 3, H, W] normalized -> (clss, agn_hms, bbox_regs), per
        level of cfg.centernet.in_features."""
        feats = self.fpn(self.backbone(images.contiguous(memory_format=torch.channels_last)))
        return self.head([feats[level] for level in self.cfg.centernet.in_features])


def check_canvas(canvas_hw: Tuple[int, int], strides: Sequence[int]) -> None:
    """Refuse a canvas the coarsest stride does not divide (its grids would
    not be the maps' shapes)."""
    top = max(strides)
    if canvas_hw[0] % top or canvas_hw[1] % top:
        raise ValueError(
            f"canvas {canvas_hw[0]}x{canvas_hw[1]} is not a multiple of the coarsest stride {top} of "
            f"fpn_strides {tuple(strides)}: pad it to a multiple of {top} (input.size_divisibility={top})")


def decode_multiclass(clss: Sequence[torch.Tensor], agn_hms: Sequence[Optional[torch.Tensor]],
                      bbox_regs: Sequence[torch.Tensor], cfg: Config, canvas_hw: Tuple[int, int],
                      image_hw: torch.Tensor) -> Detections:
    """Class-aware decode of a batch: clss[l] [B, N, H_l, W_l] logits,
    agn_hms[l] [B, 1, H_l, W_l] logits (or None), bbox_regs[l]
    [B, 4, H_l, W_l] (relu'd, stride units), image_hw [B, 2] -> Detections
    [B, post_nms_topk_test, ...] with class ids 0..N-1 in canvas
    coordinates. One NMS call (one kernel launch on the card) serves the
    batch."""
    cn = cfg.centernet
    strides = tuple(cn.fpn_strides)
    check_canvas(canvas_hw, strides)
    n_cls = cn.num_classes
    dev = clss[0].device
    grids = compute_grids(tuple(canvas_hw), strides, device=dev)
    valid_canvas = _level_valid_mask(canvas_hw, strides, image_hw)
    shapes = level_grid_shapes(canvas_hw, strides)
    offsets = np.cumsum([0] + [hl * wl for hl, wl in shapes])

    all_scores, all_boxes, all_classes = [], [], []
    for li, s in enumerate(strides):
        b = clss[li].shape[0]
        hm = torch.sigmoid(clss[li].permute(0, 2, 3, 1).reshape(b, -1, n_cls).float())
        if cn.with_agn_hm and agn_hms[li] is not None:
            hm = hm * torch.sigmoid(agn_hms[li].reshape(b, -1, 1).float())
        reg = bbox_regs[li].permute(0, 2, 3, 1).reshape(b, -1, 4).float() * s
        g = grids[offsets[li]:offsets[li + 1]]
        vmask = valid_canvas[:, offsets[li]:offsets[li + 1]]
        flat = hm.reshape(b, -1)  # [B, M_l * N] candidates over (location, class)
        cand = (flat > cn.score_thresh) & vmask.repeat_interleave(n_cls, dim=1)
        k = min(cn.pre_nms_topk_test, flat.shape[1])
        top_scores, top_idx = stable_topk(torch.where(cand, flat, torch.full_like(flat, -1.0)), k)
        loc = torch.div(top_idx, n_cls, rounding_mode="floor")
        all_boxes.append(ltrb_to_xyxy(g[loc], _gather_rows(reg, loc)))
        all_scores.append(top_scores)
        all_classes.append((top_idx % n_cls).to(torch.int32))

    scores = torch.cat(all_scores, dim=1)
    boxes = torch.cat(all_boxes, dim=1)
    classes = torch.cat(all_classes, dim=1)
    valid = scores > 0.0
    keep = nms_cuda.batched_nms_mask(boxes, scores, classes, valid, cn.nms_thresh_test)
    keep = keep_top_scores(scores, keep, cn.post_nms_topk_test)
    sel_scores, sel_idx = stable_topk(torch.where(keep, scores, torch.full_like(scores, -1.0)),
                                      cn.post_nms_topk_test)
    return Detections(
        boxes=_gather_rows(boxes, sel_idx),
        scores=torch.clamp(sel_scores, min=0.0),
        classes=torch.gather(classes, 1, sel_idx),
        valid=sel_scores > 0.0,
    )


def make_onestage(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None,
                  *, device="cuda") -> OneStageCenterNet:
    """The one-stage detector of `cfg` on `device` in eval mode, with
    `params` (a state_dict, loaded strictly) when given."""
    dev = resolve_device(device)
    model = OneStageCenterNet(cfg)
    if params is not None:
        model.load_state_dict(params, strict=True)
    return model.to(dev).cast_compute_weights().eval()


def build_onestage_inference_fn(cfg: Config, params: Optional[Mapping[str, torch.Tensor]], *,
                                device="cuda") -> Callable[..., Detections]:
    """fn(image, image_hw) -> Detections: image one normalized canvas
    [3, Hc, Wc] with image_hw (h, w) -> Detections [K, ...], or a batch
    [B, 3, Hc, Wc] with image_hw [B, 2] -> [B, K, ...], on `device`. The
    canvas must be a multiple of the coarsest stride (``check_canvas``)."""
    model = make_onestage(cfg, params, device=device)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def fn(image: torch.Tensor, image_hw) -> Detections:
        single = image.dim() == 3
        images = (image[None] if single else image).to(dev).contiguous()
        canvas_hw = (images.shape[-2], images.shape[-1])
        check_canvas(canvas_hw, cfg.centernet.fpn_strides)
        hw = _hw(image_hw, (images.shape[0],), dev)
        with record_function("onestage_forward"):
            clss, agn_hms, regs = model(images)
        with record_function("decode_multiclass"):
            det = decode_multiclass(clss, agn_hms, regs, cfg, canvas_hw, hw)
        return Detections(*(t[0] for t in det)) if single else det

    return fn


def build_pinned_onestage_inference_fn(cfg: Config, params: Optional[Mapping[str, torch.Tensor]], *,
                                       device="cuda") -> PinnedImagesFn:
    """``build_onestage_inference_fn`` with the weights fixed at build time:
    the forward and the class-aware decode in one CUDA graph per (batch,
    canvas, dtype) on the card (``PinnedFn``); the same calls and results.
    Rebuild the function after changing the weights. On the CPU it runs the
    eager path."""
    model = make_onestage(cfg, params, device=device)

    @torch.inference_mode()
    def run(images: torch.Tensor, image_hw: torch.Tensor) -> Detections:
        canvas_hw = (images.shape[-2], images.shape[-1])
        check_canvas(canvas_hw, cfg.centernet.fpn_strides)
        clss, agn_hms, regs = model(images)
        return decode_multiclass(clss, agn_hms, regs, cfg, canvas_hw, image_hw)

    return PinnedImagesFn(run, next(model.parameters()).device)
