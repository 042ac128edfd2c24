"""The query path from normalized canvases to detections (counterpart of
``faster_orefsdet_tpu/pipelines/inference.py``).

backbone -> CGM correlation against the support cache (CGM kernel) ->
CenterNet decode with NMS (NMS kernel) -> cascade ROI -> final NMS (NMS
kernel) -> top-k. The batch dimension runs through every stage, kernels
included: one launch per level or per NMS site serves the whole batch. Each
stage is a named profiler range (``torch.profiler.record_function``), which
the profile phase of ``chip_smoke.py`` reads.

The builders construct the detector from `cfg` themselves, so a model can
never run under a config it was not built for.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import Config
from ..models.cascade_roi import roi_inference
from ..models.centernet import decode_proposals
from ..models.detector import CenterNet2Detector, support_kernels
from ..structures.boxes import apply_deltas, clip_boxes
from ..structures.instances import Detections
from ..utils.device import resolve_device
from .support_cache import SupportCache


def make_detector(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None,
                  *, device="cuda") -> CenterNet2Detector:
    """The detector of `cfg` on `device` in eval mode, with `params` (a
    state_dict, loaded strictly) when given."""
    dev = resolve_device(device)
    if cfg.model_name != "CenterNet2Detector":
        raise ValueError(f"model_name={cfg.model_name!r}: this config family builds 'CenterNet2Detector'")
    model = CenterNet2Detector(cfg)
    if params is not None:
        model.load_state_dict(params, strict=True)
    return model.to(dev).cast_compute_weights().eval()


@torch.inference_mode()
def query_path(model: CenterNet2Detector, cache: SupportCache, images: torch.Tensor,
               image_hw: torch.Tensor) -> Detections:
    """images [B, 3, Hc, Wc] normalized, padded canvases; image_hw [B, 2] the
    true (h, w) before padding -> Detections [B, K, ...] in resized-image
    coordinates."""
    cfg = model.cfg
    canvas_hw = (images.shape[-2], images.shape[-1])
    with record_function("features"):
        feats = model.features(images)
    with record_function("correlate"):
        kernels = {level: support_kernels(getattr(cache, level)) for level in model.levels}
        pos_feats = model.correlate(feats, kernels)
    with record_function("proposal_head"):
        agn_hms, bbox_regs = model.proposal_head(pos_feats)
    with record_function("decode_proposals"):
        proposals = decode_proposals(
            agn_hms, bbox_regs, cfg.centernet, canvas_hw, image_hw,
            nms_budget=cfg.static.nms_budget_test,
        )
    # stage k > 0 re-pools on the previous stage's boxes, clipped to the image
    feat_list = [feats[level] for level in ("p3", "p4", "p5")]
    boxes = proposals.boxes
    stage_outputs = []
    n_stages = len(cfg.roi.cascade_ious)
    with record_function("roi_stage"):
        for stage in range(n_stages):
            out = model.roi_stage(feat_list, boxes, cache.rcnn_8, cache.rcnn_4, stage)
            stage_outputs.append(out)
            boxes = apply_deltas(out.deltas, boxes, cfg.roi.cascade_bbox_reg_weights[stage])
            if stage + 1 < n_stages:
                boxes = clip_boxes(boxes, image_hw)
    with record_function("roi_inference"):
        return roi_inference(stage_outputs, boxes, proposals.valid, image_hw, cfg.roi,
                             proposal_scores=proposals.scores)


def query_path_single(model: CenterNet2Detector, cache: SupportCache, image: torch.Tensor,
                      image_hw: torch.Tensor) -> Detections:
    """One canvas [3, Hc, Wc] and its image_hw [2] -> Detections [K, ...]."""
    det = query_path(model, cache, image[None], image_hw[None])
    return Detections(*(t[0] for t in det))


def _hw(image_hw, batch_shape, dev) -> torch.Tensor:
    hw = torch.as_tensor(image_hw, dtype=torch.float32, device=dev)
    return hw.expand(*batch_shape, 2) if hw.dim() == 1 and batch_shape else hw


def _check_cache(cache: SupportCache, dev: torch.device) -> SupportCache:
    """The cache is built or loaded once onto the model's device; a request
    never copies it there."""
    if any(t.device != dev for t in cache):
        raise ValueError(f"support cache on {cache.p3.device}, the model on {dev}: "
                         f"build or load the cache with device={str(dev)!r}")
    return cache


def build_inference_fn(cfg: Config, params: Mapping[str, torch.Tensor], *,
                       device="cuda") -> Callable[..., Detections]:
    """(cache, image [3, Hc, Wc] normalized, image_hw (h, w)) -> Detections
    [K, ...] on `device`: the batch-1 path. The cache must be on `device`."""
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device

    def fn(cache: SupportCache, image: torch.Tensor, image_hw) -> Detections:
        return query_path_single(model, _check_cache(cache, dev), image.to(dev), _hw(image_hw, (), dev))

    return fn


def normalize_uint8(images: torch.Tensor, image_hw: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Raw uint8 canvases [B, 3, Hc, Wc] -> normalized f32, with the padding
    beyond image_hw set back to zero (normalize-then-pad, as the reference)."""
    mean = torch.tensor(cfg.input.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.input.pixel_std, dtype=torch.float32, device=images.device)
    x = (images.float() - mean[:, None, None]) / std[:, None, None]
    hc, wc = x.shape[-2:]
    row_ok = torch.arange(hc, device=x.device)[None, :] < image_hw[:, 0, None]
    col_ok = torch.arange(wc, device=x.device)[None, :] < image_hw[:, 1, None]
    return x * (row_ok[:, :, None] & col_ok[:, None, :])[:, None]


def build_batched_inference_fn(cfg: Config, params: Mapping[str, torch.Tensor], *,
                               device="cuda") -> Callable[..., Detections]:
    """(cache, images [B, 3, Hc, Wc], image_hw [B, 2]) -> Detections
    [B, K, ...] on `device`: the serving path. Raw uint8 canvases are
    normalized on the device. The cache must be on `device`."""
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device

    def fn(cache: SupportCache, images: torch.Tensor, image_hw) -> Detections:
        cache = _check_cache(cache, dev)
        images = images.to(dev)
        hw = _hw(image_hw, (images.shape[0],), dev)
        if images.dtype == torch.uint8:
            images = normalize_uint8(images, hw, cfg)
        return query_path(model, cache, images, hw)

    return fn


def pack_detections(det: Detections) -> torch.Tensor:
    """Detections -> one [..., K, 7] f32 tensor (x1, y1, x2, y2, score, class, valid)."""
    return torch.cat(
        [
            det.boxes.float(),
            det.scores.float()[..., None],
            det.classes.float()[..., None],
            det.valid.float()[..., None],
        ],
        dim=-1,
    )


def unpack_detections_np(packed) -> dict:
    """Host-side inverse of pack_detections (numpy dict out)."""
    arr = packed.detach().cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    return {
        "boxes": arr[..., :4],
        "scores": arr[..., 4],
        "classes": arr[..., 5].astype(np.int32),
        "valid": arr[..., 6] > 0.5,
    }
