"""The query path from normalized canvases to detections (counterpart of
``faster_orefsdet_tpu/pipelines/inference.py``).

backbone -> CGM correlation against the support cache (CGM kernel) ->
CenterNet decode with NMS (NMS kernel) -> cascade ROI -> final NMS (NMS
kernel) -> top-k. The batch dimension runs through every stage, kernels
included: one launch per level or per NMS site serves the whole batch. Each
stage is a named profiler range (``torch.profiler.record_function``), which
the profile phase of ``chip_smoke.py`` reads.

The query path copies nothing from the host and never waits for the device
on CUDA: its constants (grids, pooling matrices, pixel statistics, image
sizes given as tuples) are memoised on their device. So the pinned builder
can capture it into a CUDA graph.

The builders construct the detector from `cfg` themselves, so a model can
never run under a config it was not built for. Under a quantized config
they take ``act_scales=`` (``pipelines.quant_calib``), which every request
reads inside ``ops.quant.static_act_scales``; int8_static and int8_resident
require them. They lay the images out
contiguously on the device (a canvas from ``preprocess_host`` is a
permuted view), so that a request computes the same whatever the strides of
the caller's tensor: in bf16, cuDNN picks its convolution by the strides,
and the pinned function's static buffers are contiguous.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..config import Config
from ..models.cascade_roi import roi_inference
from ..models.centernet import decode_proposals, stable_topk
from ..models.detector import CenterNet2Detector, Kernels, support_kernels
from ..ops import nms_cuda
from ..ops.quant import static_act_scales
from ..structures.boxes import apply_deltas, clip_boxes
from ..structures.instances import Detections
from ..utils.device import device_constant, resolve_device
from .graphs import PinnedFn
from .preprocess import ceil_to, pixel_stats, preprocess_device, resize_shortest_edge_size
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


def _freeze_scales(cfg: Config, act_scales: Optional[Mapping[str, float]]) -> Optional[Dict[str, float]]:
    """A copy of the calibrated scales, checked against cfg.quantize: the
    static presets refuse to run without them."""
    if cfg.quantize in ("int8_static", "int8_resident") and not act_scales:
        raise ValueError(f"quantize={cfg.quantize!r} needs calibrated activation scales: pass "
                         "act_scales=pipelines.quant_calib.calibrate_act_scales(...)")
    if act_scales is None:
        return None
    return {str(k): float(v) for k, v in act_scales.items()}


def cache_kernels(model: CenterNet2Detector, cache: SupportCache) -> Dict[str, Kernels]:
    """The CGM kernels of a cache, per level: one set for a single-class
    cache, one a class (k1 [N, C], k13 and k31 [N, 3, C]) for a stacked one."""
    return {level: support_kernels(getattr(cache, level)) for level in model.levels}


@torch.inference_mode()
def query_path(model: CenterNet2Detector, cache: SupportCache, images: torch.Tensor,
               image_hw: torch.Tensor, kernels: Optional[Dict[str, Kernels]] = None,
               taps: Optional[dict] = None) -> Detections:
    """images [B, 3, Hc, Wc] normalized, padded canvases; image_hw [B, 2] the
    true (h, w) before padding -> Detections [B, K, ...] in resized-image
    coordinates. `kernels`, when given, are ``cache_kernels(model, cache)``
    computed once by the caller (the pinned path). `taps`, when given,
    receives the proposal stage's per-level heatmap logits ("heatmaps") and
    decoded proposals ("proposals"), as the demo's --debug draws them."""
    cfg = model.cfg
    canvas_hw = (images.shape[-2], images.shape[-1])
    with record_function("features"):
        feats = model.features(images)
    with record_function("correlate"):
        pos_feats = model.correlate(feats, cache_kernels(model, cache) if kernels is None else kernels)
    with record_function("proposal_head"):
        agn_hms, bbox_regs = model.proposal_head(pos_feats)
    with record_function("decode_proposals"):
        proposals = decode_proposals(
            agn_hms, bbox_regs, cfg.centernet, canvas_hw, image_hw,
            nms_budget=cfg.static.nms_budget_test,
        )
    if taps is not None:
        taps.update(heatmaps=agn_hms, proposals=proposals)
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
                      image_hw: torch.Tensor, taps: Optional[dict] = None) -> Detections:
    """One canvas [3, Hc, Wc] and its image_hw [2] -> Detections [K, ...]
    (`taps` as in ``query_path``, batch 1)."""
    det = query_path(model, cache, image[None], image_hw[None], taps=taps)
    return Detections(*(t[0] for t in det))


@torch.inference_mode()
def query_path_multiclass(model: CenterNet2Detector, mcache: SupportCache, images: torch.Tensor,
                          image_hw: torch.Tensor, kernels: Optional[Dict[str, Kernels]] = None) -> Detections:
    """The multiclass query path over a stacked cache (``stack_support_caches``,
    N classes): the backbone once, then the CGM correlation of every class
    (one CGM launch a level, over the classes' stacked taps), and the head,
    decode and cascade batched over (class, image) rows; the NMS across
    classes at the end. images [B, 3, Hc, Wc], image_hw [B, 2] ->
    Detections [B, detections_per_image, ...] with class ids in 0..N-1.
    `kernels`, when given, are ``cache_kernels(model, mcache)`` computed once
    by the caller (the pinned path).

    The JAX package's multiclass semantics, where they differ from
    `query_path`: scores are the mean softmax (no mult_proposal_score);
    boxes are clipped only after the last stage; there is no per-class ROI
    NMS; top-k ties go to the lower (class-major) index."""
    cfg = model.cfg
    n_cls, b = mcache.p3.shape[0], images.shape[0]
    canvas_hw = (images.shape[-2], images.shape[-1])
    rows_hw = image_hw.repeat(n_cls, 1)  # row c*B + i: class c, image i
    with record_function("features"):
        feats = model.features(images)
    with record_function("correlate"):
        pos_feats = model.correlate(feats, cache_kernels(model, mcache) if kernels is None else kernels,
                                    per_class=True)
    with record_function("proposal_head"):
        agn_hms, bbox_regs = model.proposal_head(pos_feats)
    with record_function("decode_proposals"):
        proposals = decode_proposals(
            agn_hms, bbox_regs, cfg.centernet, canvas_hw, rows_hw,
            nms_budget=cfg.static.nms_budget_test,
        )
    feat_list = [feats[level].repeat(n_cls, 1, 1, 1) for level in ("p3", "p4", "p5")]
    support_8 = mcache.rcnn_8.repeat_interleave(b, dim=0)
    support_4 = mcache.rcnn_4.repeat_interleave(b, dim=0)
    boxes = proposals.boxes
    stage_outputs = []
    with record_function("roi_stage"):
        for stage in range(len(cfg.roi.cascade_ious)):
            out = model.roi_stage(feat_list, boxes, support_8, support_4, stage)
            stage_outputs.append(out)
            boxes = apply_deltas(out.deltas, boxes, cfg.roi.cascade_bbox_reg_weights[stage])
    with record_function("roi_inference"):
        probs = sum(torch.softmax(o.scores, dim=-1) for o in stage_outputs) / len(stage_outputs)
        boxes = clip_boxes(boxes, rows_hw)
        k = boxes.shape[1]

        def per_image(x):  # [N*B, K, ...] -> [B, N*K, ...], class-major within an image
            x = x.reshape(n_cls, b, *x.shape[1:]).transpose(0, 1)
            return x.reshape(b, n_cls * k, *x.shape[3:])

        boxes, scores, valid = per_image(boxes), per_image(probs[..., 0]), per_image(proposals.valid)
        classes = torch.arange(n_cls, dtype=torch.int32, device=boxes.device).repeat_interleave(k)
        classes = classes.expand(b, -1)
        finite = torch.isfinite(scores) & torch.isfinite(boxes).all(dim=-1)
        valid = valid & (scores > cfg.roi.score_thresh_test) & finite
        keep = nms_cuda.batched_nms_mask(boxes, scores, classes, valid, cfg.roi.nms_thresh_test)
        topk = min(cfg.roi.detections_per_image, n_cls * k)
        sel_scores, sel_idx = stable_topk(torch.where(keep, scores, torch.full_like(scores, -1.0)), topk)
        return Detections(
            boxes=torch.gather(boxes, 1, sel_idx[..., None].expand(-1, -1, 4)),
            scores=torch.clamp(sel_scores, min=0.0),
            classes=torch.gather(classes, 1, sel_idx),
            valid=sel_scores > 0.0,
        )


@device_constant(maxsize=256)
def _float_constant(values: Tuple) -> np.ndarray:
    # image sizes and scales given as tuples vary with the data, so only the
    # recent ones are kept; none enters a graph (the pinned function copies
    # image_hw into its static buffer before it replays or captures)
    return np.asarray(values, np.float32)


def _hw(image_hw, batch_shape, dev) -> torch.Tensor:
    """image_hw as an f32 tensor on `dev`, broadcast to batch_shape + (2,); a
    pair (h, w) becomes a constant memoised on the device."""
    if isinstance(image_hw, torch.Tensor):
        # from pinned host memory the copy is queued on the stream, no wait
        hw = image_hw.to(device=dev, dtype=torch.float32, non_blocking=True)
    elif len(image_hw) == 2 and np.ndim(image_hw[0]) == 0:
        hw = _float_constant(tuple(float(v) for v in image_hw), device=dev)
    else:
        hw = torch.as_tensor(image_hw, dtype=torch.float32, device=dev)
    return hw.expand(*batch_shape, 2) if hw.dim() == 1 and batch_shape else hw


def _check_cache(cache: SupportCache, dev: torch.device) -> SupportCache:
    """The cache is built or loaded once onto the model's device; a request
    never copies it there."""
    if any(t.device != dev for t in cache):
        raise ValueError(f"support cache on {cache.p3.device}, the model on {dev}: "
                         f"build or load the cache with device={str(dev)!r}")
    return cache


def build_inference_fn(cfg: Config, params: Mapping[str, torch.Tensor], *, device="cuda",
                       act_scales: Optional[Mapping[str, float]] = None) -> Callable[..., Detections]:
    """(cache, image [3, Hc, Wc] normalized, image_hw (h, w), taps=None) ->
    Detections [K, ...] on `device`: the batch-1 path. The cache must be on
    `device`; `taps` as in ``query_path``."""
    scales = _freeze_scales(cfg, act_scales)
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device

    def fn(cache: SupportCache, image: torch.Tensor, image_hw, taps: Optional[dict] = None) -> Detections:
        with static_act_scales(scales):
            return query_path_single(model, _check_cache(cache, dev), image.to(dev).contiguous(),
                                     _hw(image_hw, (), dev), taps=taps)

    return fn


def normalize_uint8(images: torch.Tensor, image_hw: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Raw uint8 canvases [B, 3, Hc, Wc] -> normalized f32, with the padding
    beyond image_hw set back to zero (normalize-then-pad, as the reference)."""
    mean, std = pixel_stats(tuple(cfg.input.pixel_mean), tuple(cfg.input.pixel_std), device=images.device)
    x = (images.float() - mean) / std
    hc, wc = x.shape[-2:]
    row_ok = torch.arange(hc, device=x.device)[None, :] < image_hw[:, 0, None]
    col_ok = torch.arange(wc, device=x.device)[None, :] < image_hw[:, 1, None]
    return x * (row_ok[:, :, None] & col_ok[:, None, :])[:, None]


def build_batched_inference_fn(cfg: Config, params: Mapping[str, torch.Tensor], *, device="cuda",
                               act_scales: Optional[Mapping[str, float]] = None) -> Callable[..., Detections]:
    """(cache, images [B, 3, Hc, Wc], image_hw [B, 2]) -> Detections
    [B, K, ...] on `device`: the serving path. Raw uint8 canvases are
    normalized on the device. The cache must be on `device`."""
    scales = _freeze_scales(cfg, act_scales)
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device

    def fn(cache: SupportCache, images: torch.Tensor, image_hw) -> Detections:
        cache = _check_cache(cache, dev)
        images = images.to(dev).contiguous()
        hw = _hw(image_hw, (images.shape[0],), dev)
        if images.dtype == torch.uint8:
            images = normalize_uint8(images, hw, cfg)
        with static_act_scales(scales):
            return query_path(model, cache, images, hw)

    return fn


def build_serving_fn(cfg: Config, params: Mapping[str, torch.Tensor], input_hw: Tuple[int, int], *,
                     device="cuda", act_scales: Optional[Mapping[str, float]] = None
                     ) -> Tuple[Callable[..., Detections], Tuple[int, int]]:
    """Raw frames to detections in frame coordinates, for a camera of fixed
    size input_hw = (H0, W0): the frames [B, 3, H0, W0] (uint8 or float) are
    resized to the test scale, normalized and padded on the device
    (``preprocess_device``), then go through the query path. The canvas, the
    resized size and the scale back to the frame are fixed at build time.

    Returns (fn, canvas_hw) with fn(cache, frames) -> Detections [B, K, ...]."""
    scales = _freeze_scales(cfg, act_scales)
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device
    h0, w0 = input_hw
    rh, rw = resize_shortest_edge_size(h0, w0, cfg.input.min_size_test, cfg.input.max_size_test)
    d = cfg.input.size_divisibility
    canvas_hw = (ceil_to(rh, d), ceil_to(rw, d))
    scale_hw = (h0 / rh, w0 / rw)

    def fn(cache: SupportCache, frames: torch.Tensor) -> Detections:
        cache = _check_cache(cache, dev)
        if tuple(frames.shape[-2:]) != (h0, w0):
            raise ValueError(f"frames of {tuple(frames.shape[-2:])}: this function serves {h0}x{w0}")
        frames = frames.to(dev)
        canvases = preprocess_device(frames, (rh, rw), canvas_hw, cfg.input.pixel_mean, cfg.input.pixel_std)
        with static_act_scales(scales):
            det = query_path(model, cache, canvases, _hw((rh, rw), (frames.shape[0],), dev))
        return rescale_detections(det, scale_hw)

    return fn, canvas_hw


def rescale_detections(det: Detections, scale_hw) -> Detections:
    """Map resized-frame boxes back to frame coordinates (detector_postprocess:
    x by the width ratio, y by the height ratio); scale_hw = (sy, sx)."""
    sy, sx = scale_hw
    return det._replace(boxes=det.boxes * _float_constant((sx, sy, sx, sy), device=det.boxes.device))


def build_multiclass_inference_fn(cfg: Config, params: Mapping[str, torch.Tensor], *, device="cuda",
                                  act_scales: Optional[Mapping[str, float]] = None) -> Callable[..., Detections]:
    """(mcache, image [3, Hc, Wc] normalized, image_hw (h, w)) -> Detections
    [K, ...] over every class of the stacked cache `mcache` (on `device`)."""
    scales = _freeze_scales(cfg, act_scales)
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device

    def fn(mcache: SupportCache, image: torch.Tensor, image_hw) -> Detections:
        with static_act_scales(scales):
            det = query_path_multiclass(model, _check_cache(mcache, dev), image.to(dev).contiguous()[None],
                                        _hw(image_hw, (1,), dev))
        return Detections(*(t[0] for t in det))

    return fn


Output = Union[Detections, torch.Tensor]


class PinnedImagesFn(PinnedFn):
    """A pinned function of (images, image_hw): fn(image [3, H, W], image_hw
    (h, w)) -> the result for that image, or fn(images [B, 3, H, W],
    image_hw [B, 2] or one pair for all) -> the batch's."""

    def __call__(self, image: torch.Tensor, image_hw) -> Output:
        single = image.dim() == 3
        images = image[None] if single else image
        out = super().__call__(images, _hw(image_hw, (images.shape[0],), self.device))
        if not single:
            return out
        return out[0] if isinstance(out, torch.Tensor) else out._make(t[0] for t in out)


class PinnedInferenceFn(PinnedImagesFn):
    """fn(image, image_hw) -> Detections (or packed [.., K, 7]) with the
    weights and the support cache fixed at build time (see
    ``build_pinned_inference_fn``)."""

    def __init__(self, cfg: Config, params: Mapping[str, torch.Tensor], cache: SupportCache, *,
                 device="cuda", packed: bool = False, act_scales: Optional[Mapping[str, float]] = None):
        self.scales = _freeze_scales(cfg, act_scales)
        self.model = make_detector(cfg, params, device=device)
        dev = next(self.model.parameters()).device
        self.cache = _check_cache(cache, dev)
        with torch.inference_mode():
            self.kernels = cache_kernels(self.model, cache)
        self.packed = packed
        super().__init__(self._run, dev)

    def _run(self, images: torch.Tensor, image_hw: torch.Tensor) -> Output:
        if images.dtype == torch.uint8:
            images = normalize_uint8(images, image_hw, self.model.cfg)
        with static_act_scales(self.scales):
            det = query_path(self.model, self.cache, images, image_hw, kernels=self.kernels)
        return pack_detections(det) if self.packed else det


def build_pinned_inference_fn(cfg: Config, params: Mapping[str, torch.Tensor], cache: SupportCache, *,
                              device="cuda", packed: bool = False,
                              act_scales: Optional[Mapping[str, float]] = None) -> PinnedInferenceFn:
    """fn(image, image_hw) -> Detections with the weights and the support
    cache fixed at build time: the sustained-serving path. image is one
    canvas [3, Hc, Wc] with image_hw (h, w), or a batch [B, 3, Hc, Wc] with
    image_hw [B, 2]; normalized f32, or raw uint8 normalized on the device.
    packed=True returns ``pack_detections`` of the result.

    On CUDA, the first call for a (batch, canvas, dtype) shape warms up and
    captures the whole request into a CUDA graph with static input buffers;
    later calls copy their inputs in and replay it, so a request costs a few
    host operations instead of some 760 launches. Each call returns a fresh
    copy of the outputs, so results held from earlier calls stay intact. A
    capture that fails raises. Rebuild the function after changing the
    weights or the cache. On the CPU it runs the eager path. Static scales
    (act_scales=) are constants of the captured graph, and qconcat's scale
    vectors are kept on the device before the capture."""
    return PinnedInferenceFn(cfg, params, cache, device=device, packed=packed, act_scales=act_scales)


def build_pinned_serving_fn(cfg: Config, params: Mapping[str, torch.Tensor], cache: SupportCache,
                            input_hw: Tuple[int, int], *, device="cuda",
                            act_scales: Optional[Mapping[str, float]] = None) -> Tuple[PinnedFn, Tuple[int, int]]:
    """``build_serving_fn`` with the weights and the support cache fixed at
    build time: raw frames [B, 3, H0, W0] (uint8 or float) of a camera of
    fixed size input_hw -> Detections [B, K, ...] in frame coordinates, the
    resize, normalization, padding, query path and rescale in one CUDA graph
    per (batch, dtype) on the card (``PinnedFn``). Returns (fn, canvas_hw).
    Rebuild the function after changing the weights or the cache. On the
    CPU it runs the eager path."""
    scales = _freeze_scales(cfg, act_scales)
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device
    cache = _check_cache(cache, dev)
    h0, w0 = input_hw
    rh, rw = resize_shortest_edge_size(h0, w0, cfg.input.min_size_test, cfg.input.max_size_test)
    d = cfg.input.size_divisibility
    canvas_hw = (ceil_to(rh, d), ceil_to(rw, d))
    # what the graph reads besides the frames, made here and held by the
    # function: the cache's taps, the resized size, the scale back to the
    # frame (x by the width ratio, y by the height ratio)
    with torch.inference_mode():
        kernels = cache_kernels(model, cache)
    resized_hw = torch.tensor([float(rh), float(rw)], device=dev)
    scale = torch.tensor([w0 / rw, h0 / rh] * 2, dtype=torch.float32, device=dev)
    mean, std = tuple(cfg.input.pixel_mean), tuple(cfg.input.pixel_std)

    @torch.inference_mode()
    def run(frames: torch.Tensor) -> Detections:
        if tuple(frames.shape[-2:]) != (h0, w0):
            raise ValueError(f"frames of {tuple(frames.shape[-2:])}: this function serves {h0}x{w0}")
        canvases = preprocess_device(frames, (rh, rw), canvas_hw, mean, std)
        with static_act_scales(scales):
            det = query_path(model, cache, canvases, resized_hw.expand(frames.shape[0], 2), kernels=kernels)
        return det._replace(boxes=det.boxes * scale)

    return PinnedFn(run, dev), canvas_hw


def build_pinned_multiclass_inference_fn(cfg: Config, params: Mapping[str, torch.Tensor], mcache: SupportCache, *,
                                         device="cuda", act_scales: Optional[Mapping[str, float]] = None
                                         ) -> PinnedImagesFn:
    """``build_multiclass_inference_fn`` with the weights and the stacked
    cache `mcache` fixed at build time (its CGM taps computed once, here):
    fn(image [3, Hc, Wc] normalized, image_hw (h, w)) -> Detections [K, ...]
    over every class, or a batch [B, 3, Hc, Wc] with image_hw [B, 2] ->
    [B, K, ...]; one CUDA graph per (batch, canvas, dtype) on the card
    (``PinnedFn``). Rebuild the function after changing the weights or the
    cache. On the CPU it runs the eager path."""
    scales = _freeze_scales(cfg, act_scales)
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device
    mcache = _check_cache(mcache, dev)
    with torch.inference_mode():
        kernels = cache_kernels(model, mcache)

    def run(images: torch.Tensor, image_hw: torch.Tensor) -> Detections:
        with static_act_scales(scales):
            return query_path_multiclass(model, mcache, images, image_hw, kernels=kernels)

    return PinnedImagesFn(run, dev)


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
