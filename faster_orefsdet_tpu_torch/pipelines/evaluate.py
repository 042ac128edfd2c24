"""End-to-end evaluation: support cache -> per-image inference -> COCO AP
(counterpart of ``faster_orefsdet_tpu/pipelines/evaluate.py``).

The reference protocol: build the support cache from the K-shot support
set, run batch-1 inference over the val split, and report the COCO AP table
with the per-image latency. `evaluate` can also batch B images per request
(uint8 canvases normalized on the device, the tail batch padded); the query
path treats each image alone, so both give the same table. Requests go
through the pinned function (``build_pinned_inference_fn``): on the card
every eval canvas has one shape, so the first request captures a CUDA graph
and the rest replay it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.coco import ImageRecord, SupportEntry
from ..data.loader import Imread, cv2_imread, eval_canvas, eval_loader
from ..evaluation import COCOEvaluator
from .inference import build_pinned_inference_fn
from .preprocess import ceil_to, normalize, pad_to_canvas, resize_image_host
from .support_cache import SupportCache, build_support_cache


def encode_support_set(cfg: Config, params: Mapping[str, torch.Tensor], entries: Sequence[SupportEntry],
                       shot: Optional[int] = None, *, imread: Optional[Imread] = None,
                       device="cuda") -> SupportCache:
    """The support cache of the first `shot` entries (default
    cfg.fs.support_shot) of one class, on `device`. Each crop is read with
    `imread`, resized to the crop size if it is not, normalized and padded."""
    imread = imread or cv2_imread
    shot = shot or cfg.fs.support_shot
    cs = cfg.fs.support_crop_size
    canvas = (ceil_to(cs), ceil_to(cs))
    imgs, boxes = [], []
    for e in entries[:shot]:
        crop = imread(e.file_path)
        if crop is None:
            raise FileNotFoundError(f"support crop {e.file_path} could not be read")
        if crop.shape[:2] != (cs, cs):
            crop = resize_image_host(crop, cs, cs)
        imgs.append(pad_to_canvas(normalize(crop, cfg.input.pixel_mean, cfg.input.pixel_std), canvas))
        boxes.append(e.support_box)
    images = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2)
    return build_support_cache(cfg, params, images, torch.tensor(boxes, dtype=torch.float32), device=device)


def add_image(evaluator: COCOEvaluator, rec: ImageRecord, boxes: np.ndarray, scores: np.ndarray, valid: np.ndarray,
              scale: Tuple[float, float]) -> None:
    """Feed one image's detections (canvas coordinates, scaled back to the
    record's by scale = (sy, sx)) and its ground truth to the evaluator."""
    sy, sx = scale
    evaluator.process(rec.image_id, boxes[valid] * np.asarray([sx, sy, sx, sy]), scores[valid])
    gt_boxes = np.asarray([a.bbox for a in rec.annotations], float).reshape(-1, 4)
    iscrowd = np.asarray([a.iscrowd for a in rec.annotations], bool)
    evaluator.add_ground_truth(rec.image_id, gt_boxes, iscrowd)


def evaluate(cfg: Config, params: Mapping[str, torch.Tensor], cache: SupportCache,
             records: Sequence[ImageRecord], canvas_hw: Optional[Tuple[int, int]] = None,
             batch_size: int = 1, *, imread: Optional[Imread] = None, device="cuda",
             act_scales: Optional[Mapping[str, float]] = None) -> Dict[str, float]:
    """Run the eval loop on `device` (the cache must be there) -> the AP
    table plus latency_p50_s, latency_mean_s and fps per image. The first
    request is left out of the timing (it builds the kernels and, on the
    card, captures the request's graph); a batch's time is divided by
    batch_size, padding included. Times are the host's clock around a
    request and the read-back of its detections.

    act_scales: calibrated static int8 activation scales
    (``pipelines.quant_calib``). Without them under int8_static or
    int8_resident, they are calibrated on the first <= 8 eval canvases."""
    canvas_hw = canvas_hw or eval_canvas(records, cfg)
    if act_scales is None and cfg.quantize in ("int8_static", "int8_resident"):
        from .quant_calib import calibrate_act_scales

        calib = [canvas for _, canvas, _, _ in eval_loader(records[:min(8, len(records))], cfg, canvas_hw,
                                                          imread=imread)]
        t0 = time.perf_counter()
        act_scales = calibrate_act_scales(cfg, params, torch.stack(calib) if calib else torch.zeros(0),
                                          device=device)
        print(f"auto-calibrated {len(act_scales)} activation scales ({len(calib)} eval images) in "
              f"{time.perf_counter() - t0:.2f}s")
    evaluator = COCOEvaluator()
    times: List[float] = []

    def timed(request):
        t0 = time.perf_counter()
        det = request()
        out = [getattr(det, f).cpu().numpy() for f in ("boxes", "scores", "valid")]
        return out, time.perf_counter() - t0

    infer = build_pinned_inference_fn(cfg, params, cache, device=device, act_scales=act_scales)
    if batch_size > 1:
        def flush(buf):
            pad = batch_size - len(buf)  # the tail batch repeats its first image
            canvases = torch.stack([b[1] for b in buf] + [buf[0][1]] * pad)
            hws = torch.tensor([list(b[2]) for b in buf] + [list(buf[0][2])] * pad, dtype=torch.float32)
            (boxes, scores, valid), dt = timed(lambda: infer(canvases, hws))
            times.append(dt / batch_size)
            for j, (rec, _, _, scale) in enumerate(buf):
                add_image(evaluator, rec, boxes[j], scores[j], valid[j], scale)

        buf: List = []
        for item in eval_loader(records, cfg, canvas_hw, raw_uint8=True, imread=imread):
            buf.append(item)
            if len(buf) == batch_size:
                flush(buf)
                buf = []
        if buf:
            flush(buf)
    else:
        for rec, canvas, hw, scale in eval_loader(records, cfg, canvas_hw, imread=imread):
            (boxes, scores, valid), dt = timed(lambda: infer(canvas, hw))
            times.append(dt)
            add_image(evaluator, rec, boxes, scores, valid, scale)

    results = evaluator.evaluate()
    times = times[1:]
    if times:
        results["latency_p50_s"] = float(np.percentile(times, 50))
        results["latency_mean_s"] = float(np.mean(times))
        results["fps"] = 1.0 / results["latency_mean_s"]
    return results
