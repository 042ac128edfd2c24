"""COCO-style AP evaluation (counterpart of
``faster_orefsdet_tpu/evaluation/coco_eval.py``).

The COCO detection metric for the single category "ore": AP@[.5:.95],
AP50, AP75, APs/m/l and AR@100, by greedy per-image matching in descending
score order at 10 IoU thresholds, with crowd and area-range ignores, and
101-point interpolated precision.

The per-image matcher runs in C++ (``csrc/cocoeval.cc``, built with the
host's g++ at first use by ``ops._native.host_library``; a failed build
raises). The numpy matcher is its plain twin, bit-identical, and runs only
while ``_NATIVE`` is set to None.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100
_NATIVE = "build"  # the C++ matcher, built at first use; None selects the numpy twin


def _native_matcher():
    """The loaded C++ matcher, or None while ``_NATIVE`` is None."""
    global _NATIVE
    if _NATIVE == "build":
        from ..ops._native import host_library

        _NATIVE = host_library("cocoeval")
    return _NATIVE


@dataclass
class DetResult:
    image_id: int
    boxes: np.ndarray  # [N, 4] xyxy
    scores: np.ndarray  # [N]


@dataclass
class GTImage:
    image_id: int
    boxes: np.ndarray  # [M, 4] xyxy
    iscrowd: np.ndarray  # [M] bool
    areas: np.ndarray  # [M] (annotation 'area' field, used for range binning)


def _iou_matrix(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] IoU; crowd gt uses intersection-over-det-area (COCO semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    da = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    ga = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(iscrowd[None, :], da[:, None], da[:, None] + ga[None, :] - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_image(dt_boxes: np.ndarray, dt_scores: np.ndarray, gt: GTImage,
                    area_rng: Tuple[float, float], max_det: int):
    """Greedy matching for one (image, area range) -> (dt_scores_sorted,
    dt_matched [T, D], dt_ignored [T, D], num_gt)."""
    order = np.argsort(-dt_scores, kind="mergesort")[:max_det]
    dt_boxes = dt_boxes[order]
    dt_scores = dt_scores[order]

    gt_ignore = gt.iscrowd | (gt.areas < area_rng[0]) | (gt.areas > area_rng[1])
    # gt sorted non-ignored first (stable)
    g_order = np.argsort(gt_ignore, kind="mergesort")
    g_boxes = gt.boxes[g_order]
    g_crowd = gt.iscrowd[g_order]
    g_ignore = gt_ignore[g_order]

    t_count = len(IOU_THRS)
    d = len(dt_boxes)
    g = len(g_boxes)
    num_gt = int(np.sum(~g_ignore))
    lib = _native_matcher()
    if lib is not None:
        def f64(a):
            return np.ascontiguousarray(a, np.float64).ctypes.data_as(ctypes.POINTER(ctypes.c_double))

        def u8(a):
            return np.ascontiguousarray(a, np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

        matched = np.zeros((t_count, d), np.uint8)
        ignored = np.zeros((t_count, d), np.uint8)
        lib.evaluate_image(f64(dt_boxes), d, f64(g_boxes), g, u8(g_crowd), u8(g_ignore), f64(IOU_THRS), t_count,
                           float(area_rng[0]), float(area_rng[1]), u8(matched), u8(ignored))
        return dt_scores, matched.astype(bool), ignored.astype(bool), num_gt

    ious = _iou_matrix(dt_boxes, g_boxes, g_crowd)
    dtm = np.zeros((t_count, d), dtype=np.int64)  # 0 = unmatched, else 1 + gt index
    dt_ig = np.zeros((t_count, d), dtype=bool)
    gtm = np.zeros((t_count, g), dtype=bool)

    for ti, thr in enumerate(IOU_THRS):
        for di in range(d):
            best_iou = min(thr, 1 - 1e-10)
            best = -1
            for gi in range(g):
                if gtm[ti, gi] and not g_crowd[gi]:
                    continue
                # gt sorted non-ignored first: with a match in hand, stop at
                # the ignored region
                if best > -1 and not g_ignore[best] and g_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best == -1:
                continue
            dtm[ti, di] = best + 1
            dt_ig[ti, di] = g_ignore[best]
            gtm[ti, best] = True

    # unmatched detections outside the area range are ignored
    da = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (dt_boxes[:, 3] - dt_boxes[:, 1])
    out_of_range = (da < area_rng[0]) | (da > area_rng[1])
    dt_ig |= (dtm == 0) & out_of_range[None, :]
    return dt_scores, dtm > 0, dt_ig, num_gt


def _accumulate(per_image, t_count: int):
    """per_image: list of (scores, matched [T,D], ignored [T,D], num_gt) ->
    (precision [T, R], recall [T], ap [T]), or None without ground truth."""
    total_gt = sum(x[3] for x in per_image)
    if total_gt == 0:
        return None
    scores = np.concatenate([x[0] for x in per_image]) if per_image else np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    matched = np.concatenate([x[1] for x in per_image], axis=1)[:, order]
    ignored = np.concatenate([x[2] for x in per_image], axis=1)[:, order]

    tps = matched & ~ignored
    fps = ~matched & ~ignored
    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)

    precision = np.zeros((t_count, len(REC_THRS)))
    recall = np.zeros(t_count)
    for ti in range(t_count):
        tp = tp_cum[ti]
        fp = fp_cum[ti]
        nd = len(tp)
        rc = tp / total_gt
        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        recall[ti] = rc[-1] if nd else 0.0
        # precision made monotone decreasing (right-to-left max)
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        inds = np.searchsorted(rc, REC_THRS, side="left")
        valid = inds < nd
        precision[ti, valid] = pr[inds[valid]]
    ap = precision.mean(axis=1)
    return precision, recall, ap


def coco_ap(detections: Sequence[DetResult], ground_truth: Sequence[GTImage]) -> Dict[str, float]:
    """Single-category AP summary over the standard COCO metrics (percent;
    NaN where no ground truth falls in a range)."""
    gt_by_img = {g.image_id: g for g in ground_truth}
    per_range_stats = {}
    for name, rng in AREA_RANGES.items():
        per_image = []
        for det in detections:
            g = gt_by_img.get(
                det.image_id,
                GTImage(det.image_id, np.zeros((0, 4)), np.zeros(0, bool), np.zeros(0)),
            )
            per_image.append(_evaluate_image(det.boxes, det.scores, g, rng, MAX_DETS))
        # images with ground truth but no detections
        det_ids = {d.image_id for d in detections}
        for g in ground_truth:
            if g.image_id not in det_ids:
                per_image.append(_evaluate_image(np.zeros((0, 4)), np.zeros(0), g, rng, MAX_DETS))
        per_range_stats[name] = _accumulate(per_image, len(IOU_THRS))

    def ap_of(name, thr=None):
        stats = per_range_stats[name]
        if stats is None:
            return float("nan")
        ap = stats[2]
        if thr is None:
            return float(ap.mean())
        return float(ap[int(np.argmin(np.abs(IOU_THRS - thr)))])

    stats_all = per_range_stats["all"]
    return {
        "AP": ap_of("all") * 100,
        "AP50": ap_of("all", 0.5) * 100,
        "AP75": ap_of("all", 0.75) * 100,
        "APs": ap_of("small") * 100,
        "APm": ap_of("medium") * 100,
        "APl": ap_of("large") * 100,
        "AR@100": float(stats_all[1].mean()) * 100 if stats_all else float("nan"),
    }


class COCOEvaluator:
    """Accumulating evaluator with the reference's process/evaluate API,
    single category "ore"."""

    def __init__(self):
        self._dets: List[DetResult] = []
        self._gts: List[GTImage] = []

    def process(self, image_id: int, boxes: np.ndarray, scores: np.ndarray):
        self._dets.append(DetResult(image_id, np.asarray(boxes), np.asarray(scores)))

    def add_ground_truth(self, image_id: int, boxes: np.ndarray, iscrowd=None, areas=None):
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        if iscrowd is None:
            iscrowd = np.zeros(len(boxes), bool)
        if areas is None:
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        self._gts.append(GTImage(image_id, boxes, np.asarray(iscrowd, bool), np.asarray(areas)))

    def evaluate(self) -> Dict[str, float]:
        return coco_ap(self._dets, self._gts)
