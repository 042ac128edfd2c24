"""The comparison that decides `correct`: each sampled frame's detections
from the timed path against the reference's detections of the same frame.

Two detections are the same when their boxes overlap by IoU >= MATCH_IOU
and their scores differ by at most MATCH_DSCORE; they are paired greedily,
one to one, by descending IoU. A frame's unmatched share is 1 - pairs / the
larger of the two sides' counts of valid detections, so a missing, extra,
moved or rescored detection counts. The numbers held to the configuration's
limits are the mean share over the sampled frames and the worst frame's.

IoU 0.98 is strict on purpose: rounding in the stated precision moves a
box by well under a pixel, one precision lower by a few pixels (the
readings in PERF.md), and a looser overlap cannot tell the two apart.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

MATCH_IOU = 0.98
MATCH_DSCORE = 0.05
MATCH_PAD = 1e-2  # pixels: the width given to a box clipped to a line when it is matched


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return np.where(inter > 0, inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-12), 0.0)


def unmatched_share(got_boxes, got_scores, got_valid, ref_boxes, ref_scores, ref_valid) -> float:
    """One frame's detections ([D, 4] boxes, [D] scores, [D] valid, numpy)."""
    gb, gs = np.asarray(got_boxes, np.float64)[got_valid], np.asarray(got_scores, np.float64)[got_valid]
    rb, rs = np.asarray(ref_boxes, np.float64)[ref_valid], np.asarray(ref_scores, np.float64)[ref_valid]
    n = max(len(gb), len(rb))
    if n == 0:
        return 0.0
    if not len(gb) or not len(rb):
        return 1.0
    iou = _iou(gb, rb)
    flat = lambda b: (b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])  # noqa: E731
    pad = np.asarray([-MATCH_PAD, -MATCH_PAD, MATCH_PAD, MATCH_PAD])
    iou = np.where(flat(gb)[:, None] | flat(rb)[None, :], _iou(gb + pad, rb + pad), iou)
    ds = np.abs(gs[:, None] - rs[None, :])
    used_g, used_r = set(), set()
    for j, r in zip(*np.unravel_index(np.lexsort((ds.ravel(), -iou.ravel())), iou.shape)):
        if iou[j, r] < MATCH_IOU:
            break
        if ds[j, r] > MATCH_DSCORE or j in used_g or r in used_r:
            continue
        used_g.add(j)
        used_r.add(r)
    return 1.0 - len(used_g) / n


def numbers(shares: List[float]) -> Dict[str, float]:
    """The numbers held to the limits, over the sampled frames' shares."""
    return {"unmatched_mean": float(np.mean(shares)), "unmatched_worst": float(np.max(shares))}


def within(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in limits)
