"""The plain reference of raw-frame serving: the support cache from the shots,
then frames -> resize, normalize, pad -> detector -> detections in frame
coordinates, in float32 on whatever device it is given.

It works out again everything the program derives at set-up: the support
cache, the CGM taps pooled from it, the canvas size, the resized size and
the scale back to the frame. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M


class Support(NamedTuple):
    maps: Dict[str, torch.Tensor]  # level -> shot-mean SM-refined map [S, S, C], spatially transposed
    rcnn_8: torch.Tensor  # shot-mean pooled support box [P, P, C]


def resized_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """ResizeShortestEdge: the shorter side to `short`, the longer capped at `max_size`."""
    scale = short / min(h, w)
    nh, nw = (short, scale * w) if h < w else (scale * h, short)
    if max(nh, nw) > max_size:
        s2 = max_size / max(nh, nw)
        nh, nw = nh * s2, nw * s2
    return int(nh + 0.5), int(nw + 0.5)


def canvas_size(hw: Tuple[int, int], divisibility: int) -> Tuple[int, int]:
    return tuple(-(-x // divisibility) * divisibility for x in hw)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[out, in] weights of an antialiased linear resize on half-pixel
    centres (a triangle widened by in/out when downscaling, rows
    normalized), computed in float32."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(pos[:, None] - np.arange(n_in, dtype=f32)[None, :]) / max(inv, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    tot = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(f32).eps, w / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


def preprocess(frames: torch.Tensor, model: dict) -> Tuple[torch.Tensor, Tuple[int, int], Tuple[float, float]]:
    """uint8 frames [B, 3, H, W] -> (normalized canvases [B, 3, Hc, Wc] f32,
    resized (h, w), scale back to the frame (sy, sx))."""
    inp = model["input"]
    h, w = frames.shape[-2:]
    rh, rw = resized_size(h, w, inp["min_size_test"], inp["max_size_test"])
    ch, cw = canvas_size((rh, rw), inp["size_divisibility"])
    dev = frames.device
    wy = torch.from_numpy(resize_matrix(h, rh)).to(dev)
    wx = torch.from_numpy(resize_matrix(w, rw)).to(dev)
    x = wy @ frames.float() @ wx.t()
    mean = torch.tensor(inp["pixel_mean"], device=dev).view(1, 3, 1, 1)
    std = torch.tensor(inp["pixel_std"], device=dev).view(1, 3, 1, 1)
    x = F.pad((x - mean) / std, (0, cw - rw, 0, ch - rh))
    return x, (rh, rw), (h / rh, w / rw)


@torch.no_grad()
def support(det: M.Detector, shots: torch.Tensor, boxes: torch.Tensor) -> Support:
    """shots [K, 3, Hs, Ws] normalized crops on their canvas, boxes [K, 4]
    (one box a shot) -> the shot-mean support features."""
    feats = det.features(shots)
    maps = {}
    for level, vip in (("p3", det.vip_p3), ("p4", det.vip_p4), ("p5", det.vip_p5)):
        s = M.SM_POOL[level]
        x = F.adaptive_avg_pool2d(feats[level], (s, s)).permute(0, 2, 3, 1)
        maps[level] = vip(x).transpose(1, 2).mean(0)
    pooled = M.multilevel_roi_align([feats[lv] for lv in ("p3", "p4", "p5")], boxes[:, None, :].float(),
                                    det.m["roi"]["pooler_resolution"])
    return Support(maps, pooled[:, 0].mean(0))


def taps(mean_map: torch.Tensor):
    """k1 [C], k13 [3, C], k31 [3, C] pooled from a support map [S0, S1, C]."""
    m = mean_map.permute(2, 0, 1)[None]  # [1, C, S0, S1]
    k1 = F.adaptive_avg_pool2d(m, (1, 1))[0, :, 0, 0]
    k13 = F.adaptive_avg_pool2d(m, (1, 3))[0, :, 0, :].t()
    k31 = F.adaptive_avg_pool2d(m, (3, 1))[0, :, :, 0].t()
    return k1, k13, k31


def grids(canvas_hw, strides, dev):
    out = []
    for s in strides:
        hl, wl = canvas_hw[0] // s, canvas_hw[1] // s
        ys, xs = torch.meshgrid(torch.arange(hl, dtype=torch.float32, device=dev) * s + s // 2,
                                torch.arange(wl, dtype=torch.float32, device=dev) * s + s // 2, indexing="ij")
        out.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], 1))
    return out


@torch.no_grad()
def decode(hms, regs, cn: dict, canvas_hw, image_hw, nms_budget: int, record: dict):
    """CenterNet decode at test: per level sqrt(sigmoid) scores and top-k,
    then the NMS set capped at nms_budget, NMS, the k-th value trim and the
    post-NMS top-k. `record` receives the NMS call's valid count a row."""
    b = hms[0].shape[0]
    dev = hms[0].device
    h32 = -(-image_hw[0] // 32) * 32
    w32 = -(-image_hw[1] // 32) * 32
    sc, bx, vl = [], [], []
    for (hm, reg, g, s) in zip(hms, regs, grids(canvas_hw, cn["fpn_strides"], dev), cn["fpn_strides"]):
        hl, wl = hm.shape[-2:]
        inside = ((torch.arange(hl, device=dev)[:, None] < h32 / s) & (torch.arange(wl, device=dev)[None, :] < w32 / s))
        p = torch.sigmoid(hm.reshape(b, -1))
        r = reg.permute(0, 2, 3, 1).reshape(b, -1, 4) * s
        cand = (p > cn["score_thresh"]) & inside.reshape(1, -1)
        top, idx = M.topk_stable(torch.where(cand, p, torch.full_like(p, -1.0)), min(cn["pre_nms_topk_test"], p.shape[1]))
        gi, ri = g[idx], torch.gather(r, 1, idx[..., None].expand(-1, -1, 4))
        x1, y1 = gi[..., 0] - ri[..., 0], gi[..., 1] - ri[..., 1]
        x2 = torch.maximum(gi[..., 0] + ri[..., 2], x1 + 0.01)
        y2 = torch.maximum(gi[..., 1] + ri[..., 3], y1 + 0.01)
        bx.append(torch.stack([x1, y1, x2, y2], -1))
        sc.append(torch.sqrt(top.clamp(min=0.0)))
        vl.append(top > 0.0)
    scores, boxes, valid = torch.cat(sc, 1), torch.cat(bx, 1), torch.cat(vl, 1)
    if scores.shape[1] > nms_budget:
        scores, idx = M.topk_stable(torch.where(valid, scores, torch.full_like(scores, -1.0)), nms_budget)
        boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        valid = scores > 0.0
    record.setdefault("k2_decode", []).append((int(scores.shape[1]), valid.sum(1).tolist()))
    keep = M.greedy_nms(boxes, scores, valid, cn["nms_thresh_test"])
    k = min(cn["post_nms_topk_test"], scores.shape[1])
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    kth = torch.sort(masked, dim=-1, descending=True).values[:, k - 1:k]
    keep = torch.where(keep.sum(1, keepdim=True) > k, keep & (masked >= kth), keep)
    top, idx = M.topk_stable(torch.where(keep, scores, torch.full_like(scores, -1.0)), k)
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), top.clamp(min=0.0), top > 0.0


class Reference:
    """The reference detector of one configuration with the seed's weights
    and support shots: __call__(frames uint8 [B, 3, H, W]) -> (boxes
    [B, D, 4] in frame coordinates, scores [B, D], valid [B, D])."""

    def __init__(self, model: dict, state_dict, shots: torch.Tensor, shot_boxes: torch.Tensor, device):
        self.m = model
        self.det = M.Detector(model)
        self.det.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True)
        self.det = self.det.to(device).eval()
        self.sup = support(self.det, shots.to(device).float(), shot_boxes.to(device))
        self.taps = {lv: taps(self.sup.maps[lv]) for lv in ("p3", "p4", "p5")}
        self.record: dict = {}

    def __call__(self, frames: torch.Tensor):
        return self.detect(*preprocess(frames, self.m))

    @torch.no_grad()
    def detect(self, images: torch.Tensor, resized_hw: Tuple[int, int], scale: Tuple[float, float]):
        """The detector on canvases that ``preprocess`` made of the frames."""
        m, det = self.m, self.det
        (rh, rw), (sy, sx) = resized_hw, scale
        canvas_hw = tuple(images.shape[-2:])
        feats = det.features(images)
        w3, b3 = det.cgm_conv3.weight, det.cgm_conv3.bias
        corr = []
        for lv in ("p3", "p4", "p5"):
            q = feats[lv].permute(0, 2, 3, 1)
            fused = torch.relu(torch.cat([M.cgm(q, *self.taps[lv]), q], -1) @ w3.t() + b3)
            self.record.setdefault("k1", []).append(tuple(q.shape))
            corr.append(fused.permute(0, 3, 1, 2))
        hms, regs = det.head(corr)
        boxes, pscores, pvalid = decode(hms, regs, m["centernet"], canvas_hw, (rh, rw),
                                        m["static"]["nms_budget_test"], self.record)
        levels = [feats[lv] for lv in ("p3", "p4", "p5")]
        roi = m["roi"]
        probs = []
        n_st = len(roi["cascade_ious"])
        for st in range(n_st):
            q8 = det.pool(levels, boxes)
            logits, deltas = det.roi(q8, self.sup.rcnn_8, st)
            probs.append(torch.softmax(logits, -1))
            boxes = M.apply_deltas(deltas, boxes, roi["cascade_bbox_reg_weights"][st])
            if st + 1 < n_st:
                boxes = M.clip(boxes, (rh, rw))
        s = (sum(probs) / n_st)[..., 0]
        boxes = M.clip(boxes, (rh, rw))
        valid = pvalid & (s > roi["score_thresh_test"]) & torch.isfinite(s) & torch.isfinite(boxes).all(-1)
        self.record.setdefault("k2_roi", []).append((int(s.shape[1]), valid.sum(1).tolist()))
        keep = M.greedy_nms(boxes, s, valid, roi["nms_thresh_test"])
        top, idx = M.topk_stable(torch.where(keep, s, torch.full_like(s, -1.0)),
                                 min(roi["detections_per_image"], s.shape[1]))
        out = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        out = out * torch.tensor([sx, sy, sx, sy], device=out.device)
        return out, top.clamp(min=0.0), top > 0.0
