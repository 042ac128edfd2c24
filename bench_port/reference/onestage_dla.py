"""The plain reference of CenterNet-S4 over DLA-34-DCN: DLA-34 (BatchNorm by
its running statistics), the DLA-Up decoder and the final IDA-Up, whose
projection and node blocks are modulated deformable convolutions (DCNv2),
the class-aware CenterNet head on the one stride-4 map, and its decode, in
float32 PyTorch with no kernel, no cache and no batching trick.

Written from the published model: "Objects as Points" (arXiv:1904.07850,
its DLA-34 with deformable up-convolutions), CenterNet2's one-stage
``CenterNet-S4_DLA_8x`` (arXiv:2103.07461: ``build_dla_backbone``,
``DLA.NORM BN``, ``IN_FEATURES ["dla2"]``, ``FPN_STRIDES [4]``, one class
conv and one box conv, COCO's 80 classes), and the reference repository's
vendored ``modeling/backbone/dla.py`` (``DLASeg``, ``DLAUp``, ``IDAUp``,
``DeformConv``). It imports nothing of the program. Its modules carry the
program's parameter names, so one state_dict loads into both (strictly,
here). The trunk, BatchNorm, GroupNorm, Scale, the stable top-k and the
resize to the canvas are those of ``model.py`` and ``serving.py``.

The modulated deformable convolution follows the CUDA im2col of DCNv2
(``modulated_deformable_im2col``), one tap at a time: output pixel p of
tap k samples the input at p - pad + k's place + (dy_k, dx_k), the
offsets tap-major (dy, dx) pairs; a sample with its coordinate outside
(-1, H) x (-1, W) is 0; inside, each of its four corners counts only where
it lies on the map; the bilinear value is scaled by sigmoid of the tap's
mask logit and contracted with the tap's weights.

Departures from the published model, which the program shares:
- The upsampling inside IDA-Up is a fixed half-pixel bilinear resize by 2
  (4x is two of them), edge rows repeated. The source's upsampler is a
  depthwise ConvTranspose2d (kernel 2f, stride f) initialized to bilinear
  weights and trained; the fixed resize equals it in the interior at 2x,
  and differs at the border rows and columns (zero beyond the edge there)
  and, at 4x, everywhere by the composition of two linear steps.
- BatchNorm runs by its running statistics with eps 1e-5 (a served model).
- The decode keeps detectron2-CenterNet2's steps (the per-level top-k over
  (location, class) pairs, the class-aware NMS, the k-th value trim, the
  final top-k) with the repository's score threshold 1e-5, and scales the
  boxes back to the frame without clipping them to it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import model as M
from .serving import preprocess

TAPS = 9  # 3x3
DCN_OFFSET_CHANNELS = 27  # 18 offsets (dy, dx a tap), then 9 mask logits


# ----------------------------------------------------------------- the modulated deformable convolution

def _sample(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of x [B, C, H, W] at py, px [B, Ho, Wo] (float32) ->
    [B, C, Ho, Wo], by the CUDA im2col's rules."""
    b, c, h, w = x.shape
    flat = x.reshape(b, c, h * w)
    inside = (py > -1) & (px > -1) & (py < h) & (px < w)
    y_lo, x_lo = torch.floor(py), torch.floor(px)
    ly, lx = py - y_lo, px - x_lo
    out = torch.zeros((b, c) + tuple(py.shape[1:]), dtype=x.dtype, device=x.device)
    for yy, wy in ((y_lo, 1 - ly), (y_lo + 1, ly)):
        for xx, wx in ((x_lo, 1 - lx), (x_lo + 1, lx)):
            on_map = inside & (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            where = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long().reshape(b, 1, -1)
            v = torch.gather(flat, 2, where.expand(b, c, -1)).reshape(out.shape)
            out = out + v * (wy * wx * on_map.to(wy.dtype))[:, None].to(x.dtype)
    return out


def modulated_deform_conv(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, record: List[tuple]) -> torch.Tensor:
    """x [B, Cin, H, W], offsets [B, 18, H, W], mask [B, 9, H, W] (after the
    sigmoid), weight [Cout, Cin, 3, 3] -> [B, Cout, H, W] (stride 1, padding
    1). `record` receives the call's shapes (B, Cin, H, W, Cout, Ho, Wo)."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    record.append((b, cin, h, w, cout, h, w))
    grid_y = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) - 1.0
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) - 1.0
    out = 0
    for k in range(TAPS):
        ky, kx = divmod(k, 3)
        py = grid_y + ky + offsets[:, 2 * k].float()
        px = grid_x + kx + offsets[:, 2 * k + 1].float()
        col = _sample(x, py, px) * mask[:, k:k + 1]
        out = out + torch.einsum("bchw,oc->bohw", col, weight[:, :, ky, kx].to(col.dtype))
    return out


class DeformBlock(nn.Module):
    """DeformConv of the source: the 3x3 offset conv (with bias), the
    modulated deformable 3x3 conv (no bias), BatchNorm, relu."""

    def __init__(self, cin: int, cout: int, record: List[tuple]):
        super().__init__()
        self.offset = nn.Conv2d(cin, DCN_OFFSET_CHANNELS, 3, padding=1)
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bn = M.BatchNorm(cout)
        self.record = record

    def forward(self, x):
        om = self.offset(x)
        y = modulated_deform_conv(x, om[:, :18], torch.sigmoid(om[:, 18:]), self.weight, self.record)
        return torch.relu(self.bn(y))


# ----------------------------------------------------------------- DLA-Up and IDA-Up

def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    while factor > 1:
        x = F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)
        factor //= 2
    return x


class IDAUp(nn.Module):
    """Iterative deep aggregation over layers[startp:endp]: layer i is
    projected to `out` channels, upsampled by its factor and merged with
    layer i - 1 by a node, in place."""

    def __init__(self, out: int, in_channels: Sequence[int], up_f: Sequence[int], record):
        super().__init__()
        self.up_f = list(up_f)
        for i in range(1, len(in_channels)):
            self.add_module(f"proj_{i}", DeformBlock(in_channels[i], out, record))
            self.add_module(f"node_{i}", DeformBlock(out, out, record))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int) -> None:
        for i in range(startp + 1, endp):
            j = i - startp
            layers[i] = upsample(getattr(self, f"proj_{j}")(layers[i]), self.up_f[j])
            layers[i] = getattr(self, f"node_{j}")(layers[i] + layers[i - 1])


class DLAUp(nn.Module):
    """The source's DLAUp over the levels dla2..dla5 (scales 1, 2, 4, 8):
    IDA-Up i merges the deepest levels down into level len - 2 - i."""

    def __init__(self, channels: Sequence[int], record):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = [2 ** i for i in range(len(channels))]
        for i in range(len(channels) - 1):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUp(channels[j], in_channels[j:], [s // scales[j] for s in scales[j:]],
                                              record))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])
        self.n = len(channels)

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n - 1):
            getattr(self, f"ida_{i}")(layers, self.n - i - 2, self.n)
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA-34 (``base``), DLA-Up (``dla_up``) and the final IDA-Up
    (``ida_up``, up factors 1, 2, 4) over the three finest outputs -> the
    64-channel stride-4 map."""

    def __init__(self, num_layers: int, record):
        super().__init__()
        channels = M.DLA_SPECS[num_layers][1]
        self.base = M.DLA(num_layers, ("dla2", "dla3", "dla4", "dla5"))
        self.dla_up = DLAUp(channels[2:], record)
        self.ida_up = IDAUp(channels[2], channels[2:5], [1, 2, 4], record)
        self.out_channels = channels[2]

    def forward(self, x):
        base = self.base(x)
        up = self.dla_up([base[f"dla{i}"] for i in range(2, 6)])
        y = up[:3]
        self.ida_up(y, 0, len(y))
        return y[-1]


# ----------------------------------------------------------------- head and decode

class Head(nn.Module):
    """The class-aware CenterNet head on one level: a class tower and a box
    tower of {3x3 conv, GroupNorm(32), relu}, the class logits, the
    relu'd Scale'd ltrb regression, and the agnostic heatmap if asked."""

    def __init__(self, c: int, cn: dict):
        super().__init__()
        self.cls = [f"cls_tower{j}" for j in range(cn["num_cls_convs"])]
        self.box = [f"bbox_tower{j}" for j in range(cn["num_box_convs"])]
        for name in self.cls + self.box:
            self.add_module(name, nn.Conv2d(c, c, 3, padding=1))
            self.add_module(f"{name}_gn", M.GroupNorm(c, 32))
        self.cls_logits = nn.Conv2d(c, cn["num_classes"], 3, padding=1)
        self.bbox_pred = nn.Conv2d(c, 4, 3, padding=1)
        self.with_agn = cn["with_agn_hm"]
        if self.with_agn:
            self.agn_hm = nn.Conv2d(c, 1, 3, padding=1)
        self.levels = len(cn["in_features"])
        for i in range(self.levels):
            self.add_module(f"scale{i}", M.Scale())

    def tower(self, x, names):
        for name in names:
            x = torch.relu(getattr(self, f"{name}_gn")(getattr(self, name)(x)))
        return x

    def forward(self, feats):
        clss, agns, regs = [], [], []
        for i, x in enumerate(feats):
            bt = self.tower(x, self.box)
            regs.append(torch.relu(getattr(self, f"scale{i}")(self.bbox_pred(bt))))
            agns.append(self.agn_hm(bt) if self.with_agn else None)
            clss.append(self.cls_logits(self.tower(x, self.cls)))
        return clss, agns, regs


class Detector(nn.Module):
    """The one-stage detector's modules under the program's parameter names."""

    def __init__(self, model: dict):
        super().__init__()
        if model["backbone_name"] != "dla_seg":
            raise ValueError(f"backbone {model['backbone_name']!r}: this reference is CenterNet's dla_seg")
        self.record: List[tuple] = []  # the deformable calls' shapes, in order
        self.backbone = DLASeg(model["dla"]["num_layers"], self.record)
        self.head = Head(self.backbone.out_channels, model["centernet"])

    def forward(self, images):
        return self.head([self.backbone(images)])


def class_aware_nms(boxes, scores, classes, valid, thr):
    """Greedy NMS keep mask over [B, K]: in descending score order (ties to
    the lower index) keep a valid box that no kept box of its class overlaps
    by IoU > thr."""
    b, k = scores.shape
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, float("-inf"))), dim=1,
                       descending=True, stable=True).indices
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sc = torch.gather(classes, 1, order)
    over = (M.pairwise_iou(sb, sb) > thr) & (sc[:, :, None] == sc[:, None, :])
    alive = torch.gather(valid, 1, order).clone()
    keep = torch.zeros_like(alive)
    for i in range(k):
        ki = alive[:, i]
        keep[:, i] = ki
        alive &= ~(over[:, i] & ki[:, None])
    return torch.zeros_like(keep).scatter(1, order, keep)


@torch.no_grad()
def decode(clss, agns, regs, cn: dict, image_hw: Tuple[int, int], record: dict):
    """Per level: scores sigmoid(class logits) [x sigmoid(agnostic heatmap)]
    over (location, class) pairs, location-major, inside the image padded to
    32 and above the threshold; the stable top pre_nms_topk_test of them;
    their boxes from the grid point (j s + s // 2, i s + s // 2) and the ltrb
    distances times the stride. Then the class-aware NMS, the trim to the
    post_nms_topk_test-th kept score (ties kept) and the stable top
    post_nms_topk_test -> (boxes, scores, classes, valid) [B, D, ...].
    `record` receives the NMS call's K and valid count a row."""
    b, n = clss[0].shape[0], cn["num_classes"]
    dev = clss[0].device
    h32, w32 = (-(-image_hw[0] // 32) * 32), (-(-image_hw[1] // 32) * 32)
    all_s, all_b, all_c = [], [], []
    for lvl, s in enumerate(cn["fpn_strides"]):
        hl, wl = clss[lvl].shape[-2:]
        p = torch.sigmoid(clss[lvl]).permute(0, 2, 3, 1).reshape(b, hl * wl, n)
        if agns[lvl] is not None:
            p = p * torch.sigmoid(agns[lvl]).reshape(b, hl * wl, 1)
        iy = torch.arange(hl, device=dev)
        ix = torch.arange(wl, device=dev)
        inside = ((iy[:, None] < h32 / s) & (ix[None, :] < w32 / s)).reshape(1, hl * wl, 1)
        flat = torch.where((p > cn["score_thresh"]) & inside, p, torch.full_like(p, -1.0)).reshape(b, -1)
        top, idx = M.topk_stable(flat, min(cn["pre_nms_topk_test"], flat.shape[1]))
        loc, cls = idx // n, idx % n
        gy = (loc // wl).float() * s + s // 2
        gx = (loc % wl).float() * s + s // 2
        ltrb = torch.gather(regs[lvl].permute(0, 2, 3, 1).reshape(b, hl * wl, 4), 1,
                            loc[..., None].expand(-1, -1, 4)) * s
        x1, y1 = gx - ltrb[..., 0], gy - ltrb[..., 1]
        x2 = torch.maximum(gx + ltrb[..., 2], x1 + 0.01)
        y2 = torch.maximum(gy + ltrb[..., 3], y1 + 0.01)
        all_b.append(torch.stack([x1, y1, x2, y2], -1))
        all_s.append(top)
        all_c.append(cls)
    scores, boxes, classes = torch.cat(all_s, 1), torch.cat(all_b, 1), torch.cat(all_c, 1)
    valid = scores > 0.0
    record.setdefault("k2", []).append((int(scores.shape[1]), valid.sum(1).tolist()))
    keep = class_aware_nms(boxes, scores, classes, valid, cn["nms_thresh_test"])
    k = min(cn["post_nms_topk_test"], scores.shape[1])
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    kth = torch.sort(masked, dim=-1, descending=True).values[:, k - 1:k]
    keep = torch.where(keep.sum(1, keepdim=True) > k, keep & (masked >= kth), keep)
    top, idx = M.topk_stable(torch.where(keep, scores, torch.full_like(scores, -1.0)), k)
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), top.clamp(min=0.0),
            torch.gather(classes, 1, idx), top > 0.0)


class Reference:
    """The reference detector of one configuration with the seed's weights:
    __call__(frames uint8 [B, 3, H, W]) -> (boxes [B, D, 4] in frame
    coordinates, scores [B, D], classes [B, D], valid [B, D]). Its `record`
    holds, per call, the NMS call's inputs ("k2") and the deformable calls'
    shapes ("dcn")."""

    def __init__(self, model: dict, state_dict: Dict[str, torch.Tensor], device):
        self.m = model
        self.det = Detector(model)
        self.det.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True)
        self.det = self.det.to(device).eval()
        self.record: dict = {}

    def __call__(self, frames: torch.Tensor):
        return self.detect(*preprocess(frames, self.m))

    @torch.no_grad()
    def detect(self, images: torch.Tensor, resized_hw: Tuple[int, int], scale: Tuple[float, float]):
        """The detector on canvases that ``preprocess`` made of the frames."""
        self.det.record.clear()
        clss, agns, regs = self.det(images)
        self.record.setdefault("dcn", []).append(list(self.det.record))
        boxes, scores, classes, valid = decode(clss, agns, regs, self.m["centernet"], resized_hw, self.record)
        sy, sx = scale
        return boxes * torch.tensor([sx, sy, sx, sy], device=boxes.device), scores, classes, valid
