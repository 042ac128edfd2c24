"""The plain reference of the CenterNet2 few-shot ore detector: VoVNet-19-slim-eSE
+ FPN or DLA-34 + BiFPN, the SM block, CGM, the CenterNet proposal head, its
decode and the one-stage DSA cascade, in float32 PyTorch with no kernel, no
cache and no batching trick.

A frozen copy, written from the published model (arXiv 2305.01183 and the
reference repository's configs/fsod/finetune_{vovnet,dla}.yaml): it imports
nothing of the program under test. Its modules carry the program's
parameter names, so one state_dict loads into both (strictly, here).

Departures from the published model, which the program shares: the support
branch's spatial transpose (the reference repository's permute(0, 3, 2, 1)),
the 4x4 support pool that no later layer reads, and ROIAlign's adaptive
sampling capped at 8 samples a bin.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# ----------------------------------------------------------------- layers


class FrozenBatchNorm(nn.Module):
    """y = x * scale + bias per channel."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x):
        return x * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class GroupNorm(nn.Module):
    def __init__(self, features: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.scale, self.bias, eps=1e-5)


class BatchNorm(nn.Module):
    """BatchNorm by its running statistics (a served model), eps 1e-5."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.var + 1e-5) * self.scale
        return (x - self.mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.scale


def hsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class ConvNorm(nn.Module):
    """conv (no bias) + FrozenBN [+ relu]."""

    def __init__(self, cin, cout, k=3, stride=1, relu=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.norm = FrozenBatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.norm(self.conv(x))
        return torch.relu(x) if self.relu else x


# ----------------------------------------------------------------- VoVNet-19-slim-eSE + FPN

# stem, stage conv widths, stage output widths, convs per OSA module
VOVNET_SPECS = {"V-19-slim-eSE": ([64, 64, 128], [64, 80, 96, 112], [112, 256, 384, 512], 3)}


class ESEModule(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1, bias=True)

    def forward(self, x):
        return x * hsigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class OSAModule(nn.Module):
    def __init__(self, cin, stage_ch, concat_ch, layers):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"layer{i}", ConvNorm(cin if i == 0 else stage_ch, stage_ch, 3))
        self.concat = ConvNorm(cin + layers * stage_ch, concat_ch, 1)
        self.ese = ESEModule(concat_ch)

    def forward(self, x):
        outs = [x]
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        return self.ese(self.concat(torch.cat(outs, dim=1)))


class VoVNet(nn.Module):
    def __init__(self, conv_body: str, out_features: Sequence[str]):
        super().__init__()
        stem, conv_chs, out_chs, layers = VOVNET_SPECS[conv_body]
        self.out_features = tuple(out_features)
        self.stem1 = ConvNorm(3, stem[0], 3, 2)
        self.stem2 = ConvNorm(stem[0], stem[1], 3, 1)
        self.stem3 = ConvNorm(stem[1], stem[2], 3, 2)
        cin = stem[2]
        for i in range(4):
            self.add_module(f"stage{i + 2}_block0", OSAModule(cin, conv_chs[i], out_chs[i], layers))
            cin = out_chs[i]
        self.channels = {f"stage{i + 2}": out_chs[i] for i in range(4)}

    def forward(self, x):
        x = self.stem3(self.stem2(self.stem1(x)))
        out = {}
        for i in range(4):
            if i > 0:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            x = getattr(self, f"stage{i + 2}_block0")(x)
            if f"stage{i + 2}" in self.out_features:
                out[f"stage{i + 2}"] = x
        return out


class FPN(nn.Module):
    """1x1 laterals, top-down nearest 2x sum, 3x3 outputs -> p3..p5."""

    def __init__(self, in_channels: Sequence[int], in_features: Sequence[str], c: int):
        super().__init__()
        self.in_features = tuple(in_features)
        self.first = int(self.in_features[0][-1])
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{self.first + i}", nn.Conv2d(cin, c, 1))
            self.add_module(f"output{self.first + i}", nn.Conv2d(c, c, 3, padding=1))

    def forward(self, bottom_up):
        feats = [bottom_up[f] for f in self.in_features]
        lat = [getattr(self, f"lateral{self.first + i}")(f) for i, f in enumerate(feats)]
        res = [None] * len(lat)
        prev = res[-1] = lat[-1]
        for i in range(len(lat) - 2, -1, -1):
            prev = res[i] = lat[i] + up2(prev)
        return {f"p{self.first + i}": getattr(self, f"output{self.first + i}")(r) for i, r in enumerate(res)}


# ----------------------------------------------------------------- DLA-34 + BiFPN

DLA_SPECS = {34: ([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512])}


class ConvBN(nn.Module):
    """conv (no bias) + BatchNorm (running statistics) [+ relu]."""

    def __init__(self, cin, cout, k=3, stride=1, relu=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride)
        self.conv2 = ConvBN(cout, cout, 3, 1, relu=False)

    def forward(self, x, residual=None):
        return torch.relu(self.conv2(self.conv1(x)) + (x if residual is None else residual))


class Root(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBN(cin, cout, 1, 1, relu=False)

    def forward(self, *children):
        return torch.relu(self.conv(torch.cat(children, dim=1)))


class Tree(nn.Module):
    def __init__(self, levels, cin, cout, stride=1, level_root=False, root_dim=0):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        self.levels, self.stride, self.level_root = levels, stride, level_root
        if cin != cout:
            self.project = ConvBN(cin, cout, 1, 1, relu=False)
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout, 1)
            self.root = Root(root_dim, cout)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout)

    def forward(self, x, children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        residual = self.project(bottom) if hasattr(self, "project") else bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            return self.root(self.tree2(x1), x1, *children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    def __init__(self, num_layers: int, out_features: Sequence[str]):
        super().__init__()
        levels, ch = DLA_SPECS[num_layers]
        self.levels, self.out_features = levels, tuple(out_features)
        self.base = ConvBN(3, ch[0], 7, 1)
        for i in range(levels[0]):
            self.add_module(f"level0_{i}", ConvBN(ch[0], ch[0], 3, 1))
        for i in range(levels[1]):
            self.add_module(f"level1_{i}", ConvBN(ch[0] if i == 0 else ch[1], ch[1], 3, 2 if i == 0 else 1))
        cin = ch[1]
        for si in range(2, 6):
            self.add_module(f"level{si}", Tree(levels[si], cin, ch[si], stride=2, level_root=si > 2))
            cin = ch[si]
        self.channels = {f"dla{i}": ch[i] for i in range(2, 6)}

    def forward(self, x):
        x = self.base(x)
        for i in range(self.levels[0]):
            x = getattr(self, f"level0_{i}")(x)
        for i in range(self.levels[1]):
            x = getattr(self, f"level1_{i}")(x)
        out = {}
        for si in range(2, 6):
            x = getattr(self, f"level{si}")(x)
            if f"dla{si}" in self.out_features:
                out[f"dla{si}"] = x
        return out


# (level, input nodes) of the 3-level BiFPN cell's four fusion nodes
BIFPN_NODES = [(1, (1, 2)), (0, (0, 3)), (1, (1, 3, 4)), (2, (2, 5))]


class ConvGN(nn.Module):
    def __init__(self, cin, cout, k, bias):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, k // 2, bias=bias)
        self.gn = GroupNorm(cout, 32)

    def forward(self, x):
        return self.gn(self.conv(x))


def _resample(x, hw):
    h, w = x.shape[-2:]
    if h > hw[0] and w > hw[1]:
        return F.max_pool2d(x, 3, 2, padding=1)
    if h < hw[0] or w < hw[1]:
        return up2(x)
    return x


class SingleBiFPN(nn.Module):
    def __init__(self, c, in_channels):
        super().__init__()
        self.n_in = len(in_channels)
        node_ch = list(in_channels)
        for lvl, offs in BIFPN_NODES:
            for off in offs:
                lname = f"lateral_{off}_f{lvl}"
                if node_ch[off] != c and not hasattr(self, lname):
                    self.add_module(lname, ConvGN(node_ch[off], c, 1, True))
            name = f"f{lvl}_" + "_".join(map(str, offs))
            self.register_parameter(f"weights_{name}", nn.Parameter(torch.ones(len(offs))))
            self.add_module(f"output_{name}", ConvGN(c, c, 3, False))
            node_ch.append(c)

    def forward(self, feats):
        feats = list(feats)
        for lvl, offs in BIFPN_NODES:
            hw = tuple(feats[lvl].shape[-2:])
            ins = []
            for off in offs:
                node = feats[off]
                lname = f"lateral_{off}_f{lvl}"
                if off < self.n_in and hasattr(self, lname):
                    node = getattr(self, lname)(node)
                ins.append(_resample(node, hw))
            name = f"f{lvl}_" + "_".join(map(str, offs))
            w = torch.relu(getattr(self, f"weights_{name}"))
            w = w / (w.sum() + 1e-4)
            fused = sum(wi * xi for wi, xi in zip(w, ins))
            feats.append(getattr(self, f"output_{name}")(fused * torch.sigmoid(fused)))
        return [feats[self.n_in + 1], feats[self.n_in + 2], feats[self.n_in + 3]]


class BiFPN(nn.Module):
    def __init__(self, in_features, in_channels, c, repeats):
        super().__init__()
        self.in_features, self.repeats = tuple(in_features), repeats
        chans = tuple(in_channels)
        for r in range(repeats):
            self.add_module(f"repeat{r}", SingleBiFPN(c, chans))
            chans = (c,) * 3

    def forward(self, bottom_up):
        feats = [bottom_up[f] for f in self.in_features]
        for r in range(self.repeats):
            feats = getattr(self, f"repeat{r}")(feats)
        return {"p3": feats[0], "p4": feats[1], "p5": feats[2]}


# ----------------------------------------------------------------- support branch, CGM, heads

SM_POOL = {"p3": 32, "p4": 16, "p5": 8}
ROI_STRIDES = (8, 16, 32)


class SMBlock(nn.Module):
    """Spatial-shift MLP over a [B, H, W, C] support map (dropout off: served)."""

    def __init__(self, dim, seg):
        super().__init__()
        self.seg = seg
        self.mlp_h = nn.Linear(dim, dim, bias=False)
        self.mlp_w = nn.Linear(dim, dim, bias=False)
        self.reweight_fc1 = nn.Linear(dim, dim // 2)
        self.reweight_fc2 = nn.Linear(dim // 2, dim * 2)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        seg, s = self.seg, c // self.seg
        he = x.reshape(b, h, w, seg, s).permute(0, 3, 2, 1, 4).reshape(b, seg, w, h * s)
        he = self.mlp_h(he).reshape(b, seg, w, h, s).permute(0, 3, 2, 1, 4).reshape(b, h, w, c)
        we = x.reshape(b, h, w, seg, s).permute(0, 3, 1, 2, 4).reshape(b, seg, h, w * s)
        we = self.mlp_w(we).reshape(b, seg, h, w, s).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        a = F.gelu(self.reweight_fc1((he + we).mean(dim=(1, 2))))
        a = torch.softmax(self.reweight_fc2(a).reshape(b, c, 2), dim=-1)
        return self.proj(we * a[..., 0][:, None, None, :] + he * a[..., 1][:, None, None, :])


def cgm(q, k1, k13, k31):
    """CGM before its 1x1 fusion on q [B, H, W, C]: relu(relu(q*k1)*k1) +
    relu(3-tap along H of relu(3-tap along W of q)) + q, zero padded."""
    c2 = torch.relu(torch.relu(q * k1) * k1)
    w = q.shape[2]
    qp = F.pad(q, (0, 0, 1, 1))
    sw = torch.relu(sum(qp[:, :, d:d + w, :] * k13[d] for d in range(3)))
    h = q.shape[1]
    sp = F.pad(sw, (0, 0, 0, 0, 1, 1))
    sh = sum(sp[:, d:d + h, :, :] * k31[d] for d in range(3))
    return c2 + torch.relu(sh) + q


class CenterNetHead(nn.Module):
    """Proposal-only CenterNet head: a GN bbox tower shared over levels, the
    relu'd scaled ltrb output and the agnostic heatmap."""

    def __init__(self, c, levels, box_convs):
        super().__init__()
        self.box = [f"bbox_tower{j}" for j in range(box_convs)]
        for name in self.box:
            self.add_module(name, nn.Conv2d(c, c, 3, padding=1))
            self.add_module(f"{name}_gn", GroupNorm(c, 32))
        self.bbox_pred = nn.Conv2d(c, 4, 3, padding=1)
        self.agn_hm = nn.Conv2d(c, 1, 3, padding=1)
        for i in range(levels):
            self.add_module(f"scale{i}", Scale())

    def forward(self, feats):
        hms, regs = [], []
        for i, x in enumerate(feats):
            for name in self.box:
                x = torch.relu(getattr(self, f"{name}_gn")(getattr(self, name)(x)))
            regs.append(torch.relu(getattr(self, f"scale{i}")(self.bbox_pred(x))))
            hms.append(self.agn_hm(x))
        return hms, regs


class DSAHead(nn.Module):
    """The cascade stage with support-conditioned DSA fusion."""

    def __init__(self, roi: dict, c: int):
        super().__init__()
        p = roi["pooler_resolution"]
        self.dsa_conv1 = nn.Linear(c, c // 2)
        self.dsa_conv2 = nn.Linear(c, c // 2)
        self.dsa_conv3 = nn.Linear(2 * c, c)
        for st in range(len(roi["cascade_ious"])):
            self.add_module(f"stage{st}_fc1", nn.Linear(p * p * c, roi["fc_dim"]))
            self.add_module(f"stage{st}_cls", nn.Linear(roi["fc_dim"], roi["num_classes"] + 1))
            self.add_module(f"stage{st}_bbox", nn.Linear(roi["fc_dim"], 4))

    def forward(self, q8, s8, stage):
        """q8 [B, K, P, P, C] pooled query boxes; s8 [P, P, C] the support pool."""
        s8 = s8.expand(q8.shape)
        attn = self.dsa_conv3(torch.cat([q8, s8], -1)) + torch.cat([self.dsa_conv1(q8), self.dsa_conv2(s8)], -1)
        x = torch.relu(getattr(self, f"stage{stage}_fc1")(attn.reshape(*attn.shape[:2], -1)))
        return getattr(self, f"stage{stage}_cls")(x), getattr(self, f"stage{stage}_bbox")(x)


class Detector(nn.Module):
    """The detector's modules under the program's parameter names."""

    def __init__(self, model: dict):
        super().__init__()
        self.m = model
        c = model["fpn"]["out_channels"]
        if model["backbone_name"] == "dla_bifpn":
            self.backbone = DLA(model["dla"]["num_layers"], model["fpn"]["in_features"])
            ch = self.backbone.channels
            self.fpn = BiFPN(model["fpn"]["in_features"], [ch[f] for f in model["fpn"]["in_features"]], c,
                             model["fpn"]["bifpn_repeats"])
        elif model["backbone_name"] == "vovnet_fpn":
            self.backbone = VoVNet(model["vovnet"]["conv_body"], model["vovnet"]["out_features"])
            ch = self.backbone.channels
            self.fpn = FPN([ch[f] for f in model["fpn"]["in_features"]], model["fpn"]["in_features"], c)
        else:
            raise ValueError(f"backbone {model['backbone_name']!r}: the reference has vovnet_fpn and dla_bifpn")
        self.vip_p3, self.vip_p4, self.vip_p5 = (SMBlock(c, SM_POOL[p]) for p in ("p3", "p4", "p5"))
        self.cgm_conv3 = nn.Linear(2 * c, c)
        cn = model["centernet"]
        self.head = CenterNetHead(c, len(cn["in_features"]), cn["num_box_convs"])
        self.roi = DSAHead(model["roi"], c)
        self.pool = RoiPool(model["roi"])

    def features(self, images):
        return self.fpn(self.backbone(images))


# ----------------------------------------------------------------- box arithmetic, ROIAlign, NMS

def area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def pairwise_iou(a, b):
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(inter > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))


def greedy_nms(boxes, scores, valid, thr):
    """Greedy NMS keep mask over [B, K]: in descending score order (ties to
    the lower index) keep a valid box that no kept box overlaps by IoU > thr."""
    b, k = scores.shape
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -math.inf)), dim=1,
                       descending=True, stable=True).indices
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    over = pairwise_iou(sb, sb) > thr
    alive = torch.gather(valid, 1, order).clone()
    keep = torch.zeros_like(alive)
    for i in range(k):
        ki = alive[:, i]
        keep[:, i] = ki
        alive &= ~(over[:, i] & ki[:, None])
    out = torch.zeros_like(keep)
    return out.scatter(1, order, keep)


def topk_stable(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def roi_align(feat, boxes, scale, p, s_max=8):
    """ROIAlignV2 (aligned, adaptive samples capped at s_max a bin) of
    boxes [B, K, 4] on feat [B, C, H, W] -> [B, K, P, P, C]."""
    _, _, hh, ww = feat.shape
    x1, y1, x2, y2 = (boxes[..., i] * scale - 0.5 for i in range(4))
    w = (x2 - x1).clamp(min=1e-6)
    h = (y2 - y1).clamp(min=1e-6)

    def weights(start, size, n):
        bin_size = (size / p)[..., None, None]
        cnt = torch.clamp(torch.ceil(bin_size), 1.0, float(s_max))
        idx = torch.arange(s_max, dtype=torch.float32, device=feat.device)
        pos = start[..., None, None] + (torch.arange(p, dtype=torch.float32, device=feat.device)[:, None]
                                        + (idx + 0.5) / cnt) * bin_size  # [B, K, P, S]
        wsample = torch.where(idx < cnt, 1.0 / cnt, torch.zeros((), device=feat.device))
        inside = (pos >= -1.0) & (pos <= n)
        pc = pos.clamp(0.0, n - 1.0)
        hat = torch.relu(1.0 - (pc[..., None] - torch.arange(n, dtype=torch.float32, device=feat.device)).abs())
        hat = hat * inside[..., None]
        return (hat * wsample[..., None]).sum(-2)  # [B, K, P, n]

    ay, ax = weights(y1, h, hh), weights(x1, w, ww)
    return torch.einsum("bkph,bchw,bkqw->bkpqc", ay, feat, ax)


def multilevel_roi_align(feats, boxes, p, canonical_box_size=224, canonical_level=4):
    lvl = torch.floor(canonical_level + torch.log2(area(boxes).clamp(min=0.0).sqrt() / canonical_box_size + 1e-8))
    lvl = lvl.clamp(3, 5)
    out = 0
    for i, (f, s) in enumerate(zip(feats, ROI_STRIDES)):
        out = out + roi_align(f, boxes, 1.0 / s, p) * (lvl == 3 + i).float()[..., None, None, None]
    return out


class RoiPool(nn.Module):
    """multilevel_roi_align at the configured pooler (a module, so that a
    FLOP count can tell its work apart)."""

    def __init__(self, roi: dict):
        super().__init__()
        self.p, self.size, self.level = roi["pooler_resolution"], roi["canonical_box_size"], roi["canonical_level"]

    def forward(self, feats, boxes):
        return multilevel_roi_align(feats, boxes, self.p, self.size, self.level)


def apply_deltas(d, boxes, weights, clamp=math.log(1000.0 / 16.0)):
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    pcx = d[..., 0] / wx * w + cx
    pcy = d[..., 1] / wy * h + cy
    pw = torch.exp((d[..., 2] / ww).clamp(max=clamp)) * w
    ph = torch.exp((d[..., 3] / wh).clamp(max=clamp)) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


def clip(boxes, hw):
    h, w = float(hw[0]), float(hw[1])
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], -1)
