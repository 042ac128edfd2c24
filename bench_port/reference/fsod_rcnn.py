"""The plain reference of the AttentionRPN baseline (FsodRCNN over ResNet-50
C4) serving raw frames: the support maps from the shots, then frames ->
resize, normalize, pad -> ResNet-50 C4 to res4 -> the attention RPN ->
proposals -> 14x14 ROIAlign -> res5 -> the multi-relation head ->
detections in frame coordinates, in float32 PyTorch on whatever device it
is given, with no kernel, no cache and no batching trick: the backbone and
the RPN take a block of frames, the ROI head one image's proposals at a
time.

Written from the paper (Fan, Zhuang, Tang, Tai, "Few-Shot Object Detection
with Attention-RPN and Multi-Relation Detector", CVPR 2020, arXiv:1908.01998)
and the reference repository's configs/fsod/Base-FSOD-C4.yaml,
fewx/modeling/fsod/fsod_rcnn.py (the dense-relation support enhancement, the
polarized channel attention with the 1x1 depthwise correlation), FsodRPN
(the 192-channel StandardRPNHead, find_top_rpn_proposals) and
FsodRes5ROIHeads / FsodFastRCNNOutputLayers (res5 on 14x14 pooled boxes; the
global, local-correlation and patch relations). It imports nothing of the
program under test; its modules carry the program's parameter names, so one
state_dict loads into both (strictly, here). It serves one class, as the
configuration does.

Departures from the reference repository, which the program shares:
  - ROIAlign's adaptive sampling (ROIAlignV2, sampling ratio 0) is capped at
    8 samples a bin (``model.roi_align``);
  - the shot-mean support maps read with their spatial axes swapped (the
    repository's view(1, -1, side, C).transpose(1, 3) of its token list);
  - the channel attention's LayerNorm at epsilon 1e-6 (flax's, which the
    program keeps from the JAX package) where nn.LayerNorm has 1e-5;
  - the frames are resized by the antialiased linear resize of
    ``serving.preprocess`` where detectron2 resizes on the host;
  - ties in a top-k or an NMS order go to the lower index.

`record` keeps, for each block, the K of each NMS call and its valid boxes
a row: "k2_rpn" (the proposals' NMS, [B, min(pre_nms_topk, anchors)]) and
"k2_final" (the detections' NMS, [B, post_nms_topk]), for the yardstick.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .model import ConvNorm, apply_deltas, clip, greedy_nms, roi_align, topk_stable
from .serving import preprocess

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
RPN_BOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
STRIDE = 16
LN_EPS = 1e-6

# ----------------------------------------------------------------- ResNet-50 C4


class Bottleneck(nn.Module):
    """1x1 (the stride, detectron2's MSRA layout) -> 3x3 -> 1x1 with FrozenBN,
    a projection shortcut on a stage's first block, relu after the sum."""

    def __init__(self, cin, mid, cout, stride, shortcut):
        super().__init__()
        if shortcut:
            self.shortcut = ConvNorm(cin, cout, 1, stride, relu=False)
        self.conv1 = ConvNorm(cin, mid, 1, stride)
        self.conv2 = ConvNorm(mid, mid, 3, 1)
        self.conv3 = ConvNorm(mid, cout, 1, 1, relu=False)

    def forward(self, x):
        identity = self.shortcut(x) if hasattr(self, "shortcut") else x
        return torch.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


class Stage(nn.Module):
    def __init__(self, cin, blocks, mid, cout, stride):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"block{i}", Bottleneck(cin if i == 0 else cout, mid, cout, stride if i == 0 else 1, i == 0))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNetC4(nn.Module):
    """Stem 7x7/2 + max pool 3x3/2, then res2 (3 blocks), res3 (4), res4 (6):
    res4 [B, 1024, H/16, W/16]."""

    def __init__(self):
        super().__init__()
        self.stem = ConvNorm(3, 64, 7, 2)
        self.res2 = Stage(64, 3, 64, 256, 1)
        self.res3 = Stage(256, 4, 128, 512, 2)
        self.res4 = Stage(512, 6, 256, 1024, 2)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)
        return self.res4(self.res3(self.res2(x)))


class Res5(nn.Module):
    """The ROI head's res5: 3 blocks, stride 2, 2048 out: [R, 1024, 14, 14] -> [R, 2048, 7, 7]."""

    def __init__(self):
        super().__init__()
        self.res5 = Stage(1024, 3, 512, 2048, 2)

    def forward(self, x):
        return self.res5(x)


# ----------------------------------------------------------------- RPN, support, relations


class RPNHead(nn.Module):
    """StandardRPNHead with the 192-channel hidden conv."""

    def __init__(self, cin=1024, anchors=15, hidden=192):
        super().__init__()
        self.conv = nn.Conv2d(cin, hidden, 3, padding=1)
        self.objectness = nn.Conv2d(hidden, anchors, 1)
        self.deltas = nn.Conv2d(hidden, anchors * 4, 1)

    def forward(self, x):
        t = torch.relu(self.conv(x))
        return self.objectness(t), self.deltas(t)


def positional_encoding(max_len: int, d: int, device) -> torch.Tensor:
    """The sinusoidal table [max_len, d], in float32."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros(max_len, d, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class DenseRelation(nn.Module):
    """Each shot's tokens plus the positional encoding, plus half the leaky
    relu of their softmax-weighted sum."""

    def __init__(self, d):
        super().__init__()
        self.channel_k = nn.Linear(d, 1)

    def forward(self, tokens):  # [S, L, C]
        x = tokens + positional_encoding(tokens.shape[1], tokens.shape[2], tokens.device)[None]
        w = torch.softmax(self.channel_k(x), dim=1)
        return x + 0.5 * F.leaky_relu((w * x).sum(1, keepdim=True), 0.01)


class ChannelAttention(nn.Module):
    """The polarized channel attention of the query's 14x14 pool, queried by
    the support map: sigmoid(LN(Wz(sum over positions of Wv(query) x
    softmax(Wq(support)))))."""

    def __init__(self, c=1024):
        super().__init__()
        self.ch_wv = nn.Linear(c, c // 2)
        self.ch_wq = nn.Linear(c, 1)
        self.ch_wz = nn.Linear(c // 2, c)
        self.ln = nn.Module()
        self.ln.scale = nn.Parameter(torch.ones(c))
        self.ln.bias = nn.Parameter(torch.zeros(c))

    def forward(self, query, support):  # [B, 196, C], [196, C] -> [B, C]
        wq = torch.softmax(self.ch_wq(support), dim=0)  # [196, 1]
        wz = (self.ch_wv(query) * wq[None]).sum(1)  # [B, C/2]
        return torch.sigmoid(F.layer_norm(self.ch_wz(wz), self.ln.scale.shape, self.ln.scale, self.ln.bias, LN_EPS))


class RelationHead(nn.Module):
    """FsodFastRCNNOutputLayers: global relation (both maps through the
    shared 1x1 and relu, concatenated, averaged, a linear), local relation
    (the support's 7x7 map as a depthwise kernel over the query's) and patch
    relation (the 49x49 attention of the reduced, centred query tokens on
    the support's, a linear); scores cor / 0.1 + fc + pr, deltas cor / 0.1."""

    def __init__(self, d=2048, reduced=256):
        super().__init__()
        half = d // 2
        self.conv_1 = nn.Linear(d, half, bias=False)
        self.cls_score_fc = nn.Linear(2 * half, 2)
        self.cls_score_cor = nn.Linear(half, 2)
        self.bbox_pred_cor = nn.Linear(half, 4)
        self.adapt_k = nn.Linear(half, reduced)
        self.adapt_q = nn.Linear(half, reduced)
        self.cls_score_pr = nn.Linear(49 * 49, 2)

    def forward(self, query, support):  # [R, 7, 7, 2048], [7, 7, 2048] -> scores [R, 2], deltas [R, 4]
        r = query.shape[0]
        q = torch.relu(self.conv_1(query))
        s = torch.relu(self.conv_1(support))
        half = q.shape[-1]
        fc = self.cls_score_fc(torch.cat([q.mean((1, 2)), s.mean((0, 1)).expand(r, half)], 1))
        cor = torch.relu(F.conv2d(q.permute(0, 3, 1, 2), s.permute(2, 0, 1)[:, None], groups=half))[:, :, 0, 0]
        pe = positional_encoding(49, half, q.device)
        k = self.adapt_k(s.reshape(49, half) + pe)
        qt = self.adapt_q(q.reshape(r, 49, half) + pe)
        k, qt = k - k.mean(0), qt - qt.mean(1, keepdim=True)
        attn = torch.softmax(qt @ k.t() / math.sqrt(k.shape[-1]), dim=-1)
        scores = self.cls_score_cor(cor) / 0.1 + fc + self.cls_score_pr(attn.reshape(r, -1))
        return scores, self.bbox_pred_cor(cor) / 0.1


class RoiPool(nn.Module):
    """14x14 ROIAlignV2 on res4 (a module, so that a FLOP count can tell its
    work apart): [B, C, H, W], boxes [B, K, 4] -> [B, K, 14, 14, C]."""

    def __init__(self, p=14):
        super().__init__()
        self.p = p

    def forward(self, feat, boxes):
        return roi_align(feat, boxes, 1.0 / STRIDE, self.p)


class FsodRCNN(nn.Module):
    """The baseline's modules under the program's parameter names."""

    def __init__(self):
        super().__init__()
        self.backbone = ResNetC4()
        self.rpn_head_mod = RPNHead()
        self.res5 = Res5()
        self.relation_head = RelationHead()
        self.rpn_enhance = DenseRelation(1024)
        self.rcnn_enhance = DenseRelation(2048)
        self.channel_attention = ChannelAttention(1024)
        self.pool = RoiPool()


# ----------------------------------------------------------------- anchors, support, serving


def anchors(feat_hw: Tuple[int, int], device) -> torch.Tensor:
    """detectron2's DefaultAnchorGenerator at offset 0: [H*W*A, 4], cells row
    major, a cell's anchors sizes outer and ratios inner."""
    cell = []
    for size in ANCHOR_SIZES:
        for ratio in ANCHOR_RATIOS:
            w = math.sqrt(size * size / ratio)
            h = ratio * w
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell = torch.tensor(cell, dtype=torch.float32, device=device)
    sy, sx = torch.meshgrid(torch.arange(feat_hw[0], dtype=torch.float32, device=device) * STRIDE,
                            torch.arange(feat_hw[1], dtype=torch.float32, device=device) * STRIDE, indexing="ij")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1)] * 2, 1)
    return (shifts[:, None, :] + cell[None]).reshape(-1, 4)


class Support(NamedTuple):
    rpn: torch.Tensor  # [14, 14, 1024] shot-mean enhanced pooled res4, spatially swapped
    rcnn: torch.Tensor  # [7, 7, 2048] shot-mean enhanced res5, spatially swapped


@torch.no_grad()
def support(net: FsodRCNN, shots: torch.Tensor, boxes: torch.Tensor) -> Support:
    """shots [S, 3, Hs, Ws] normalized crops on their canvas, boxes [S, 4]."""
    res4 = net.backbone(shots)
    pooled = roi_align(res4, boxes[:, None, :].float(), 1.0 / STRIDE, 14)[:, 0]  # [S, 14, 14, 1024]
    res5 = net.res5(pooled.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # [S, 7, 7, 2048]
    s = shots.shape[0]
    rpn = net.rpn_enhance(pooled.reshape(s, 196, -1)).mean(0).reshape(14, 14, -1).transpose(0, 1)
    rcnn = net.rcnn_enhance(res5.reshape(s, 49, -1)).mean(0).reshape(7, 7, -1).transpose(0, 1)
    return Support(rpn, rcnn)


class Reference:
    """The reference baseline of one configuration with the seed's weights
    and support shots: __call__(frames uint8 [B, 3, H, W]) -> (boxes
    [B, D, 4] in frame coordinates, scores [B, D], valid [B, D])."""

    def __init__(self, config: dict, state_dict, shots: torch.Tensor, shot_boxes: torch.Tensor, device):
        self.m, self.input = config["model"], config["input"]
        if self.m["num_classes"] != 1 or self.m["depth"] != 50:
            raise ValueError("the reference serves one class over ResNet-50")
        self.net = FsodRCNN()
        self.net.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True)
        self.net = self.net.to(device).eval()
        self.sup = support(self.net, shots.to(device).float(), shot_boxes.to(device))
        self.record: Dict[str, list] = {}

    def __call__(self, frames: torch.Tensor):
        return self.detect(*preprocess(frames, {"input": self.input}))

    @torch.no_grad()
    def proposals(self, res4: torch.Tensor, resized_hw: Tuple[int, int]):
        """The attention RPN and find_top_rpn_proposals on a block's res4:
        (boxes [B, post, 4], valid [B, post])."""
        m, net = self.m, self.net
        b, c, h, w = res4.shape
        pooled = F.adaptive_avg_pool2d(res4, (14, 14)).permute(0, 2, 3, 1).reshape(b, 196, c)
        weight = net.channel_attention(pooled, self.sup.rpn.reshape(196, c))
        feat = res4 * weight[:, :, None, None] + res4 * self.sup.rpn.mean((0, 1))[None, :, None, None]
        obj, dl = net.rpn_head_mod(feat)
        logits = obj.permute(0, 2, 3, 1).reshape(b, -1)
        deltas = dl.view(b, -1, 4, h, w).permute(0, 3, 4, 1, 2).reshape(b, -1, 4)
        k = min(m["rpn_pre_nms_topk_test"], logits.shape[1])
        top, idx = topk_stable(logits, k)
        anc = anchors((h, w), res4.device)[idx]
        boxes = clip(apply_deltas(torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4)), anc, RPN_BOX_WEIGHTS),
                     resized_hw)
        valid = torch.isfinite(top) & (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
        self.record.setdefault("k2_rpn", []).append((k, valid.sum(1).tolist()))
        keep = greedy_nms(boxes, top, valid, m["rpn_nms_thresh"])
        sel, idx = topk_stable(torch.where(keep, top, torch.full_like(top, -math.inf)),
                               min(m["rpn_post_nms_topk_test"], k))
        return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), torch.isfinite(sel)

    @torch.no_grad()
    def detect(self, images: torch.Tensor, resized_hw: Tuple[int, int], scale: Tuple[float, float]):
        """The detector on canvases that ``serving.preprocess`` made of the frames."""
        m, net = self.m, self.net
        (sy, sx) = scale
        res4 = net.backbone(images)
        props, pvalid = self.proposals(res4, resized_hw)
        boxes, scores = [], []
        for i in range(images.shape[0]):  # the ROI head, one image's proposals at a time
            pooled = net.pool(res4[i:i + 1], props[i:i + 1])[0]  # [R, 14, 14, 1024]
            feats = net.res5(pooled.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # [R, 7, 7, 2048]
            logits, deltas = net.relation_head(feats, self.sup.rcnn)
            scores.append(torch.softmax(logits, -1)[:, 0])
            boxes.append(clip(apply_deltas(deltas, props[i], m["bbox_reg_weights"]), resized_hw))
        boxes, scores = torch.stack(boxes), torch.stack(scores)
        valid = pvalid & (scores > m["test_score_thresh"]) & torch.isfinite(boxes).all(-1)
        self.record.setdefault("k2_final", []).append((int(scores.shape[1]), valid.sum(1).tolist()))
        keep = greedy_nms(boxes, scores, valid, m["test_nms_thresh"])
        top, idx = topk_stable(torch.where(keep, scores, torch.full_like(scores, -1.0)),
                               min(m["detections_per_image"], scores.shape[1]))
        out = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        out = out * torch.tensor([sx, sy, sx, sy], device=out.device)
        return out, top.clamp(min=0.0), top > 0.0
