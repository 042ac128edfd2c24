"""The AttentionRPN baseline, FsodRCNN over ResNet-50 C4 (counterpart of
``faster_orefsdet_tpu/models/attention_rpn.py``): the anchor RPN with its
192-channel head, the dense-relation support enhancement, the polarized
channel attention, the res5 ROI head and the three-relation predictor.

Layouts: maps that convolutions read or write are NCHW (channels-last in
memory); support tokens, support maps and pooled ROI features are
channel-last, as the JAX package and the support cache keep them:

  features              images [B, 3, H, W] -> res4 [B, 1024, h, w]
  enhance_support_rpn   tokens [S, 196, 1024] -> map [1, 14, 14, 1024]
  enhance_support_rcnn  tokens [S, 49, 2048] -> map [1, 7, 7, 2048]
  rpn_attention         res4 [1, 1024, h, w], map [1, 14, 14, 1024] -> [1, 1024, h, w]
  rpn_head              [1, 1024, h, w] -> logits [h*w*A], deltas [h*w*A, 4]
  res5_transform        pooled ROIs [R, 14, 14, 1024] -> [R, 7, 7, 2048]
  relation              [R, 7, 7, 2048], [1, 7, 7, 2048] -> StagePred

The RPN's outputs are flattened in detectron2's anchor order (cells row
major, the cell's A anchors fastest), the order of ``generate_anchors``.
``rpn_predict_proposals``' NMS is the NMS kernel on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import nms_cuda
from ..ops.adaptive_pool import adaptive_avg_pool2d
from ..ops.losses import smooth_l1_loss
from ..structures.boxes import apply_deltas, clip_boxes, encode_deltas, pairwise_iou
from ..structures.instances import GroundTruth, Proposals
from ..utils.device import device_constant
from .centernet import stable_topk
from .layers import at_least_f32, conv2d
from .resnet import Res5Stage, ResNetC4

RPN_BOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
LN_EPS = 1e-6  # flax's LayerNorm epsilon (torch's default is 1e-5)


# ------------------------------------------------------------------ anchors
def _anchors_np(feat_hw: Tuple[int, int], stride: int, sizes: Tuple[float, ...],
                aspect_ratios: Tuple[float, ...]) -> np.ndarray:
    cell = []
    for s in sizes:  # sizes outer, ratios inner (d2's generate_cell_anchors)
        area = s * s
        for a in aspect_ratios:
            w = math.sqrt(area / a)
            h = a * w
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell = np.asarray(cell, np.float32)  # [A, 4]
    h, w = feat_hw
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32) * stride, np.arange(h, dtype=np.float32) * stride)
    shifts = np.stack([gx.reshape(-1), gy.reshape(-1)] * 2, axis=1)  # [HW, 4]
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)


_anchors_on = device_constant(_anchors_np)


def generate_anchors(feat_hw: Tuple[int, int], stride: int = 16, sizes: Sequence[float] = ANCHOR_SIZES,
                     aspect_ratios: Sequence[float] = ANCHOR_RATIOS, device=None) -> torch.Tensor:
    """d2 DefaultAnchorGenerator (offset 0): [H*W*A, 4] xyxy anchors, cells
    row major, each cell's anchors sizes-major. Kept on `device` (default
    the CPU) for the process's life: do not modify it."""
    return _anchors_on(tuple(feat_hw), int(stride), tuple(sizes), tuple(aspect_ratios), device=device)


# ------------------------------------------------------------------ RPN head
class RPNHead(nn.Module):
    """StandardRPNHead with the 192-channel hidden conv: relu(3x3) -> 1x1
    objectness [A] and 1x1 deltas [4A]."""

    def __init__(self, in_channels: int = 1024, num_anchors: int = 15, hidden: int = 192,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.objectness = nn.Conv2d(hidden, num_anchors, 1)
        self.deltas = nn.Conv2d(hidden, num_anchors * 4, 1)
        self.dtype = dtype

    def forward(self, feat: torch.Tensor):
        t = torch.relu(conv2d(feat, self.conv, self.dtype))
        return conv2d(t, self.objectness), conv2d(t, self.deltas)


def rpn_label_anchors(anchors: torch.Tensor, gt: GroundTruth, generator: Optional[torch.Generator] = None,
                      batch_size: int = 256, positive_fraction: float = 0.5,
                      thresholds: Tuple[float, float] = (0.3, 0.7)) -> Tuple[torch.Tensor, torch.Tensor]:
    """d2 Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True) and
    subsample_labels for one image: anchors [K, 4], gt [N] -> (labels [K] in
    {-1, 0, 1} after sampling, matched gt boxes [K, 4]).

    Each anchor gets a uniform key drawn from `generator` on its own device
    (the draws moved to the anchors' device), so that a CPU generator gives
    the card and the CPU the same samples; positives and negatives are
    ranked by it separately and the first of each kept."""
    iou = pairwise_iou(gt.boxes, anchors)  # [N, K]
    iou = torch.where(gt.valid[:, None], iou, torch.full_like(iou, -1.0))
    matched_iou, matched_idx = iou.max(dim=0)
    one, zero, ignore = (torch.full_like(matched_idx, v) for v in (1, 0, -1))
    labels = torch.where(matched_iou >= thresholds[1], one, torch.where(matched_iou >= thresholds[0], ignore, zero))
    # low-quality matches: for each gt, the anchors tying its best IoU become fg
    best_per_gt = iou.max(dim=1, keepdim=True).values
    low_quality = ((iou >= best_per_gt) & (best_per_gt > 0) & gt.valid[:, None]).any(dim=0)
    labels = torch.where(low_quality, one, labels)

    k = anchors.shape[0]
    dev = generator.device if generator is not None else anchors.device
    r = torch.rand(k, generator=generator, device=dev).to(anchors.device)
    two = torch.full_like(r, 2.0)
    pos, neg = labels == 1, labels == 0
    pos_rank = torch.argsort(torch.argsort(torch.where(pos, r, two), stable=True), stable=True)
    neg_rank = torch.argsort(torch.argsort(torch.where(neg, r, two), stable=True), stable=True)
    num_pos = pos.sum().clamp(max=int(batch_size * positive_fraction))
    num_neg = torch.minimum(neg.sum(), batch_size - num_pos)
    sampled = (pos & (pos_rank < num_pos)) | (neg & (neg_rank < num_neg))
    return torch.where(sampled, labels, ignore), gt.boxes[matched_idx]


def rpn_losses(anchors: torch.Tensor, logits: torch.Tensor, deltas: torch.Tensor, labels: torch.Tensor,
               matched_boxes: torch.Tensor, batch_size: int = 256, smooth_l1_beta: float = 0.0):
    """Binary CE on the sampled anchors and L1 on the positives' deltas,
    each divided by batch_size (one image)."""
    pos = labels == 1
    valid = labels >= 0
    gt_deltas = encode_deltas(anchors, matched_boxes, RPN_BOX_WEIGHTS)
    loc = smooth_l1_loss(deltas, gt_deltas, smooth_l1_beta)
    loc = torch.where(pos[:, None], loc, torch.zeros_like(loc)).sum()
    obj = F.relu(logits) - logits * pos.to(logits.dtype) + torch.log1p(torch.exp(-logits.abs()))
    obj = torch.where(valid, obj, torch.zeros_like(obj)).sum()
    return {"loss_rpn_cls": obj / batch_size, "loss_rpn_loc": loc / batch_size}


def rpn_predict_proposals(anchors: torch.Tensor, logits: torch.Tensor, deltas: torch.Tensor,
                          image_hw: torch.Tensor, *, pre_nms_topk: int, post_nms_topk: int,
                          nms_thresh: float = 0.7) -> Proposals:
    """find_top_rpn_proposals for the single-level C4 RPN: the pre_nms_topk
    best anchors (ties to the lower index), their decoded and clipped boxes,
    NMS (the NMS kernel on the card, one launch for the batch), then the
    post_nms_topk best kept. anchors [K, 4]; logits [..., K]; deltas
    [..., K, 4]; image_hw [2] or [..., 2] -> Proposals [..., post]."""
    single = logits.dim() == 1
    if single:
        logits, deltas = logits[None], deltas[None]
    k = min(pre_nms_topk, logits.shape[-1])
    top_scores, top_idx = stable_topk(logits, k)  # [B, k]
    top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 4))
    boxes = clip_boxes(apply_deltas(top_deltas, anchors[top_idx], RPN_BOX_WEIGHTS), image_hw)
    wh = boxes[..., 2:] - boxes[..., :2]
    valid = torch.isfinite(top_scores) & (wh[..., 0] > 0) & (wh[..., 1] > 0)
    keep = nms_cuda.nms_mask(boxes.contiguous(), top_scores.float().contiguous(), valid, nms_thresh)
    post = min(post_nms_topk, k)
    sel_scores, sel_idx = stable_topk(torch.where(keep, top_scores, torch.full_like(top_scores, -math.inf)), post)
    props = Proposals(torch.gather(boxes, 1, sel_idx[..., None].expand(-1, -1, 4)), sel_scores,
                      torch.isfinite(sel_scores))
    return Proposals(*(t[0] for t in props)) if single else props


# ------------------------------------------------------ support enhancement
@device_constant
def _pe_np(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def positional_encoding_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Sinusoidal positional encoding [max_len, d_model] (f32, numpy's
    arithmetic as the JAX package's), kept on `device`."""
    return _pe_np(max_len, d_model, device=device)


class DenseRelationEnhance(nn.Module):
    """Per-shot support enhancement: add the positional encoding, a softmax
    over tokens of a 1-channel linear, add 0.5 * leaky_relu of the weighted
    global vector back."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.channel_k = nn.Linear(d_model, 1)
        self.d_model, self.max_len = d_model, max_len

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [S, L, C] -> [S, L, C]."""
        x = tokens + positional_encoding_table(self.max_len, self.d_model, device=tokens.device)[None]
        w = torch.softmax(self.channel_k(x), dim=1)  # [S, L, 1]
        global_vec = torch.einsum("slo,slc->soc", w, x)  # [S, 1, C]
        return x + 0.5 * F.leaky_relu(global_vec, 0.01)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's epsilon (1e-6) and flax's
    parameter names (`scale`, `bias`)."""

    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class PolarizedChannelAttention(nn.Module):
    """Channel-only polarized self-attention queried by the support:
    sigmoid(LN(Wz (Wv(x) . softmax(Wq(q)))))."""

    def __init__(self, channel: int = 1024):
        super().__init__()
        self.ch_wv = nn.Linear(channel, channel // 2)
        self.ch_wq = nn.Linear(channel, 1)
        self.ch_wz = nn.Linear(channel // 2, channel)
        self.ln = LayerNorm(channel)

    def forward(self, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """x: pooled query [1, H, W, C]; q: support map [1, H, W, C], both
        channel-last, flattened in their own (H, W) order -> weight [1, C]."""
        b = x.shape[0]
        wv = self.ch_wv(x).reshape(b, -1, x.shape[-1] // 2)  # [1, HW, C/2]
        wq = torch.softmax(self.ch_wq(q).reshape(b, -1, 1), dim=1)  # [1, HW, 1]
        wz = torch.einsum("bnc,bno->bc", wv, wq)
        return torch.sigmoid(self.ln(self.ch_wz(wz)))


# ------------------------------------------------------ multi-relation head
class StagePred(NamedTuple):
    scores: torch.Tensor  # [R, 2]
    deltas: torch.Tensor  # [R, 4]


class MultiRelationHead(nn.Module):
    """FsodFastRCNNOutputLayers: the global (concat, 7x7 mean, linear),
    local (per-channel correlation) and patch (49-token cross attention)
    relations; scores cor / 0.1 + fc + pr, deltas bbox_cor / 0.1."""

    def __init__(self, dim_in: int = 2048, reduce_dim: int = 256):
        super().__init__()
        half = dim_in // 2
        self.half, self.reduce_dim = half, reduce_dim
        self.conv_1 = nn.Linear(dim_in, half, bias=False)
        self.cls_score_fc = nn.Linear(2 * half, 2)
        self.cls_score_cor = nn.Linear(half, 2)
        self.bbox_pred_cor = nn.Linear(half, 4)
        self.adapt_k = nn.Linear(half, reduce_dim)
        self.adapt_q = nn.Linear(half, reduce_dim)
        self.cls_score_pr = nn.Linear(49 * 49, 2)

    def forward(self, x_query: torch.Tensor, x_support: torch.Tensor) -> StagePred:
        """x_query [R, 7, 7, 2048]; x_support [1, 7, 7, 2048] (shot mean);
        computed in f32 (a flax Dense promotes a bf16 input)."""
        x_query, x_support = at_least_f32(x_query), at_least_f32(x_support)
        q = torch.relu(self.conv_1(x_query))  # [R, 7, 7, 1024]
        s = torch.relu(self.conv_1(x_support))  # [1, 7, 7, 1024]
        cat_fc = torch.cat([q, s.expand_as(q)], dim=-1).mean(dim=(1, 2))  # [R, 2048]
        cls_fc = self.cls_score_fc(cat_fc)
        x_cor = torch.relu(torch.einsum("rhwc,ohwc->rc", q, s))  # [R, 1024]
        cls_cor = self.cls_score_cor(x_cor)
        bbox_cor = self.bbox_pred_cor(x_cor)
        r = q.shape[0]
        pe = positional_encoding_table(49, self.half, device=q.device)
        k_mat = self.adapt_k(s.reshape(1, 49, self.half) + pe[None])
        k_mat = k_mat - k_mat.mean(dim=1, keepdim=True)
        q_mat = self.adapt_q(q.reshape(r, 49, self.half) + pe[None])
        q_mat = q_mat - q_mat.mean(dim=1, keepdim=True)
        attn = torch.softmax(torch.einsum("rlc,okc->rlk", q_mat, k_mat) / math.sqrt(self.reduce_dim), dim=2)
        cls_pr = self.cls_score_pr(attn.reshape(r, -1))
        return StagePred(scores=cls_cor / 0.1 + cls_fc + cls_pr, deltas=bbox_cor / 0.1)


# ------------------------------------------------------------ the meta-arch
class FsodRCNN(nn.Module):
    """The AttentionRPN baseline; its phases are methods (module docstring)."""

    def __init__(self, depth: int = 50, num_anchors: int = 15, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone = ResNetC4(depth, ("res4",), dtype=dtype)
        self.rpn_head_mod = RPNHead(1024, num_anchors, dtype=dtype)
        self.res5 = Res5Stage(dtype=dtype)
        self.relation_head = MultiRelationHead()
        self.rpn_enhance = DenseRelationEnhance(1024, 196)
        self.rcnn_enhance = DenseRelationEnhance(2048, 49)
        self.channel_attention = PolarizedChannelAttention(1024)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        return self.backbone(images.contiguous(memory_format=torch.channels_last))["res4"]

    @staticmethod
    def _mean_map(e: torch.Tensor, side: int) -> torch.Tensor:
        # the reference's view(1, -1, side, C).transpose(1, 3): the shot-mean
        # tokens read as a [side, side, C] map with its spatial axes swapped
        return e.mean(dim=0).reshape(side, side, -1).transpose(0, 1)[None]

    def enhance_support_rpn(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._mean_map(self.rpn_enhance(tokens), 14)

    def enhance_support_rcnn(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._mean_map(self.rcnn_enhance(tokens), 7)

    def rpn_attention(self, query_res4: torch.Tensor, support_map: torch.Tensor) -> torch.Tensor:
        """channel attention (PSA on the 14x14-pooled query, queried by the
        support) times the query, plus the query scaled by the support's
        mean vector (a 1x1 depthwise correlation)."""
        pooled_q = adaptive_avg_pool2d(query_res4, (14, 14)).permute(0, 2, 3, 1)  # [1, 14, 14, C]
        cw = self.channel_attention(pooled_q, support_map)[:, :, None, None]
        sup_vec = support_map.mean(dim=(1, 2))[:, :, None, None]
        return cw * query_res4 + query_res4 * sup_vec

    def rpn_head(self, pos_features: torch.Tensor):
        logits, deltas = self.rpn_head_mod(pos_features)  # [1, A, h, w], [1, 4A, h, w]
        return logits.permute(0, 2, 3, 1).reshape(-1), deltas.permute(0, 2, 3, 1).reshape(-1, 4)

    def res5_transform(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.res5(x).permute(0, 2, 3, 1)

    def relation(self, x_query: torch.Tensor, x_support: torch.Tensor) -> StagePred:
        return self.relation_head(x_query, x_support)
