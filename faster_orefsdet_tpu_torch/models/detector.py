"""CenterNet2Detector: the few-shot ore detector as one nn.Module whose
phases are methods (counterpart of ``faster_orefsdet_tpu/models/detector.py``):

  features          backbone + neck (VoVNet + FPN, DLA-34 + BiFPN, ResNet-50
                    + FPN, or MobileNetV3-small + FPN)
  refine_support    adaptive pool -> SM block -> spatial transpose quirk
  correlate         CGM correlation + conv3 fusion (the CGM kernel with
                    cfg.use_pallas_cgm, else the differentiable composition)
  proposal_head     CenterNet head
  roi_stage         DSA cascade stage

cfg.quantize selects the int8 backbone and FPN of the quantized serving
presets (``ops/quant.py``): each module that reads an activation scale
gets its key, the JAX package's module path, once here.

Feature maps are logical NCHW. On the card they are kept channels-last in
memory, so the CGM kernel reads each level as [B, H, W, C] without a copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import Config
from ..ops.adaptive_pool import adaptive_avg_pool2d
from ..ops.cgm_cuda import cgm_correlate_fused
from ..ops.correlation import cgm_correlate
from .bifpn import BiFPN
from .cascade_roi import DSACascadeHead, DSAFold, StageOutput
from .centernet_head import CenterNetHead
from .dla import DLA
from .fpn import FPN
from .layers import assign_scale_keys, at_least_f32, linear
from .mobilenet import MobileNetV3Small
from .resnet import ResNetC4
from .sm_block import SMBlock
from .vovnet import VoVNet

# per-level SM pool size == seg_dim: p3 -> 32, p4 -> 16, p5 -> 8
SM_POOL_SIZES = {"p3": 32, "p4": 16, "p5": 8}
RES_LEVELS = ("res3", "res4", "res5")

# the backbone families the port builds
BACKBONES = ("vovnet_fpn", "dla_bifpn", "resnet_fpn", "mnv3_fpn")
# the families with an FPN over their res3-res5 maps (ResNet-50, MobileNetV3-small)
RES_FPN = {"resnet_fpn": ResNetC4, "mnv3_fpn": MobileNetV3Small}
QUANTIZE_MODES = ("none", "int8", "int8_static", "int8_resident")

# parameters that fine-tuning never updates: VoVNet's stem, stage2 and stage3
# (FREEZE_AT=3; the DLA builders ignore it), and by the same names the stem
# of ResNet and MobileNetV3, as the JAX package's labels freeze them. Every
# FrozenBN affine is frozen too; here it is a buffer.
FROZEN_PREFIXES = ("backbone.stem", "backbone.stage2_", "backbone.stage3_")

Kernels = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def support_kernels(mean_map: torch.Tensor) -> Kernels:
    """Pool a (shot-mean, spatially transposed) support map [..., S, S, C]
    into the three CGM kernels: k1 [..., C], k13 [..., 3, C] (W taps), k31
    [..., 3, C] (H taps), f32. A leading axis gives one set per image."""
    m = at_least_f32(mean_map).movedim(-1, -3)  # [..., C, S0, S1], S0 the map's first axis
    k1 = adaptive_avg_pool2d(m, (1, 1))[..., 0, 0].contiguous()
    k13 = adaptive_avg_pool2d(m, (1, 3))[..., 0, :].transpose(-1, -2).contiguous()
    k31 = adaptive_avg_pool2d(m, (3, 1))[..., :, 0].transpose(-1, -2).contiguous()
    return k1, k13, k31


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    """torch dtype of cfg.compute_dtype, None for float32 (promotion rules)."""
    if cfg.compute_dtype in (None, "", "float32"):
        return None
    return getattr(torch, cfg.compute_dtype)


class CenterNet2Detector(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.quantize not in QUANTIZE_MODES:
            # a typo must not silently build an unquantized model
            raise ValueError(f"cfg.quantize={cfg.quantize!r}; expected 'none', 'int8', 'int8_static' or "
                             "'int8_resident'")
        quant = cfg.quantize != "none"
        if quant and cfg.backbone_name != "vovnet_fpn":
            raise ValueError("quantize='int8' is plumbed for the vovnet_fpn family (the published live model); "
                             f"got backbone_name={cfg.backbone_name!r}")
        if cfg.backbone_name not in BACKBONES:
            raise ValueError(f"backbone_name {cfg.backbone_name!r}: the port has {BACKBONES}")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        c = cfg.fpn.out_channels
        if cfg.backbone_name == "dla_bifpn":
            levels = ("dla3", "dla4", "dla5")
            self.backbone = DLA(cfg.dla.num_layers, levels, norm=cfg.dla.norm, dtype=self.dtype)
            chans = DLA.out_channels(cfg.dla.num_layers)
            self.fpn = BiFPN(levels, tuple(chans[f] for f in levels), c, cfg.fpn.bifpn_repeats, cfg.fpn.bifpn_norm,
                             dtype=self.dtype)
        elif cfg.backbone_name in RES_FPN:
            family = RES_FPN[cfg.backbone_name]
            self.backbone = family(out_features=RES_LEVELS, dtype=self.dtype)
            chans = family.out_channels()
            self.fpn = FPN([chans[f] for f in RES_LEVELS], RES_LEVELS, c, cfg.fpn.fuse_type, cfg.fpn.top_levels,
                           dtype=self.dtype)
        else:
            # the backbone int8-resident under int8_resident; the FPN keeps the
            # int8_static scheme (its inputs are the float stage outputs)
            self.backbone = VoVNet(cfg.vovnet.conv_body, cfg.vovnet.out_features, dtype=self.dtype, quant=quant,
                                   resident=cfg.quantize == "int8_resident")
            chans = VoVNet.out_channels(cfg.vovnet.conv_body)
            self.fpn = FPN([chans[f] for f in cfg.fpn.in_features], cfg.fpn.in_features, c,
                           cfg.fpn.fuse_type, cfg.fpn.top_levels, dtype=self.dtype, quant=quant)
        self.vip_p3 = SMBlock(c, SM_POOL_SIZES["p3"])
        self.vip_p4 = SMBlock(c, SM_POOL_SIZES["p4"])
        self.vip_p5 = SMBlock(c, SM_POOL_SIZES["p5"])
        self.cgm_conv3 = nn.Linear(2 * c, c)
        self.head = CenterNetHead(
            in_channels=c, num_levels=len(cfg.centernet.in_features),
            num_box_convs=cfg.centernet.num_box_convs,
            num_share_convs=cfg.centernet.num_share_convs,
            with_agn_hm=cfg.centernet.with_agn_hm, only_proposal=cfg.centernet.only_proposal,
            prior_prob=cfg.centernet.prior_prob, dtype=self.dtype,
        )
        self.roi = DSACascadeHead(cfg.roi, c)
        assign_scale_keys(self)

    @property
    def levels(self) -> Tuple[str, ...]:
        return tuple(self.cfg.centernet.in_features)

    def freeze(self) -> "CenterNet2Detector":
        """Mark the frozen parameters (FROZEN_PREFIXES) requires_grad=False,
        so that autograd never runs backward through the frozen stages."""
        for name, p in self.named_parameters():
            if name.startswith(FROZEN_PREFIXES):
                p.requires_grad_(False)
        return self

    def cast_compute_weights(self) -> "CenterNet2Detector":
        """Store the weights of the layers that run in the compute dtype in
        that dtype, once, instead of casting them at every use (the same
        numbers: the cast is the one those layers apply). Serving only:
        training keeps f32 master weights. A quantized backbone and FPN keep
        theirs: the int8 layers quantize the f32 weights, and the resident
        epilogue applies FrozenBN in f32."""
        if self.dtype is not None:
            if self.cfg.quantize == "none":
                self.backbone.to(self.dtype)
                for m in self.fpn.compute_convs() if isinstance(self.fpn, FPN) else [self.fpn]:
                    m.to(self.dtype)
            for conv in self.head.tower_convs():
                conv.to(self.dtype)
        return self

    # ---------------------------------------------------------------- phases
    def features(self, images: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        """images [B, 3, H, W] normalized -> {'p3','p4','p5'} [B, C, H_l, W_l]
        (and 'p6', 'p7' under fpn.top_levels).
        train=True puts trainable norms (DLA's BatchNorm) in batch-statistics
        mode and updates their running statistics; backbones without them
        ignore it."""
        x = images.contiguous(memory_format=torch.channels_last)
        if self.cfg.backbone_name == "dla_bifpn":
            return self.fpn(self.backbone(x, train=train))
        return self.fpn(self.backbone(x))

    def refine_support(self, sup_feats: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Support pyramid [N, C, h_l, w_l] -> SM-refined, spatially transposed
        maps [N, S_l, S_l, C] (channel-last, as the support cache keeps them).
        The SM blocks' dropout draws from `generator` when one is given."""
        vips = {"p3": self.vip_p3, "p4": self.vip_p4, "p5": self.vip_p5}
        out = {}
        for level in self.levels:
            size = SM_POOL_SIZES[level]
            x = adaptive_avg_pool2d(sup_feats[level], (size, size)).permute(0, 2, 3, 1)
            x = vips[level](x, generator)
            out[level] = x.transpose(1, 2)  # the reference's permute(0,3,2,1) quirk
        return out

    def correlate(self, query_feats: Dict[str, torch.Tensor], kernels: Dict[str, Kernels],
                  per_class: bool = False) -> Dict[str, torch.Tensor]:
        """CGM correlation + conv3 fusion per level.

        With cfg.use_pallas_cgm (the serving presets) the whole level runs in
        the fused CGM kernel (its plain twin on the CPU): one set of taps for
        the batch, f32 arithmetic, the result in the level's dtype; it has no
        backward. Without it (fine-tuning) the level is the differentiable
        composition cgm_correlate -> cgm_conv3 -> relu, as in the JAX
        package; its taps may carry a leading batch axis, one set per image.

        With `per_class` the taps' leading axis is a class axis instead (N
        sets, k1 [N, C]) and each level's result is [N*B, C, H, W],
        class-major (row c*B + i: class c, image i): one kernel launch a
        level under cfg.use_pallas_cgm, else the composition once a class."""
        out = {}
        for level in self.levels:
            q_nhwc = query_feats[level].contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            if self.cfg.use_pallas_cgm:
                if kernels[level][0].dim() != (2 if per_class else 1):
                    raise ValueError(f"correlate: the fused CGM takes one set of taps, or one a class with "
                                     f"per_class=True; got k1 {tuple(kernels[level][0].shape)}")
                # w3 [C, 2C] f32 as stored, columns [attn; q]
                fused = cgm_correlate_fused(q_nhwc, *kernels[level], self.cgm_conv3.weight, self.cgm_conv3.bias)
            elif per_class:
                fused = torch.cat([self._composition(q_nhwc, *taps) for taps in zip(*kernels[level])])
            else:
                fused = self._composition(q_nhwc, *kernels[level])
            out[level] = fused.permute(0, 3, 1, 2)
        return out

    def _composition(self, q_nhwc: torch.Tensor, k1: torch.Tensor, k13: torch.Tensor,
                     k31: torch.Tensor) -> torch.Tensor:
        """relu(conv3([cgm_correlate(q) | q])): the differentiable level."""
        if k1.dim() == 2:  # per image: [B, C], [B, 3, C] -> broadcast over H, W
            k1 = k1[:, None, None, :]
            k13, k31 = (k.transpose(0, 1)[:, :, None, None, :] for k in (k13, k31))
        corr = cgm_correlate(q_nhwc, k1, k13, k31)
        return torch.relu(linear(torch.cat([corr, q_nhwc], dim=-1), self.cgm_conv3))

    def proposal_head(self, pos_features: Dict[str, torch.Tensor]):
        """CenterNet head over the correlated pyramid -> (agn_hms, bbox_regs)."""
        return self.head([pos_features[level] for level in self.levels])

    def roi_stage(self, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                  support_8: torch.Tensor, support_4: torch.Tensor, stage: int = 0,
                  fold: Optional[DSAFold] = None) -> StageOutput:
        """One cascade stage on the original (un-correlated) pyramid (`fold`
        as ``DSACascadeHead.forward`` takes it)."""
        return self.roi(features, boxes, support_8, support_4, stage, fold)
