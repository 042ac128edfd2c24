"""Res2Net backbone (counterpart of ``faster_orefsdet_tpu/models/res2net.py``):
the ResNet layout whose bottleneck splits its 3x3 stage into `scale`
groups, processed by a cascade of 3x3 convs with cross-group accumulation;
the last group passes through (stride 1) or is average-pooled (stride 2).
Res2Net-50: basewidth 26, scale 4, FrozenBN."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvNorm
from .resnet import RESNET_DEPTH_SPECS, STAGE_CHANNELS


class Bottle2neck(nn.Module):
    """1x1 -> per-group 3x3 cascade (the stride on the 3x3s) -> 1x1, with a
    shortcut (average pool by the stride, then a 1x1) on a stage's first
    block. Pools count the padding in the divisor, as flax's avg_pool does."""

    def __init__(self, in_ch: int, bottleneck_channels: int, out_channels: int, stride: int = 1,
                 has_shortcut: bool = False, scale: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.width = bottleneck_channels // scale
        self.scale, self.stride, self.has_shortcut = scale, stride, has_shortcut
        self.nums = 1 if scale == 1 else scale - 1
        if has_shortcut:
            self.shortcut = ConvNorm(in_ch, out_channels, 1, 1, relu=False, dtype=dtype)
        self.conv1 = ConvNorm(in_ch, bottleneck_channels, 1, 1, dtype=dtype)
        for i in range(self.nums):
            self.add_module(f"conv2_{i}", ConvNorm(self.width, self.width, 3, stride, dtype=dtype))
        cat = self.width * (self.nums + (scale != 1))
        self.conv3 = ConvNorm(cat, out_channels, 1, 1, relu=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        if self.has_shortcut:
            s = F.avg_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
            identity = self.shortcut(s)
        out = self.conv1(x)
        groups = [out[:, i * self.width:(i + 1) * self.width] for i in range(self.scale)]
        outs, sp = [], None
        for i in range(self.nums):
            # a stage's first block takes each group alone; later blocks add the previous output
            sp = groups[i] if i == 0 or self.has_shortcut else sp + groups[i]
            sp = getattr(self, f"conv2_{i}")(sp)
            outs.append(sp)
        if self.scale != 1:
            last = groups[-1]
            if self.stride > 1:
                last = F.avg_pool2d(last, 3, self.stride, padding=1, count_include_pad=True)
            outs.append(last)
        return torch.relu(self.conv3(torch.cat(outs, dim=1)) + identity)


class Res2Net(nn.Module):
    """Res2Net trunk producing the NCHW maps of `out_features` among
    res2..res5 (res5 built only when asked for)."""

    def __init__(self, depth: int = 50, out_features: Tuple[str, ...] = ("res3", "res4", "res5"),
                 basewidth: int = 26, scale: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        blocks = RESNET_DEPTH_SPECS[depth]
        self.out_features, self.dtype = tuple(out_features), dtype
        self.stem = ConvNorm(3, 64, 7, 2, dtype=dtype)
        self.stages = ["res2", "res3", "res4"] + (["res5"] if "res5" in self.out_features else [])
        self.blocks = blocks
        in_ch = 64
        for i, name in enumerate(self.stages):
            bc, oc = basewidth * scale * 2 ** i, STAGE_CHANNELS[i][1]
            for b in range(blocks[i]):
                self.add_module(f"{name}_block{b}", Bottle2neck(
                    in_ch, bc, oc, stride=2 if (i > 0 and b == 0) else 1, has_shortcut=b == 0, scale=scale,
                    dtype=dtype))
                in_ch = oc

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)  # padded by -inf
        outputs = {}
        for i, name in enumerate(self.stages):
            for b in range(self.blocks[i]):
                x = getattr(self, f"{name}_block{b}")(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs
