"""RegNet backbone family, RegNetX and RegNetY (counterpart of
``faster_orefsdet_tpu/models/regnet.py``): a 3x3/2 stem and four stages of
grouped-bottleneck residual blocks (squeeze-excitation for RegNetY), with
per-stage widths and depths generated from (w_a, w_0, w_m, d). Every
stage's first block has a projection shortcut, as the JAX package builds
it. The defaults are RegNetX-400MF."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .layers import ConvNorm, conv2d


def generate_regnet_parameters(w_a: float, w_0: int, w_m: float, d: int, q: int = 8
                               ) -> Tuple[List[int], List[int]]:
    """Per-stage (widths, depths) from the RegNet design-space parameters."""
    ws_cont = np.arange(d) * w_a + w_0
    ks = np.round(np.log(ws_cont / w_0) / np.log(w_m))
    ws_all = w_0 * np.power(w_m, ks)
    ws_all = np.round(ws_all / q).astype(int) * q
    ws, ds = np.unique(ws_all, return_counts=True)
    return ws.tolist(), ds.tolist()


def block_widths(out_channels: int, group_width: int, bottleneck_ratio: float = 1.0) -> Tuple[int, int]:
    """(bottleneck width, groups): the group width capped at the bottleneck
    width, the bottleneck width rounded to a multiple of it."""
    w_b = int(round(out_channels * bottleneck_ratio))
    gw = min(group_width, w_b)
    w_b = int(round(w_b / gw) * gw)
    return w_b, w_b // gw


class ResBottleneckBlock(nn.Module):
    """1x1 (``a``) -> grouped 3x3 with the stride (``b``) -> [SE] -> 1x1
    (``c``) + the residual, relu."""

    def __init__(self, in_ch: int, out_channels: int, stride: int = 1, group_width: int = 16,
                 bottleneck_ratio: float = 1.0, se_ratio: float = 0.0, has_shortcut: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        w_b, groups = block_widths(out_channels, group_width, bottleneck_ratio)
        self.has_shortcut, self.se = has_shortcut, se_ratio > 0
        if has_shortcut:
            self.shortcut = ConvNorm(in_ch, out_channels, 1, stride, relu=False, dtype=dtype)
        self.a = ConvNorm(in_ch, w_b, 1, 1, dtype=dtype)
        self.b = ConvNorm(w_b, w_b, 3, stride, dtype=dtype, groups=groups)
        if self.se:
            se_ch = max(1, int(round(in_ch * se_ratio)))
            self.se_fc1 = nn.Conv2d(w_b, se_ch, 1)
            self.se_fc2 = nn.Conv2d(se_ch, w_b, 1)
        self.c = ConvNorm(w_b, out_channels, 1, 1, relu=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.shortcut(x) if self.has_shortcut else x
        h = self.b(self.a(x))
        if self.se:
            g = torch.relu(conv2d(h.mean(dim=(2, 3), keepdim=True), self.se_fc1))
            h = h * torch.sigmoid(conv2d(g, self.se_fc2))
        return torch.relu(self.c(h) + identity)


class RegNet(nn.Module):
    """RegNet trunk producing the NCHW maps {'s1'..'s4'} (strides 4..32)
    named in out_features."""

    def __init__(self, w_a: float = 24.48, w_0: int = 24, w_m: float = 2.54, depth: int = 22,
                 group_width: int = 16, se_ratio: float = 0.0, out_features: Tuple[str, ...] = ("s2", "s3", "s4"),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.widths, self.depths = generate_regnet_parameters(w_a, w_0, w_m, depth)
        self.out_features, self.dtype = tuple(out_features), dtype
        self.stem = ConvNorm(3, 32, 3, 2, dtype=dtype)
        in_ch = 32
        for si, (wi, di) in enumerate(zip(self.widths, self.depths), start=1):
            for b in range(di):
                self.add_module(f"s{si}_block{b}", ResBottleneckBlock(
                    in_ch, wi, stride=2 if b == 0 else 1, group_width=group_width, se_ratio=se_ratio,
                    has_shortcut=b == 0, dtype=dtype))
                in_ch = wi

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.stem(x)
        outputs = {}
        for si, di in enumerate(self.depths, start=1):
            for b in range(di):
                x = getattr(self, f"s{si}_block{b}")(x)
            if f"s{si}" in self.out_features:
                outputs[f"s{si}"] = x
        return outputs
