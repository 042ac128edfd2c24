"""MobileNetV3-small (counterpart of ``faster_orefsdet_tpu/models/mobilenet.py``):
a hardswish stem, torchvision's 11 inverted-residual blocks with
squeeze-excitation, a 1x1 expansion tail; FrozenBN throughout. Taps: res2
after block 1, res3 after block 3, res4 after block 8, res5 after the tail
(strides 4, 8, 16, 32). The depthwise convs are grouped ``F.conv2d`` calls
(cuDNN on the card), like every other conv of the port.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from .layers import FrozenBatchNorm, conv2d, hsigmoid


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class _IRConf(NamedTuple):
    kernel: int
    expanded: int
    out: int
    use_se: bool
    use_hs: bool  # hardswish, else relu
    stride: int


# torchvision mobilenet_v3_small inverted-residual table
MNV3_SMALL = [
    _IRConf(3, 16, 16, True, False, 2),
    _IRConf(3, 72, 24, False, False, 2),
    _IRConf(3, 88, 24, False, False, 1),
    _IRConf(5, 96, 40, True, True, 2),
    _IRConf(5, 240, 40, True, True, 1),
    _IRConf(5, 240, 40, True, True, 1),
    _IRConf(5, 120, 48, True, True, 1),
    _IRConf(5, 144, 48, True, True, 1),
    _IRConf(5, 288, 96, True, True, 2),
    _IRConf(5, 576, 96, True, True, 1),
    _IRConf(5, 576, 96, True, True, 1),
]
TAPS = {1: "res2", 3: "res3", 8: "res4"}  # blocks done -> feature name


class _ConvBNAct(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: str = "hardswish", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.norm = FrozenBatchNorm(features)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(conv2d(x, self.conv, self.dtype))
        if self.act == "relu":
            return torch.relu(x)
        return hardswish(x) if self.act == "hardswish" else x


class SqueezeExcite(nn.Module):
    """torchvision MNv3 SE: squeeze to channels // 4 rounded to 8, relu,
    hsigmoid gate."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        sq = max(8, ((channels // 4) + 4) // 8 * 8)
        self.fc1 = nn.Conv2d(channels, sq, 1)
        self.fc2 = nn.Conv2d(sq, channels, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.mean(dim=(2, 3), keepdim=True)
        g = torch.relu(conv2d(g, self.fc1, self.dtype))
        return x * hsigmoid(conv2d(g, self.fc2, self.dtype))


class InvertedResidual(nn.Module):
    def __init__(self, conf: _IRConf, in_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        act = "hardswish" if conf.use_hs else "relu"
        self.has_expand = conf.expanded != in_channels
        if self.has_expand:
            self.expand = _ConvBNAct(in_channels, conf.expanded, 1, 1, act=act, dtype=dtype)
        self.depthwise = _ConvBNAct(conf.expanded, conf.expanded, conf.kernel, conf.stride, groups=conf.expanded,
                                    act=act, dtype=dtype)
        if conf.use_se:
            self.se = SqueezeExcite(conf.expanded, dtype=dtype)
        self.project = _ConvBNAct(conf.expanded, conf.out, 1, 1, act="none", dtype=dtype)
        self.use_se = conf.use_se
        self.residual = conf.stride == 1 and in_channels == conf.out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.expand(x) if self.has_expand else x
        h = self.depthwise(h)
        if self.use_se:
            h = self.se(h)
        h = self.project(h)
        return h + x if self.residual else h


class MobileNetV3Small(nn.Module):
    def __init__(self, out_features: Tuple[str, ...] = ("res3", "res4", "res5"),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_features = tuple(out_features)
        self.dtype = dtype
        self.stem = _ConvBNAct(3, 16, 3, 2, act="hardswish", dtype=dtype)
        in_ch = 16
        for i, conf in enumerate(MNV3_SMALL):
            self.add_module(f"block{i}", InvertedResidual(conf, in_ch, dtype=dtype))
            in_ch = conf.out
        self.tail = _ConvBNAct(in_ch, 576, 1, 1, act="hardswish", dtype=dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.stem(x)
        outputs = {}
        for i in range(len(MNV3_SMALL)):
            x = getattr(self, f"block{i}")(x)
            name = TAPS.get(i + 1)
            if name in self.out_features:
                outputs[name] = x
        x = self.tail(x)
        if "res5" in self.out_features:
            outputs["res5"] = x
        return outputs

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {"res2": 16, "res3": 24, "res4": 48, "res5": 576}
