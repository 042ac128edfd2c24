"""ResNet in detectron2's C4 layout (counterpart of
``faster_orefsdet_tpu/models/resnet.py``): stem 7x7/2 + maxpool 3x3/2,
bottleneck stages res2-res5 with FrozenBN. The AttentionRPN baseline takes
res4 from ``ResNetC4`` and runs ``Res5Stage`` in its ROI head; the
``resnet_fpn`` CenterNet2 family takes res3-res5 of the full trunk.

stride_in_1x1=True puts a stage's stride on the block's first 1x1 conv
(detectron2's MSRA weights); False puts it on the 3x3 (torchvision's
layout, ``utils.torch_convert.convert_torchvision_resnet``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvNorm

# depth -> blocks per stage (res2..res5)
RESNET_DEPTH_SPECS = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}
# (bottleneck, out) channels of res2..res5
STAGE_CHANNELS = [(64, 256), (128, 512), (256, 1024), (512, 2048)]


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 with FrozenBN, a projection shortcut on the
    stage's first block, relu after the sum."""

    def __init__(self, in_ch: int, bottleneck_channels: int, out_channels: int, stride: int = 1,
                 has_shortcut: bool = False, stride_in_1x1: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if has_shortcut:
            self.shortcut = ConvNorm(in_ch, out_channels, 1, stride, relu=False, dtype=dtype)
        self.conv1 = ConvNorm(in_ch, bottleneck_channels, 1, s1, dtype=dtype)
        self.conv2 = ConvNorm(bottleneck_channels, bottleneck_channels, 3, s3, dtype=dtype)
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1, 1, relu=False, dtype=dtype)
        self.has_shortcut = has_shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.shortcut(x) if self.has_shortcut else x
        return torch.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


class ResNetStage(nn.Module):
    def __init__(self, in_ch: int, num_blocks: int, bottleneck_channels: int, out_channels: int,
                 first_stride: int = 1, stride_in_1x1: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", BottleneckBlock(
                in_ch if i == 0 else out_channels, bottleneck_channels, out_channels,
                stride=first_stride if i == 0 else 1, has_shortcut=i == 0, stride_in_1x1=stride_in_1x1,
                dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNetC4(nn.Module):
    """ResNet producing the NCHW maps of `out_features` among res2..res4, and
    res5 when it is asked for (the full trunk of the FPN family; the C4
    baseline's res5 is ``Res5Stage``)."""

    def __init__(self, depth: int = 50, out_features: Tuple[str, ...] = ("res4",), stride_in_1x1: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if depth not in RESNET_DEPTH_SPECS:
            raise ValueError(f"depth {depth}: have {sorted(RESNET_DEPTH_SPECS)}")
        blocks = RESNET_DEPTH_SPECS[depth]
        self.out_features = tuple(out_features)
        self.dtype = dtype
        self.stem = ConvNorm(3, 64, 7, 2, dtype=dtype)
        self.stages = ["res2", "res3", "res4"] + (["res5"] if "res5" in self.out_features else [])
        in_ch = 64
        for i, name in enumerate(self.stages):
            bc, oc = STAGE_CHANNELS[i]
            self.add_module(name, ResNetStage(in_ch, blocks[i], bc, oc, first_stride=1 if i == 0 else 2,
                                              stride_in_1x1=stride_in_1x1, dtype=dtype))
            in_ch = oc

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)  # d2's stem maxpool (padding by -inf)
        outputs = {}
        for name in self.stages:
            x = getattr(self, name)(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {f"res{i + 2}": oc for i, (_, oc) in enumerate(STAGE_CHANNELS)}


class Res5Stage(nn.Module):
    """The baseline ROI head's res5: 3 bottlenecks, stride 2 first, 2048
    out, on pooled 14x14 ROI features [R, 1024, 14, 14] -> [R, 2048, 7, 7]."""

    def __init__(self, stride_in_1x1: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.res5 = ResNetStage(1024, 3, 512, 2048, first_stride=2, stride_in_1x1=stride_in_1x1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res5(x)
