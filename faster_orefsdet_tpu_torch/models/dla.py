"""DLA-34 backbone (deep layer aggregation) of the finetune_dla family
(counterpart of ``faster_orefsdet_tpu/models/dla.py``): a 7x7 base conv,
two plain conv levels, then four hierarchical Tree stages whose Root nodes
aggregate their children.

norm="BN" (finetune_dla) is trainable BatchNorm (``layers.BatchNorm``,
module name ``bn``, so the solver puts it in the norm group); every module
takes `train`, which puts the norms in batch-statistics mode.
norm="FrozenBN" folds to the affine FrozenBatchNorm (module name ``norm``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, FrozenBatchNorm, conv2d

DLA_SPECS = {
    34: ([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512]),
}


class _ConvBN(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1, relu: bool = True,
                 norm: str = "FrozenBN", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, kernel // 2, bias=False)
        if norm == "BN":
            self.bn = BatchNorm(features)
        else:
            self.norm = FrozenBatchNorm(features)
        self.relu = relu
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d(x, self.conv, self.dtype)
        x = self.bn(x, train) if hasattr(self, "bn") else self.norm(x)
        return torch.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    """Two 3x3 convs and a residual."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _ConvBN(in_ch, features, 3, stride, norm=norm, dtype=dtype)
        self.conv2 = _ConvBN(features, features, 3, 1, relu=False, norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        if residual is None:
            residual = x
        return torch.relu(self.conv2(self.conv1(x, train), train) + residual)


class Root(nn.Module):
    """Aggregation node: a 1x1 conv over the concatenated children."""

    def __init__(self, in_ch: int, features: int, norm: str = "FrozenBN", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = _ConvBN(in_ch, features, 1, 1, relu=False, norm=norm, dtype=dtype)

    def forward(self, *children: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.conv(torch.cat(children, dim=1), train))


class Tree(nn.Module):
    """Hierarchical tree stage. As in the reference, a tree of more than one
    level computes its `project` (and updates its norm's statistics) without
    using the result."""

    def __init__(self, levels: int, in_channels: int, out_channels: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0, norm: str = "FrozenBN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        root_dim = root_dim or 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels, self.stride, self.level_root = levels, stride, level_root
        if in_channels != out_channels:
            self.project = _ConvBN(in_channels, out_channels, 1, 1, relu=False, norm=norm, dtype=dtype)
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride, norm=norm, dtype=dtype)
            self.tree2 = BasicBlock(out_channels, out_channels, 1, norm=norm, dtype=dtype)
            self.root = Root(root_dim, out_channels, norm=norm, dtype=dtype)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride, norm=norm, dtype=dtype)
            self.tree2 = Tree(levels - 1, out_channels, out_channels, root_dim=root_dim + out_channels,
                              norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor, children=None, train: bool = False) -> torch.Tensor:
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        residual = self.project(bottom, train) if hasattr(self, "project") else bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual, train)
            x2 = self.tree2(x1, train=train)
            return self.root(x2, x1, *children, train=train)
        x1 = self.tree1(x, train=train)
        children.append(x1)
        return self.tree2(x1, children=children, train=train)


class DLA(nn.Module):
    """DLA producing the NCHW maps {'dla2'..'dla5'} (strides 4..32) named in
    out_features."""

    def __init__(self, num_layers: int = 34, out_features: Tuple[str, ...] = ("dla3", "dla4", "dla5"),
                 norm: str = "FrozenBN", dtype: Optional[torch.dtype] = None):
        super().__init__()
        levels, channels = DLA_SPECS[num_layers]
        self.levels, self.out_features, self.dtype = levels, tuple(out_features), dtype
        self.base = _ConvBN(3, channels[0], 7, 1, norm=norm, dtype=dtype)
        for i in range(levels[0]):
            self.add_module(f"level0_{i}", _ConvBN(channels[0], channels[0], 3, 1, norm=norm, dtype=dtype))
        for i in range(levels[1]):
            self.add_module(f"level1_{i}", _ConvBN(channels[0] if i == 0 else channels[1], channels[1], 3,
                                                   2 if i == 0 else 1, norm=norm, dtype=dtype))
        in_ch = channels[1]
        for si in range(2, 6):
            self.add_module(f"level{si}", Tree(levels[si], in_ch, channels[si], stride=2, level_root=si > 2,
                                               norm=norm, dtype=dtype))
            in_ch = channels[si]

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.base(x, train)
        for i in range(self.levels[0]):
            x = getattr(self, f"level0_{i}")(x, train)
        for i in range(self.levels[1]):
            x = getattr(self, f"level1_{i}")(x, train)
        outputs = {}
        for si in range(2, 6):
            x = getattr(self, f"level{si}")(x, train=train)
            if f"dla{si}" in self.out_features:
                outputs[f"dla{si}"] = x
        return outputs

    @staticmethod
    def out_channels(num_layers: int = 34) -> Dict[str, int]:
        _, channels = DLA_SPECS[num_layers]
        return {f"dla{i}": channels[i] for i in range(2, 6)}
