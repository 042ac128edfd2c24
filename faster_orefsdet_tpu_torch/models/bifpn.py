"""BiFPN: a bidirectional feature pyramid with fast normalized fusion
(counterpart of ``faster_orefsdet_tpu/models/bifpn.py``), the neck of the
finetune_dla family. Repeated SingleBiFPN cells over three levels; each
fusion node takes its resampled inputs with learned relu-normalized weights,
applies swish and a 3x3 output conv. The 3-level node graph:

  node4 = fuse(f1, f2 up)      node5 = fuse(f0, f4 up)
  node6 = fuse(f1, f4, f5 down)  node7 = fuse(f2, f6 down)
  outputs (f0, f1, f2 levels) = (node5, node6, node7)

Under GroupNorm (norm="GN") the lateral 1x1 convs keep their bias and the
output convs drop it; norm="" is the bare-conv variant.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import GroupNorm, conv2d, upsample_nearest_2x

# (feature level, input offsets) of each node of the 3-level cell
NODES_3LEVEL = [
    (1, (1, 2)),
    (0, (0, 3)),
    (1, (1, 3, 4)),
    (2, (2, 5)),
]


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _resample(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Match the target's size: a 3x3/2 max pool over -inf padding down,
    nearest 2x up."""
    h, w = x.shape[-2:]
    th, tw = target_hw
    if h > th and w > tw:
        return F.max_pool2d(x, 3, 2, padding=1)
    if h < th or w < tw:
        x = upsample_nearest_2x(x)
        assert tuple(x.shape[-2:]) == (th, tw), (tuple(x.shape), target_hw)
    return x


class _ConvGN(nn.Module):
    """conv -> GroupNorm(32) (norm="GN"), or the conv alone (norm="")."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1, use_bias: bool = True, norm: str = "GN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, 1, kernel // 2, bias=use_bias)
        if norm == "GN":
            self.gn = GroupNorm(features, 32)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(x, self.conv, self.dtype)
        return self.gn(x) if hasattr(self, "gn") else x


def _name(feat_level: int, offsets: Sequence[int]) -> str:
    return f"f{feat_level}_" + "_".join(map(str, offsets))


class SingleBiFPN(nn.Module):
    def __init__(self, out_channels: int = 160, in_channels_list: Tuple[int, ...] = (128, 256, 512),
                 norm: str = "GN", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_channels_list = tuple(in_channels_list)
        node_channels = list(in_channels_list)
        for feat_level, offsets in NODES_3LEVEL:
            for off in offsets:
                # one lateral per (input, level): a later node of the same pair reuses it
                lname = f"lateral_{off}_f{feat_level}"
                if node_channels[off] != out_channels and not hasattr(self, lname):
                    self.add_module(lname, _ConvGN(node_channels[off], out_channels, 1, True, norm, dtype))
            name = _name(feat_level, offsets)
            self.register_parameter(f"weights_{name}", nn.Parameter(torch.ones(len(offsets))))
            self.add_module(f"output_{name}", _ConvGN(out_channels, out_channels, 3, norm == "", norm, dtype))
            node_channels.append(out_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        feats = list(feats)
        for feat_level, offsets in NODES_3LEVEL:
            target_hw = tuple(feats[feat_level].shape[-2:])
            inputs = []
            for off in offsets:
                node = feats[off]
                lname = f"lateral_{off}_f{feat_level}"
                if off < len(self.in_channels_list) and hasattr(self, lname):
                    node = getattr(self, lname)(node)
                inputs.append(_resample(node, target_hw))
            name = _name(feat_level, offsets)
            w = torch.relu(getattr(self, f"weights_{name}"))
            w = w / (w.sum() + 1e-4)
            fused = sum(wi * xi for wi, xi in zip(w, inputs))
            feats.append(getattr(self, f"output_{name}")(swish(fused)))
        # each level's output is its last node
        out: List[Optional[torch.Tensor]] = [None, None, None]
        for ni in range(len(NODES_3LEVEL) - 1, -1, -1):
            lvl = NODES_3LEVEL[ni][0]
            if out[lvl] is None:
                out[lvl] = feats[len(self.in_channels_list) + ni]
        return out


class BiFPN(nn.Module):
    """Repeated SingleBiFPN over three bottom-up levels -> {'p3','p4','p5'}."""

    def __init__(self, in_features: Tuple[str, ...] = ("dla3", "dla4", "dla5"),
                 in_channels: Tuple[int, ...] = (128, 256, 512), out_channels: int = 160, num_repeats: int = 4,
                 norm: str = "GN", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = tuple(in_features)
        chans = tuple(in_channels)
        for r in range(num_repeats):
            self.add_module(f"repeat{r}", SingleBiFPN(out_channels, chans, norm, dtype))
            chans = (out_channels,) * 3
        self.num_repeats = num_repeats

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = [bottom_up[f] for f in self.in_features]
        for r in range(self.num_repeats):
            feats = getattr(self, f"repeat{r}")(feats)
        return {"p3": feats[0], "p4": feats[1], "p5": feats[2]}
