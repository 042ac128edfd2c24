"""Feature pyramid network, P3-P5 with sum fusion and no top block
(counterpart of ``faster_orefsdet_tpu/models/fpn.py`` at ``top_levels=0``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import conv2d, upsample_nearest_2x


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 in_features: Tuple[str, ...] = ("stage3", "stage4", "stage5"),
                 out_channels: int = 128, fuse_type: str = "sum",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"fuse_type {fuse_type!r}")
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        self.dtype = dtype
        self.first_stage = int(self.in_features[0][-1])
        for i, cin in enumerate(in_channels):
            s = self.first_stage + i
            self.add_module(f"lateral{s}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"output{s}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = [bottom_up[f] for f in self.in_features]
        n = len(feats)
        first = self.first_stage
        laterals = [conv2d(f, getattr(self, f"lateral{first + i}"), self.dtype) for i, f in enumerate(feats)]
        results = [None] * n
        prev = laterals[-1]
        results[-1] = prev
        for i in range(n - 2, -1, -1):
            prev = laterals[i] + upsample_nearest_2x(prev)
            if self.fuse_type == "avg":
                prev = prev / 2.0
            results[i] = prev
        return {
            f"p{first + i}": conv2d(results[i], getattr(self, f"output{first + i}"), self.dtype)
            for i in range(n)
        }
