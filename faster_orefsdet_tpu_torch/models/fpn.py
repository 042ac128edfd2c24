"""Feature pyramid network, P3-P5 with sum fusion and no top block
(counterpart of ``faster_orefsdet_tpu/models/fpn.py`` at ``top_levels=0``).
quant=True runs the lateral and output convs on the int8 path (``QuantConv``,
the same parameters)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import QuantConv, conv2d, upsample_nearest_2x


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 in_features: Tuple[str, ...] = ("stage3", "stage4", "stage5"),
                 out_channels: int = 128, fuse_type: str = "sum",
                 dtype: Optional[torch.dtype] = None, quant: bool = False):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"fuse_type {fuse_type!r}")
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        self.dtype = dtype
        self.first_stage = int(self.in_features[0][-1])
        self.quant = quant

        def conv(cin, k):
            if quant:
                return QuantConv(cin, out_channels, k, padding=k // 2, bias=True, dtype=dtype)
            return nn.Conv2d(cin, out_channels, k, padding=k // 2)

        for i, cin in enumerate(in_channels):
            s = self.first_stage + i
            self.add_module(f"lateral{s}", conv(cin, 1))
            self.add_module(f"output{s}", conv(out_channels, 3))

    def _conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        conv = getattr(self, name)
        return conv(x) if self.quant else conv2d(x, conv, self.dtype)

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = [bottom_up[f] for f in self.in_features]
        n = len(feats)
        first = self.first_stage
        laterals = [self._conv(f, f"lateral{first + i}") for i, f in enumerate(feats)]
        results = [None] * n
        prev = laterals[-1]
        results[-1] = prev
        for i in range(n - 2, -1, -1):
            prev = laterals[i] + upsample_nearest_2x(prev)
            if self.fuse_type == "avg":
                prev = prev / 2.0
            results[i] = prev
        return {
            f"p{first + i}": self._conv(results[i], f"output{first + i}") for i in range(n)
        }
