"""Feature pyramid network (counterpart of ``faster_orefsdet_tpu/models/fpn.py``):
1x1 laterals, top-down nearest-2x fusion (sum or avg), 3x3 outputs, and
`top_levels` extra levels above the last: P6 a stride-2 3x3 conv on P5
(``top_p6``), P7 one on relu(P6) (``top_p7``). quant=True runs the lateral
and output convs on the int8 path (``QuantConv``, the same parameters); the
top convs always run in f32, as the JAX package's do (their weights stay
f32 under ``compute_convs``' cast)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import QuantConv, conv2d, upsample_nearest_2x


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 in_features: Tuple[str, ...] = ("stage3", "stage4", "stage5"),
                 out_channels: int = 128, fuse_type: str = "sum", top_levels: int = 0,
                 dtype: Optional[torch.dtype] = None, quant: bool = False):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"fuse_type {fuse_type!r}")
        if top_levels not in (0, 1, 2):
            raise ValueError(f"top_levels={top_levels}: 0, 1 (P6) or 2 (P6, P7)")
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
        self.last = self.first_stage + len(in_channels) - 1
        self.top = [f"p{self.last + j}" for j in range(1, top_levels + 1)]
        for name in self.top:
            self.add_module(f"top_{name}", nn.Conv2d(out_channels, out_channels, 3, 2, 1))

    def compute_convs(self) -> List[nn.Module]:
        """The convs that run in the compute dtype (all but the top levels')."""
        return [m for name, m in self.named_children() if not name.startswith("top_")]

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
        out = {f"p{first + i}": self._conv(results[i], f"output{first + i}") for i in range(n)}
        prev = out[f"p{self.last}"]
        for j, name in enumerate(self.top):  # P6 on P5, P7 on relu(P6)
            prev = out[name] = conv2d(torch.relu(prev) if j else prev, getattr(self, f"top_{name}"))
        return out
