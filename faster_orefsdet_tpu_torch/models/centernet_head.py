"""CenterNet head in the live configuration (only_proposal, with_agn_hm):
shared towers of {3x3 conv, GN(32), relu}, a per-level Scale on the ltrb
regression, relu'd ltrb output, and the agnostic heatmap (counterpart of
``faster_orefsdet_tpu/models/centernet_head.py``).

The tower convs run in the compute dtype; GroupNorm returns f32, so the
prediction convs run in f32, as the JAX package's do."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import GroupNorm, Scale, conv2d


class CenterNetHead(nn.Module):
    def __init__(self, in_channels: int = 128, num_levels: int = 3, num_box_convs: int = 1,
                 num_share_convs: int = 0, with_agn_hm: bool = True, only_proposal: bool = True,
                 norm_groups: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if not (with_agn_hm and only_proposal):
            raise ValueError("the port's CenterNet head is the proposal-only, agnostic-heatmap head")
        self.dtype = dtype
        self.num_levels = num_levels
        self.towers = [f"share_tower{j}" for j in range(num_share_convs)] + [
            f"bbox_tower{j}" for j in range(num_box_convs)
        ]
        for name in self.towers:
            self.add_module(name, nn.Conv2d(in_channels, in_channels, 3, padding=1))
            self.add_module(f"{name}_gn", GroupNorm(in_channels, norm_groups))
        self.bbox_pred = nn.Conv2d(in_channels, 4, 3, padding=1)
        self.agn_hm = nn.Conv2d(in_channels, 1, 3, padding=1)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale())

    def tower_convs(self) -> List[nn.Conv2d]:
        """The convs that run in the compute dtype."""
        return [getattr(self, name) for name in self.towers]

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """features: [B, C, H_l, W_l] per level -> (agn_hm logits [B,1,H_l,W_l],
        bbox_reg [B,4,H_l,W_l]) per level, f32."""
        if len(features) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(features)}")
        agn_hms, bbox_regs = [], []
        for i, x in enumerate(features):
            for name in self.towers:
                x = torch.relu(getattr(self, f"{name}_gn")(conv2d(x, getattr(self, name), self.dtype)))
            reg = getattr(self, f"scale{i}")(conv2d(x, self.bbox_pred))
            bbox_regs.append(torch.relu(reg))
            agn_hms.append(conv2d(x, self.agn_hm))
        return agn_hms, bbox_regs
