"""CenterNet head (counterpart of
``faster_orefsdet_tpu/models/centernet_head.py``): towers of {3x3 conv,
GN(32), relu} shared across levels, a per-level Scale on the ltrb
regression, relu'd ltrb output, the agnostic heatmap, and, unless
only_proposal, the class tower and per-class logits.

The live two-stage configuration is the proposal-only head (only_proposal,
with_agn_hm): share towers, then the bbox tower feeding ``bbox_pred`` and
``agn_hm``. The one-stage detector's class-aware head adds ``cls_tower{j}``
and ``cls_logits`` on the share towers' output.

The tower convs run in the compute dtype; GroupNorm returns f32, so the
prediction convs run in f32, as the JAX package's do."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from .layers import GroupNorm, Scale, conv2d


class CenterNetHead(nn.Module):
    def __init__(self, in_channels: int = 128, num_levels: int = 3, num_cls_convs: int = 0, num_classes: int = 1,
                 num_box_convs: int = 1, num_share_convs: int = 0, with_agn_hm: bool = True,
                 only_proposal: bool = True, norm_groups: int = 32, prior_prob: float = 0.01,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.num_levels = num_levels
        self.only_proposal = only_proposal
        self.with_agn_hm = with_agn_hm
        self.prior_prob = prior_prob  # the heatmap and class biases' init (utils.params)
        self.share = [f"share_tower{j}" for j in range(num_share_convs)]
        self.cls = [f"cls_tower{j}" for j in range(0 if only_proposal else num_cls_convs)]
        self.box = [f"bbox_tower{j}" for j in range(num_box_convs)]
        for name in self.share + self.cls + self.box:
            self.add_module(name, nn.Conv2d(in_channels, in_channels, 3, padding=1))
            self.add_module(f"{name}_gn", GroupNorm(in_channels, norm_groups))
        if not only_proposal:
            self.cls_logits = nn.Conv2d(in_channels, num_classes, 3, padding=1)
        self.bbox_pred = nn.Conv2d(in_channels, 4, 3, padding=1)
        if with_agn_hm:
            self.agn_hm = nn.Conv2d(in_channels, 1, 3, padding=1)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale())

    def tower_convs(self) -> List[nn.Conv2d]:
        """The convs that run in the compute dtype."""
        return [getattr(self, name) for name in self.share + self.cls + self.box]

    def _tower(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        for name in names:
            x = torch.relu(getattr(self, f"{name}_gn")(conv2d(x, getattr(self, name), self.dtype)))
        return x

    def forward(self, features: Sequence[torch.Tensor]):
        """features: [B, C, H_l, W_l] per level -> (agn_hm logits [B,1,H_l,W_l],
        bbox_reg [B,4,H_l,W_l]) per level, f32; without only_proposal
        (cls logits [B,num_classes,H_l,W_l], agn_hms, bbox_regs). Without
        with_agn_hm the agn_hm entries are None."""
        if len(features) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(features)}")
        clss, agn_hms, bbox_regs = [], [], []
        for i, feat in enumerate(features):
            x = self._tower(feat, self.share)
            bt = self._tower(x, self.box)
            bbox_regs.append(torch.relu(getattr(self, f"scale{i}")(conv2d(bt, self.bbox_pred))))
            agn_hms.append(conv2d(bt, self.agn_hm) if self.with_agn_hm else None)
            if not self.only_proposal:
                clss.append(conv2d(self._tower(x, self.cls), self.cls_logits))
        if self.only_proposal:
            return agn_hms, bbox_regs
        return clss, agn_hms, bbox_regs
