"""SM block: spatial-shift MLP support refinement (counterpart of
``faster_orefsdet_tpu/models/sm_block.py``). Works channel-last, x [B, H, W, C],
with seg_dim chosen per level so that H * (C / seg_dim) == C.

The reweighting MLP has two dropouts (p = 0.1) in training. They draw from
an explicit generator: given one, the block drops; without one (inference,
or a deterministic training step) it does not."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import linear


class SMBlock(nn.Module):
    def __init__(self, dim: int, seg_dim: int, drop_rate: float = 0.1):
        super().__init__()
        self.dim = dim
        self.seg_dim = seg_dim
        self.drop_rate = drop_rate
        self.mlp_h = nn.Linear(dim, dim, bias=False)
        self.mlp_w = nn.Linear(dim, dim, bias=False)
        self.reweight_fc1 = nn.Linear(dim, dim // 2)
        self.reweight_fc2 = nn.Linear(dim // 2, dim * 2)
        self.proj = nn.Linear(dim, dim)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """flax Dropout: keep with probability 1 - p, scaled by 1 / (1 - p)."""
        if generator is None or self.drop_rate == 0.0:
            return x
        keep_prob = 1.0 - self.drop_rate
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, C]; dropout drawn from `generator`
        when one is given."""
        b, h, w, c = x.shape
        seg = self.seg_dim
        s = c // seg

        # h-mixing: fold H into the feature axis per channel segment
        he = x.reshape(b, h, w, seg, s).permute(0, 3, 2, 1, 4).reshape(b, seg, w, h * s)
        he = linear(he, self.mlp_h)
        he = he.reshape(b, seg, w, h, s).permute(0, 3, 2, 1, 4).reshape(b, h, w, c)

        # w-mixing
        we = x.reshape(b, h, w, seg, s).permute(0, 3, 1, 2, 4).reshape(b, seg, h, w * s)
        we = linear(we, self.mlp_w)
        we = we.reshape(b, seg, h, w, s).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)

        # 2-way reweighting: global mean -> MLP(C -> C/2 -> 2C) -> softmax
        weight = (he + we).mean(dim=(1, 2))
        weight = F.gelu(linear(weight, self.reweight_fc1), approximate="none")
        weight = self._dropout(weight, generator)
        weight = self._dropout(linear(weight, self.reweight_fc2), generator)
        weight = torch.softmax(weight.reshape(b, c, 2), dim=-1)
        w0 = weight[..., 0][:, None, None, :]
        w1 = weight[..., 1][:, None, None, :]
        # the branch weights are crossed, as in the reference
        return linear(we * w0 + he * w1, self.proj)
