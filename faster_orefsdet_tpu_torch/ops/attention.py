"""The attention zoo, CoT and CBAM blocks on NCHW maps (counterpart of
``faster_orefsdet_tpu/ops/attention.py``). Neither is on a live path of
the reference; they are drop-in experiment blocks.

CoT's BatchNorms are ``models.layers.BatchNorm`` (flax's semantics and
names: batch statistics in train mode, which also move the running ones);
CBAM's channel MLP is two bias-free Linear layers."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.layers import BatchNorm, conv2d, linear


class CoTAttention(nn.Module):
    """Contextual-transformer attention. key: grouped (4) kxk conv + BN +
    relu (k1); value: 1x1 conv + BN; attention: [k1; x] -> 1x1 (2C -> 2C/4)
    + BN + relu -> 1x1 to k^2 C (output channel c*k^2 + tap), the mean over
    the k^2 taps, a softmax over the spatial positions, times the value
    (k2). Output k1 + k2. forward(x, train) as BatchNorm's."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.dim, self.k = dim, k
        self.key_conv = nn.Conv2d(dim, dim, k, padding=k // 2, groups=4, bias=False)
        self.key_bn = BatchNorm(dim)
        self.value_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.value_bn = BatchNorm(dim)
        self.att_conv1 = nn.Conv2d(2 * dim, 2 * dim // 4, 1, bias=False)
        self.att_bn = BatchNorm(2 * dim // 4)
        self.att_conv2 = nn.Conv2d(2 * dim // 4, k * k * dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, c, h, w = x.shape
        if c != self.dim:
            raise ValueError(f"CoTAttention({self.dim}) on {c} channels")
        k1 = torch.relu(self.key_bn(conv2d(x, self.key_conv), train))
        v = self.value_bn(conv2d(x, self.value_conv), train).reshape(b, c, h * w)
        att = torch.relu(self.att_bn(conv2d(torch.cat([k1, x.to(k1.dtype)], dim=1), self.att_conv1), train))
        att = conv2d(att, self.att_conv2).reshape(b, c, self.k * self.k, h * w).mean(dim=2)
        return k1 + (torch.softmax(att, dim=-1) * v).reshape(b, c, h, w)


class ChannelAttention(nn.Module):
    """CBAM's channel gate: a shared two-layer MLP (``se_fc1``, ``se_fc2``,
    no bias) over the global max and average pools, sigmoid of the sum ->
    [B, C, 1, 1]."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.se_fc1 = nn.Linear(channel, channel // reduction, bias=False)
        self.se_fc2 = nn.Linear(channel // reduction, channel, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(t):
            return linear(torch.relu(linear(t, self.se_fc1)), self.se_fc2)

        out = mlp(x.amax(dim=(2, 3))) + mlp(x.mean(dim=(2, 3)))
        return torch.sigmoid(out)[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM's spatial gate: a kxk conv (with bias) over [max; mean] across
    channels, sigmoid -> [B, 1, H, W]."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(conv2d(y, self.conv))


class CBAMBlock(nn.Module):
    """CBAM: x * ca(x), then times sa of that, plus the residual x; the
    spatial conv is 49x49 by default, as in the reference."""

    def __init__(self, channel: int, reduction: int = 16, kernel_size: int = 49):
        super().__init__()
        self.ca = ChannelAttention(channel, reduction)
        self.sa = SpatialAttention(kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x * self.ca(x)
        return out * self.sa(out) + x
