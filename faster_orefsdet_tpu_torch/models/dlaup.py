"""DLA-Up decoder (counterpart of ``faster_orefsdet_tpu/models/dlaup.py``):
DLA-34 and a decoder that merges deeper levels into shallower ones through
modulated deformable-conv projection and node blocks and a fixed bilinear
2x upsampling, emitting one stride-4 map 'dla2'.

The reference's depthwise ConvTranspose2d upsampler initialized to bilinear
weights is a fixed half-pixel bilinear resize, as in the JAX package."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import deform_conv2d
from .dla import DLA, DLA_SPECS
from .layers import FrozenBatchNorm, conv2d


class DeformConvBlock(nn.Module):
    """Modulated DCN + FrozenBN + relu: a 3x3 conv (``offset``) gives 18
    offset channels (dy, dx per tap) and 9 mask logits (sigmoid); the DCN's
    own weights are ``weight`` [Cout, Cin, 3, 3]."""

    def __init__(self, in_ch: int, out_channels: int):
        super().__init__()
        self.offset = nn.Conv2d(in_ch, 27, 3, padding=1)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_ch, 3, 3))
        self.norm = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = conv2d(x, self.offset)
        y = deform_conv2d(x, om[:, :18], self.weight, torch.sigmoid(om[:, 18:]))
        return torch.relu(self.norm(y))


def bilinear_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel bilinear resize to 2x (the JAX package's
    ``jax.image.resize(..., "linear")``; at 2x both put the border rows'
    weight on the edge pixel)."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


class IDAUp(nn.Module):
    """Iterative deep aggregation: layer i is projected (``proj_i``),
    upsampled by its factor, added to layer i-1 and merged (``node_i``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, up_factors: Sequence[int]):
        super().__init__()
        self.up_factors = tuple(up_factors)
        for i in range(1, len(in_channels)):
            self.add_module(f"proj_{i}", DeformConvBlock(in_channels[i], out_channels))
            self.add_module(f"node_{i}", DeformConvBlock(out_channels, out_channels))

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(1, len(layers)):
            x = getattr(self, f"proj_{i}")(layers[i])
            f = self.up_factors[i - 1]
            while f > 1:
                x = bilinear_upsample_2x(x)
                f //= 2
            layers[i] = getattr(self, f"node_{i}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Merge the deepest level downward, one IDAUp (``ida_i``) a level."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.channels = list(channels)
        n = len(self.channels)
        # the widths each IDAUp sees: its target level's and, above it, the
        # outputs of the previous IDAUp (already at the target's width)
        widths = list(self.channels)
        for i in range(n - 1):
            j = n - i - 2
            self.add_module(f"ida_{i}", IDAUp(widths[j:], self.channels[j], (2,) * (n - 1 - j)))
            widths[j + 1:] = [self.channels[j]] * (n - 1 - j)

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        n = len(self.channels)
        for i in range(n - 1):
            j = n - i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA backbone (``base``) + DLA-Up (``dla_up``) + a final IDA-Up
    (``ida_up``) over the three finest decoder outputs -> {'dla2'} [B, 64,
    H/4, W/4]."""

    def __init__(self, num_layers: int = 34):
        super().__init__()
        _, channels = DLA_SPECS[num_layers]
        self.base = DLA(num_layers, ("dla2", "dla3", "dla4", "dla5"))
        self.dla_up = DLAUp(channels[2:])
        self.ida_up = IDAUp(channels[2:5], channels[2], (2, 4))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        base = self.base(x)
        up = self.dla_up([base[f"dla{i}"] for i in range(2, 6)])
        return {"dla2": self.ida_up(up[:3])[-1]}
