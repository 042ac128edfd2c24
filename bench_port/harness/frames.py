"""Synthetic belt frames and support shots, drawn from a seed on the run's
device in a few batched calls.

A frozen copy of the program's synthetic ore scenes (``data/synthetic``: a
gray rock texture, low-frequency noise upsampled bicubically plus pixel
noise, with filled rotated elliptical blobs whose boxes are the ground
truth) at camera size, in torch instead of numpy so that a whole pool is
drawn on the card at once.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def scenes(g: torch.Generator, n: int, hw: Tuple[int, int], blobs: Tuple[int, int], size: Tuple[float, float],
           device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n scenes [n, 3, H, W] uint8 with blobs[0]..blobs[1] blobs each, their
    boxes [n, blobs[1], 4] (xyxy, clipped) and which boxes exist [n, blobs[1]]."""
    h, w = hw
    lo, hi = blobs

    def u(*shape, a=0.0, b=1.0):
        return a + (b - a) * torch.rand(*shape, generator=g, device=device)

    base = 110.0 + 12.0 * torch.randn(n, 3, -(-h // 8), -(-w // 8), generator=g, device=device)
    img = F.interpolate(base, size=(h, w), mode="bicubic", align_corners=False)
    img = img + 6.0 * torch.randn(n, 3, h, w, generator=g, device=device)
    count = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    bw, bh = u(n, hi, a=size[0], b=size[1]), u(n, hi, a=size[0], b=size[1])
    cx = u(n, hi, a=0.0, b=1.0) * (w - bw - 4) + bw / 2 + 2
    cy = u(n, hi, a=0.0, b=1.0) * (h - bh - 4) + bh / 2 + 2
    shade = u(n, hi, a=35.0, b=75.0)
    tint = u(n, hi, a=-8.0, b=8.0)
    t = u(n, hi, a=0.0, b=math.pi)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] + 0.5
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] + 0.5
    exists = torch.arange(hi, device=device)[None, :] < count[:, None]
    for j in range(hi):
        c, s = torch.cos(t[:, j])[:, None, None], torch.sin(t[:, j])[:, None, None]
        dx, dy = xx - cx[:, j, None, None], yy - cy[:, j, None, None]
        uu, vv = dx * c + dy * s, -dx * s + dy * c
        inside = (uu / (bw[:, j, None, None] / 2)) ** 2 + (vv / (bh[:, j, None, None] / 2)) ** 2 <= 1.0
        inside = inside & exists[:, j, None, None]
        colour = torch.stack([shade[:, j], shade[:, j], shade[:, j] + tint[:, j]], 1)[:, :, None, None]
        img = torch.where(inside[:, None], colour, img)
    ex = torch.sqrt((bw / 2 * torch.cos(t)) ** 2 + (bh / 2 * torch.sin(t)) ** 2)
    ey = torch.sqrt((bw / 2 * torch.sin(t)) ** 2 + (bh / 2 * torch.cos(t)) ** 2)
    boxes = torch.stack([(cx - ex).clamp(min=0), (cy - ey).clamp(min=0), (cx + ex).clamp(max=w),
                         (cy + ey).clamp(max=h)], -1)
    return img.round().clamp(0, 255).to(torch.uint8), boxes, exists


def belt_frames(seed: int, n: int, hw: Tuple[int, int], blobs: Tuple[int, int], device) -> torch.Tensor:
    """The traffic's pool: n frames [n, 3, H, W] uint8 of 1-6 ore blobs."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 2 + 1)
    return scenes(g, n, hw, blobs, (12.0, 180.0), device)[0]


def support_shots(seed: int, shots: int, crop: int, canvas: int, pixel_mean, pixel_std, device):
    """`shots` support crops of one blob each, normalized on a canvas of
    `canvas` px (zero beyond the crop): (images [K, 3, canvas, canvas] f32,
    boxes [K, 4] xyxy in crop coordinates)."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 2)
    img, boxes, _ = scenes(g, shots, (crop, crop), (1, 1), (60.0, 200.0), device)
    mean = torch.tensor(pixel_mean, device=device).view(1, 3, 1, 1)
    std = torch.tensor(pixel_std, device=device).view(1, 3, 1, 1)
    x = F.pad((img.float() - mean) / std, (0, canvas - crop, 0, canvas - crop))
    return x, boxes[:, 0]
