"""Modulated deformable convolution (v1 and v2), plain PyTorch (counterpart
of ``faster_orefsdet_tpu/ops/deform_conv.py``), batched over images.

For output pixel p and kernel tap k the input is sampled at
``p*stride + dilation*(k - center) + offset_k(p)`` by bilinear interpolation
with the CUDA im2col border rules (a sample outside (-1, H) x (-1, W) is
zero; each of its four corners counts only when it lies in the image), then
scaled by the v2 modulation mask, and the sampled [B, Ho, Wo, K, Cin]
tensor is contracted with the weights. ``F.grid_sample`` is not used: its
coordinate normalization and border rules differ.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bilinear_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W]; ys, xs [B, ...] sample coordinates -> [B, ..., C]
    (zero outside the image)."""
    b, c, h, w = x.shape
    flat = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    inrange = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    y0i, x0i = y0.long(), x0.long()
    # clip after the +1 on the raw floor: clipping first would alias the
    # x0 = -1 border corner onto column 1 instead of 0
    y1c, x1c = (y0i + 1).clamp(0, h - 1), (x0i + 1).clamp(0, w - 1)
    y0c, x0c = y0i.clamp(0, h - 1), x0i.clamp(0, w - 1)
    vy0, vy1 = (y0 >= 0) & (y0 <= h - 1), (y0 + 1 >= 0) & (y0 + 1 <= h - 1)
    vx0, vx1 = (x0 >= 0) & (x0 <= w - 1), (x0 + 1 >= 0) & (x0 + 1 <= w - 1)

    def corner(yi, xi, valid, wgt):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        v = torch.gather(flat, 1, idx).reshape(*ys.shape, c)
        return v * ((valid & inrange).to(x.dtype) * wgt)[..., None]

    return (corner(y0c, x0c, vy0 & vx0, (1 - ly) * (1 - lx)) + corner(y0c, x1c, vy0 & vx1, (1 - ly) * lx)
            + corner(y1c, x0c, vy1 & vx0, ly * (1 - lx)) + corner(y1c, x1c, vy1 & vx1, ly * lx))


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *, stride: int = 1, dilation: int = 1,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, Cin, H, W]; offsets [B, 2K, Ho, Wo], per tap (dy, dx) in the
    CUDA tap-major order [k0_dy, k0_dx, k1_dy, ...]; weight [Cout, Cin, kh,
    kw] (square kernel, K = kh*kw); mask [B, K, Ho, Wo] (v2) or None (v1)
    -> [B, Cout, Ho, Wo], padding dilation*(kh-1)//2."""
    cout, cin, kh, kw = weight.shape
    if kh != kw:
        raise ValueError(f"deform_conv2d: square kernels only, got {kh}x{kw}")
    k = kh * kw
    b, _, ho, wo = offsets.shape
    pad = dilation * (kh - 1) // 2
    dev, dt = x.device, offsets.dtype
    base_y = (torch.arange(ho, device=dev, dtype=dt) * stride - pad)[:, None, None]
    base_x = (torch.arange(wo, device=dev, dtype=dt) * stride - pad)[None, :, None]
    taps = torch.arange(kh, device=dev, dtype=dt) * dilation
    tap_dy = taps.repeat_interleave(kw)[None, None, :]
    tap_dx = taps.repeat(kh)[None, None, :]
    off = offsets.reshape(b, k, 2, ho, wo).permute(0, 3, 4, 1, 2)  # [B, Ho, Wo, K, 2]
    ys = base_y + tap_dy + off[..., 0]
    xs = base_x + tap_dx + off[..., 1]
    sampled = _bilinear_gather(x, ys, xs)  # [B, Ho, Wo, K, Cin]
    if mask is not None:
        sampled = sampled * mask.permute(0, 2, 3, 1)[..., None]
    wmat = weight.permute(0, 2, 3, 1).reshape(cout, k, cin)
    out = torch.einsum("bhwkc,okc->bohw", sampled, wmat.to(sampled.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out
