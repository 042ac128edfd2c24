"""Image preprocessing: resize-shortest-edge, normalize, pad-to-canvas
(counterpart of ``faster_orefsdet_tpu/pipelines/preprocess.py``).

Two implementations:

  - host path: a decoded frame [H, W, 3] (numpy, as an image decoder gives
    it) resized by PyTorch on the CPU, for eval and the async predictor. It
    needs no image library: bilinear without antialiasing on half-pixel
    centers is what cv2's INTER_LINEAR computes, and a uint8 frame is
    rounded back to uint8 (cv2 rounds in fixed point, so the two differ by
    under one level);
  - device path: frames [B, 3, H, W] resized on the card for raw-frame
    serving, by ``jax.image.resize``'s own weight matrices (it antialiases
    when it downscales). PyTorch's antialiased bilinear is not used: its
    CUDA and CPU kernels disagree by up to 4e-3 of a level.

The reference normalizes first and pads with zeros after, so the padding
holds 0, not -mean/std. Every frame lands on a fixed canvas (H_c, W_c), a
multiple of the size divisibility, with its resized size carried beside it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import device_constant


def resize_shortest_edge_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """d2 ResizeShortestEdge.get_output_shape: scale the shorter side to
    `short`, cap the longer side at `max_size`; round with +0.5."""
    scale = short * 1.0 / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        scale2 = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale2, neww * scale2
    return int(newh + 0.5), int(neww + 0.5)


def resize_image_host(img: np.ndarray, newh: int, neww: int) -> np.ndarray:
    """Bilinear resize of an [H, W, C] frame on the host, in f32; a uint8
    frame comes back rounded to uint8, any other as f32."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(newh, neww), mode="bilinear", align_corners=False, antialias=False)
    x = x[0].permute(1, 2, 0)
    if img.dtype == np.uint8:
        x = x.round().clamp(0, 255).to(torch.uint8)
    return x.numpy()


def normalize(img: np.ndarray, pixel_mean, pixel_std) -> np.ndarray:
    """(x - mean) / std per channel of an [H, W, 3] frame, f32, in the
    configured channel order (BGR for the reference weights)."""
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    return (img.astype(np.float32) - mean) / std


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad an [H, W, C] frame bottom and right to the canvas, keeping its
    dtype (f32 normalized, or uint8 raw for normalization on the device)."""
    h, w = img.shape[:2]
    ch, cw = canvas_hw
    if h > ch or w > cw:
        raise ValueError(f"image {h}x{w} does not fit the canvas {ch}x{cw}")
    out = np.zeros((ch, cw, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


def preprocess_host(img: np.ndarray, short: int, max_size: int, canvas_hw: Tuple[int, int],
                    pixel_mean, pixel_std):
    """Host preprocessing of one [H, W, 3] uint8 or float frame ->
    (canvas [3, Hc, Wc] f32 CPU tensor, (resized_h, resized_w),
    (h / resized_h, w / resized_w))."""
    h, w = img.shape[:2]
    newh, neww = resize_shortest_edge_size(h, w, short, max_size)
    resized = resize_image_host(img, newh, neww)
    canvas = pad_to_canvas(normalize(resized, pixel_mean, pixel_std), canvas_hw)
    return torch.from_numpy(canvas).permute(2, 0, 1), (newh, neww), (h / newh, w / neww)


def ceil_to(x: int, d: int = 32) -> int:
    """Round up to the canvas divisibility (cfg.input.size_divisibility;
    32 = the FPN stride contract and the d2 default)."""
    return -(-x // d) * d


def canvas_for(newh: int, neww: int, buckets: Sequence[Tuple[int, int]] | None = None,
               divisibility: int = 32):
    """Pick the smallest bucket fitting (newh, neww); fall back to ceil-div."""
    if buckets:
        for bh, bw in buckets:
            if newh <= bh and neww <= bw:
                return (bh, bw)
    return (ceil_to(newh, divisibility), ceil_to(neww, divisibility))


@device_constant
def pixel_stats(pixel_mean: Tuple[float, ...], pixel_std: Tuple[float, ...]) -> np.ndarray:
    """[2, 3, 1, 1] f32: the per-channel mean and std, a constant on `device=`."""
    return np.asarray([pixel_mean, pixel_std], np.float32)[:, :, None, None]


# ------------------------------------------------------------- device path

@device_constant
def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] f32 weights of ``jax.image.resize(method="linear")`` along
    one axis: a triangle kernel on half-pixel centers, widened by in/out
    when it downscales (antialiasing), each row normalized. Computed in
    f32 in JAX's order, so that the sample positions round as JAX's do. A
    constant on `device=`."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None, :]) / max(inv_scale, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


def preprocess_device(images: torch.Tensor, out_hw: Tuple[int, int], canvas_hw: Tuple[int, int],
                      pixel_mean, pixel_std) -> torch.Tensor:
    """Resize, normalize and pad on the images' device, for raw-frame
    serving: images [B, 3, H, W] uint8 or float -> normalized canvases
    [B, 3, Hc, Wc] f32 holding the frame resized to out_hw. The resize is
    the JAX package's ``jax.image.resize(method="linear")`` (antialiased
    bilinear), as two f32 matrix products with its weight matrices; the
    card and the CPU differ only in the order of the few-term sums."""
    h, w = images.shape[-2:]
    wy = linear_resize_matrix(h, out_hw[0], device=images.device)
    wx = linear_resize_matrix(w, out_hw[1], device=images.device)
    x = torch.matmul(torch.matmul(wy, images.float()), wx.t())
    mean, std = pixel_stats(tuple(pixel_mean), tuple(pixel_std), device=x.device)
    x = (x - mean) / std
    ch, cw = canvas_hw
    return F.pad(x, (0, cw - out_hw[1], 0, ch - out_hw[0]))
