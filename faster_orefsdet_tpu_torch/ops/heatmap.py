"""CenterNet grid geometry (counterpart of the inference half of
``faster_orefsdet_tpu/ops/heatmap.py``; target rendering is training)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..utils.device import device_constant


def level_grid_shapes(canvas_hw: Tuple[int, int], strides: Sequence[int]):
    """[(h_l, w_l)] for each stride of a canvas padded to divisibility."""
    h, w = canvas_hw
    return [(h // s, w // s) for s in strides]


@device_constant
def compute_grids(canvas_hw: Tuple[int, int], strides: Tuple[int, ...]) -> np.ndarray:
    """Concatenated [M, 2] grid-point (x, y) image coords: per level
    (j * stride, i * stride) + stride // 2, row-major. A constant on
    `device=`, made once per (canvas, strides, device)."""
    out = []
    for (hl, wl), s in zip(level_grid_shapes(canvas_hw, strides), strides):
        xs = np.arange(wl, dtype=np.float32) * s + s // 2
        ys = np.arange(hl, dtype=np.float32) * s + s // 2
        gx, gy = np.meshgrid(xs, ys)
        out.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1))
    return np.concatenate(out, axis=0)
