"""Adaptive average pooling with exact torch bin semantics, as two constant
averaging matrices (counterpart of ``faster_orefsdet_tpu/ops/adaptive_pool.py``).

Output bin i averages input range [floor(i*I/O), ceil((i+1)*I/O)), which also
covers the upsampling case O > I. The matrices keep the arithmetic the JAX
package's (a weighted sum in f32), so the two agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant


@device_constant
def adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] row-stochastic averaging matrix, a constant on `device=`."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)  # ceil
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """Pool the two trailing (spatial) axes of x [..., H, W] to output_size
    (out_h, out_w); computes and returns f32 (f64 for an f64 x)."""
    out_h, out_w = output_size
    h, w = x.shape[-2], x.shape[-1]
    dt = torch.promote_types(x.dtype, torch.float32)
    ph = adaptive_pool_matrix(h, out_h, device=x.device).to(dt)
    pw = adaptive_pool_matrix(w, out_w, device=x.device).to(dt)
    x = torch.einsum("oh,...hw->...ow", ph, x.to(dt))
    return torch.einsum("pw,...ow->...op", pw, x)
