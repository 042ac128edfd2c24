"""CGM depthwise cross-correlation as elementwise stencils on channel-last
maps (counterpart of ``faster_orefsdet_tpu/ops/correlation.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depthwise_correlate_1x1(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-channel scale: q [..., H, W, C] * k [C] (a 1x1 depthwise conv)."""
    return q * k


def _stencil3_w(q: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """3-tap stencil along W of q [..., H, W, C], zero padded:
    out[w] = sum_d q[w+d-1] * k3[d]."""
    w = q.shape[-2]
    qp = F.pad(q, (0, 0, 1, 1))
    return qp[..., 0:w, :] * k3[0] + qp[..., 1 : w + 1, :] * k3[1] + qp[..., 2 : w + 2, :] * k3[2]


def _stencil3_h(q: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """3-tap stencil along H of q [..., H, W, C], zero padded."""
    h = q.shape[-3]
    qp = F.pad(q, (0, 0, 0, 0, 1, 1))
    return (
        qp[..., 0:h, :, :] * k3[0]
        + qp[..., 1 : h + 1, :, :] * k3[1]
        + qp[..., 2 : h + 2, :, :] * k3[2]
    )


def depthwise_correlate_1x3_3x1(q: torch.Tensor, k_1x3: torch.Tensor, k_3x1: torch.Tensor) -> torch.Tensor:
    """relu(stencil_w(q, k_1x3)), then stencil_h along H (no relu on the
    output). k_1x3 / k_3x1 [3, C]: taps along W / H."""
    return _stencil3_h(torch.relu(_stencil3_w(q, k_1x3)), k_3x1)


def cgm_correlate(
    q: torch.Tensor, k_1x1: torch.Tensor, k_1x3: torch.Tensor, k_3x1: torch.Tensor
) -> torch.Tensor:
    """The per-level CGM chain before the conv3 fusion, on q [..., H, W, C]:
    relu(relu(q*k)*k) + relu(stencil_h(relu(stencil_w(q, k13)), k31)) + q.
    k_1x1 [C]; k_1x3 / k_3x1 [3, C] taps along W / H."""
    c2 = torch.relu(depthwise_correlate_1x1(torch.relu(depthwise_correlate_1x1(q, k_1x1)), k_1x1))
    d2 = torch.relu(depthwise_correlate_1x3_3x1(q, k_1x3, k_3x1))
    return c2 + d2 + q
