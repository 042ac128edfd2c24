"""Fused CGM correlation + conv3 projection: the CUDA kernel ``csrc/cgm.cu``
and its plain twin (counterpart of ``faster_orefsdet_tpu/ops/pallas_cgm.py``).

``cgm_correlate_fused`` dispatches on the device of q: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs ``cgm_fused_plain``.
"""

from __future__ import annotations

import torch

from . import _native
from .correlation import cgm_correlate

CHANNELS = 128  # the kernel's channel count (csrc/cgm.cu C)


class _Counter:
    """Kernel launches made by `cgm_correlate_fused` (one per call on CUDA)."""

    launches = 0


counter = _Counter()


def cgm_fused_plain(q, k1, k13, k31, w3, b3) -> torch.Tensor:
    """relu(concat(cgm_correlate(q), q) @ w3 + b3) in f32. q [B,H,W,C];
    k1 [C]; k13/k31 [3,C]; w3 [2C,C] (rows ordered [attn; q]); b3 [C]."""
    qf = q.float()
    corr = cgm_correlate(qf, k1.float(), k13.float(), k31.float())
    cat = torch.cat([corr, qf], dim=-1)
    return torch.relu(cat @ w3.float() + b3.float())


def cgm_correlate_fused(q, k1, k13, k31, w3, b3) -> torch.Tensor:
    """Fused CGM for one level over the batch: q [B,H,W,C] (f32 or bf16,
    channel-last contiguous) -> [B,H,W,C] f32. Taps and weights as in
    `cgm_fused_plain`, f32 and contiguous on the CUDA path."""
    if q.is_cuda:
        return _launch(q, k1, k13, k31, w3, b3)
    if q.device.type != "cpu":
        raise ValueError(f"cgm_correlate_fused: q on {q.device} (expected cuda or cpu)")
    return cgm_fused_plain(q, k1, k13, k31, w3, b3)


def _launch(q, k1, k13, k31, w3, b3) -> torch.Tensor:
    if q.dim() != 4 or q.shape[-1] != CHANNELS:
        raise ValueError(f"cgm_correlate_fused: q must be [B,H,W,{CHANNELS}], got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cgm_correlate_fused: q must be f32 or bf16, got {q.dtype}")
    if not q.is_contiguous():
        raise ValueError("cgm_correlate_fused: q must be contiguous [B,H,W,C] (channels-last map)")
    c = CHANNELS
    for name, t, shape in (
        ("k1", k1, (c,)), ("k13", k13, (3, c)), ("k31", k31, (3, c)),
        ("w3", w3, (2 * c, c)), ("b3", b3, (c,)),
    ):
        if t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"cgm_correlate_fused: {name} must be float32 {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"cgm_correlate_fused: {name} must be contiguous")
    b, h, w, _ = q.shape
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=q.device)
    lib = _native.library("cgm")
    rc = lib.cgm_forward(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k1.data_ptr(), k13.data_ptr(),
        k31.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(), b, h, w, c,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(lib, rc, "cgm_correlate_fused")
    counter.launches += 1
    return out
