"""Fused CGM correlation + conv3 projection: the CUDA kernel ``csrc/cgm.cu``
and its plain twin (counterpart of ``faster_orefsdet_tpu/ops/pallas_cgm.py``).

``cgm_correlate_fused`` dispatches on the device of q: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs ``cgm_fused_plain``. The
kernel has no backward, as the JAX package never differentiates its Pallas
CGM: with grad mode on, inputs that require grad are refused on both
devices (training runs the differentiable composition instead).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _native
from .correlation import cgm_correlate


class _Counter:
    """Kernel launches made by `cgm_correlate_fused` (one per call on CUDA)."""

    launches = 0


counter = _Counter()


def cgm_fused_plain(q, k1, k13, k31, w3, b3, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """relu(concat(cgm_correlate(q), q) @ w3.T + b3), computed in f32 and
    rounded once to `out_dtype` (default q's dtype). q [B,H,W,C]; k1 [C];
    k13/k31 [3,C]; w3 [C,2C] (nn.Linear's weight, columns [attn; q]); b3 [C]."""
    qf = q.float()
    corr = cgm_correlate(qf, k1.float(), k13.float(), k31.float())
    cat = torch.cat([corr, qf], dim=-1)
    return torch.relu(cat @ w3.float().t() + b3.float()).to(out_dtype or q.dtype)


def cgm_correlate_fused(q, k1, k13, k31, w3, b3, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused CGM for one level over the batch: q [B,H,W,C] (any C >= 1; f32
    or bf16, channel-last contiguous) -> [B,H,W,C] in `out_dtype` (f32 or bf16,
    default q's dtype). Taps and weights as in `cgm_fused_plain`, f32 and
    contiguous on the CUDA path. Raises when grad mode is on and an input
    requires grad: the kernel's result would carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k1, k13, k31, w3, b3)):
        raise RuntimeError("cgm_correlate_fused has no backward: inputs that require grad are refused "
                           "(run it under torch.no_grad / inference_mode, or train through the "
                           "composition that CenterNet2Detector.correlate runs without cfg.use_pallas_cgm)")
    if q.is_cuda:
        return _launch(q, k1, k13, k31, w3, b3, out_dtype or q.dtype)
    if q.device.type != "cpu":
        raise ValueError(f"cgm_correlate_fused: q on {q.device} (expected cuda or cpu)")
    return cgm_fused_plain(q, k1, k13, k31, w3, b3, out_dtype)


def _launch(q, k1, k13, k31, w3, b3, out_dtype) -> torch.Tensor:
    if q.dim() != 4 or 0 in q.shape:
        raise ValueError(f"cgm_correlate_fused: q must be a non-empty [B,H,W,C], got {tuple(q.shape)}")
    floats = (torch.float32, torch.bfloat16)
    if q.dtype not in floats or out_dtype not in floats:
        raise ValueError(f"cgm_correlate_fused: q and out must be f32 or bf16, got {q.dtype}, {out_dtype}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("cgm_correlate_fused: q must be contiguous [B,H,W,C] (channels-last map), "
                         "16-byte aligned")
    b, h, w, c = q.shape
    for name, t, shape in (
        ("k1", k1, (c,)), ("k13", k13, (3, c)), ("k31", k31, (3, c)), ("w3", w3, (c, 2 * c)),
        ("b3", b3, (c,)),
    ):
        if t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"cgm_correlate_fused: {name} must be float32 {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"cgm_correlate_fused: {name} must be contiguous and 16-byte aligned")
    out = torch.empty((b, h, w, c), dtype=out_dtype, device=q.device)
    lib = _native.library("cgm")
    with torch.cuda.device(q.get_device()):  # the runtime launches on its current device
        rc = lib.cgm_forward(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k1.data_ptr(), k13.data_ptr(),
            k31.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), b, h, w, c,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _native.check(lib, rc, "cgm_correlate_fused")
    counter.launches += 1
    return out
