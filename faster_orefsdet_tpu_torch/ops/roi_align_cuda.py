"""ROIAlignV2 by gathering: the CUDA kernel ``csrc/roi_align.cu`` (K3), its
plain version and the ROI poolers that route to it.

``roi_align_gather`` pools each box once, at its own level, straight from
the maps: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the dense composition of ``ops.roi_align`` (``roi_align_plain``), whose
results it keeps bit for bit. The kernel has no backward, so with grad mode
on, inputs that require grad are refused on both devices.

The poolers (``multilevel_roi_pool``, ``roi_pool``) are what the model and
pipelines call: the gather where nothing needs a gradient, the dense,
differentiable composition (``roi_align_plain``) where grad mode is on and
the features or boxes require grad (training). The level of each box is
``assign_levels``, in torch, on both routes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from . import _native
from .roi_align import assign_levels, pool_at_levels, roi_align


class _Counter:
    """`launches`: kernel launches made by `roi_align_gather` (one per call
    on CUDA). `dense_calls`: pooler calls on CUDA tensors routed to the dense
    composition because an input needs a gradient."""

    launches = 0
    dense_calls = 0


counter = _Counter()


def _needs_grad(features: Sequence[torch.Tensor], boxes: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (boxes.requires_grad or any(f.requires_grad for f in features))


def roi_align_plain(features: Sequence[torch.Tensor], boxes: torch.Tensor, levels: Optional[torch.Tensor],
                    scales: Sequence[float], output_size: int, sampling_ratio: int = 0) -> torch.Tensor:
    """The dense composition of what `roi_align_gather` computes: one level's
    `roi_align` (levels None), or every level pooled and each box's kept."""
    if levels is None:
        return roi_align(features[0], boxes, scales[0], output_size, sampling_ratio)
    return pool_at_levels(features, boxes, levels, scales, output_size, sampling_ratio)


def roi_align_gather(features: Sequence[torch.Tensor], boxes: torch.Tensor, levels: Optional[torch.Tensor],
                     scales: Sequence[float], output_size: int, sampling_ratio: int = 0) -> torch.Tensor:
    """ROIAlignV2 (aligned) of each box at its own level. features: L maps
    [B, C, H_l, W_l] of one dtype (f32 or bf16 on CUDA, C a multiple of 16
    bytes; channel-last memory is read in place, NCHW is copied to it once); boxes [B, R, 4] xyxy image
    coordinates (f32, contiguous); levels [B, R] int32 indices into
    `features` (None with one level); scales[l] the spatial scale of level l
    -> [B, R, P, P, C] in the features' dtype, P = output_size.
    sampling_ratio 0 is adaptive (ops/roi_align.py). Raises when grad mode
    is on and an input requires grad: the kernel's result would carry no
    gradient."""
    if _needs_grad(features, boxes):
        raise RuntimeError("roi_align_gather has no backward: inputs that require grad are refused (run it "
                           "under torch.no_grad / inference_mode, or pool through multilevel_roi_pool / "
                           "roi_pool, which take the dense composition for them)")
    _check(features, boxes, levels, scales, output_size, sampling_ratio)
    if boxes.is_cuda:
        return _launch(features, boxes, levels, scales, output_size, sampling_ratio)
    if boxes.device.type != "cpu":
        raise ValueError(f"roi_align_gather: boxes on {boxes.device} (expected cuda or cpu)")
    return roi_align_plain(features, boxes, levels, scales, output_size, sampling_ratio)


def multilevel_roi_pool(features: Sequence[torch.Tensor], boxes: torch.Tensor, strides: Sequence[int],
                        output_size: int, sampling_ratio: int = 2, canonical_box_size: int = 224,
                        canonical_level: int = 4) -> torch.Tensor:
    """The FPN ROIPooler (arguments and result as ``multilevel_roi_align``):
    `roi_align_gather` at each box's assigned level, or the dense
    composition where an input needs a gradient."""
    min_level = int(math.log2(strides[0]))
    levels = assign_levels(boxes, min_level, int(math.log2(strides[-1])), canonical_box_size, canonical_level)
    levels, scales = (levels - min_level).contiguous(), [1.0 / s for s in strides]
    if _needs_grad(features, boxes):
        counter.dense_calls += boxes.is_cuda
        return roi_align_plain(features, boxes, levels, scales, output_size, sampling_ratio)
    return roi_align_gather(features, boxes.float().contiguous(), levels, scales, output_size, sampling_ratio)


def roi_pool(feature: torch.Tensor, boxes: torch.Tensor, spatial_scale: float, output_size: int,
             sampling_ratio: int = 2) -> torch.Tensor:
    """One level's ROIAlignV2 (arguments and result as ``roi_align``):
    `roi_align_gather`, or the dense composition where an input needs a
    gradient."""
    if _needs_grad([feature], boxes):
        counter.dense_calls += boxes.is_cuda
        return roi_align_plain([feature], boxes, None, [spatial_scale], output_size, sampling_ratio)
    return roi_align_gather([feature], boxes.float().contiguous(), None, [spatial_scale], output_size,
                            sampling_ratio)


def _check(features, boxes, levels, scales, output_size: int, sampling_ratio: int) -> None:
    """Raise on what the kernel does not take (on the CPU too, where f64
    maps and any C are also taken: the plain version computes in f64 for
    them, and reads no vectors)."""
    n = len(features)
    if not 1 <= n <= 8 or len(scales) != n:
        raise ValueError(f"roi_align_gather: 1 to 8 levels with a scale each, got {n} maps, {len(scales)} scales")
    f0 = features[0]
    dtypes = (torch.float32, torch.bfloat16) + (() if boxes.is_cuda else (torch.float64,))
    if f0.dim() != 4 or f0.dtype not in dtypes:
        raise ValueError(f"roi_align_gather: maps must be [B, C, H, W] of {dtypes} on {boxes.device}, got "
                         f"{f0.dtype} {tuple(f0.shape)}")
    b, c = f0.shape[:2]
    if boxes.is_cuda and c * f0.element_size() % 16:
        raise ValueError(f"roi_align_gather: the kernel reads 16-byte vectors of channels: C = {c} {f0.dtype} "
                         "does not fill them")
    for f in features:
        if f.dim() != 4 or f.dtype != f0.dtype or f.device != boxes.device or tuple(f.shape[:2]) != (b, c) \
                or 0 in f.shape:
            raise ValueError(f"roi_align_gather: every map must be a non-empty {f0.dtype} [{b}, {c}, H, W] on "
                             f"{boxes.device}, got {f.dtype} {tuple(f.shape)} on {f.device}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[0] != b or boxes.shape[-1] != 4 \
            or not boxes.is_contiguous():
        raise ValueError(f"roi_align_gather: boxes must be contiguous float32 [{b}, R, 4], got {boxes.dtype} "
                         f"{tuple(boxes.shape)}")
    if levels is None and n > 1:
        raise ValueError("roi_align_gather: levels are needed with more than one map")
    if levels is not None and (levels.dtype != torch.int32 or tuple(levels.shape) != tuple(boxes.shape[:2])
                               or levels.device != boxes.device or not levels.is_contiguous()):
        raise ValueError(f"roi_align_gather: levels must be contiguous int32 {tuple(boxes.shape[:2])} on "
                         f"{boxes.device}, got {levels.dtype} {tuple(levels.shape)} on {levels.device}")
    if output_size < 1 or sampling_ratio < 0:
        raise ValueError(f"roi_align_gather: output_size {output_size}, sampling_ratio {sampling_ratio}")


def _launch(features, boxes, levels, scales, output_size: int, sampling_ratio: int) -> torch.Tensor:
    n = len(features)
    (b, c), r, dtype = features[0].shape[:2], boxes.shape[1], features[0].dtype
    out = torch.empty((b, r, output_size, output_size, c), dtype=dtype, device=boxes.device)
    if b * r == 0:
        return out
    # channel-last [B, H, W, C]: no copy for channels_last memory, unless a
    # view starts off the 16-byte vectors the kernel reads
    maps = [f.permute(0, 2, 3, 1).contiguous() for f in features]
    maps = [m if m.data_ptr() % 16 == 0 else m.clone() for m in maps]
    lib = _native.library("roi_align")
    with torch.cuda.device(boxes.get_device()):  # the runtime launches on its current device
        rc = lib.roi_align_forward(
            (ctypes.c_void_p * n)(*(m.data_ptr() for m in maps)),
            (ctypes.c_int * n)(*(m.shape[1] for m in maps)), (ctypes.c_int * n)(*(m.shape[2] for m in maps)),
            (ctypes.c_float * n)(*scales), n, int(dtype == torch.bfloat16), boxes.data_ptr(),
            None if levels is None else levels.data_ptr(), out.data_ptr(), b, r, c, output_size, sampling_ratio,
            torch.cuda.current_stream(boxes.device).cuda_stream,
        )
    _native.check(lib, rc, "roi_align_gather")
    counter.launches += 1
    return out
