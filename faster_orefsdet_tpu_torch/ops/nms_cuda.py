"""NMS over a batch of fixed-K box sets: the CUDA kernel ``csrc/nms.cu`` and
its plain twin (counterpart of ``faster_orefsdet_tpu/ops/pallas_nms.py``).

``nms_mask`` dispatches on the tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain fixpoint ``ops.nms.nms_mask``.
"""

from __future__ import annotations

import functools

import torch

from . import _native
from .nms import class_offset_boxes, nms_mask as nms_mask_plain


class _Counter:
    """Kernel launches made by `nms_mask`: one per call on CUDA tensors, which
    runs csrc/nms.cu's rank, mask and sweep kernels in turn."""

    launches = 0


counter = _Counter()


def nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy NMS keep mask. boxes [B,K,4] f32, scores [B,K] f32, valid [B,K]
    bool -> keep [B,K] bool (same semantics as ops.nms.nms_mask)."""
    if boxes.is_cuda:
        return _launch(boxes, scores, valid, float(iou_threshold))
    if boxes.device.type != "cpu":
        raise ValueError(f"nms_mask: tensors on {boxes.device} (expected cuda or cpu)")
    return nms_mask_plain(boxes, scores, valid, iou_threshold)


def batched_nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Class-aware NMS keep mask (counterpart of ``batched_nms_mask_pallas``):
    ``nms_mask`` on the class-offset boxes, so CUDA tensors go through the
    kernel and CPU tensors through the plain fixpoint. boxes [B,K,4], scores
    [B,K], classes [B,K], valid [B,K] -> keep [B,K]. On CUDA there is no
    fallback: a K whose workspace the card cannot hold raises."""
    if boxes.shape[-2] == 0:
        return valid.bool()
    shifted = class_offset_boxes(boxes, classes, valid).contiguous()
    return nms_mask(shifted, scores.contiguous(), valid.contiguous(), iou_threshold)


def _launch(boxes, scores, valid, thr: float) -> torch.Tensor:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_mask: boxes must be [B,K,4], got {tuple(boxes.shape)}")
    b, k = boxes.shape[:2]
    for name, t, shape, dtype in (
        ("boxes", boxes, (b, k, 4), torch.float32),
        ("scores", scores, (b, k), torch.float32),
        ("valid", valid, (b, k), torch.bool),
    ):
        if t.device != boxes.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"nms_mask: {name} must be {dtype} {shape} on {boxes.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"nms_mask: {name} must be contiguous")
    lib = _native.library("nms")
    # one scratch buffer for the rank-order boxes, ranks and suppression rows
    # (B*K*ceil(K/64) u64 words above K = 2048: 32 MiB an image at K = 16384)
    nbytes = _workspace_bytes(b, k)
    try:
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=boxes.device)
    except torch.cuda.OutOfMemoryError as e:
        raise ValueError(f"nms_mask: [{b}, {k}] boxes need a {nbytes}-byte workspace (their suppression "
                         f"mask), more than {boxes.device} can allocate") from e
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.get_device()):  # the runtime launches on its current device
        rc = lib.nms_forward(
            boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), thr, b, k,
            workspace.data_ptr(), keep.data_ptr(), torch.cuda.current_stream(boxes.device).cuda_stream,
        )
    _native.check(lib, rc, "nms_mask")
    counter.launches += 1
    return keep


@functools.lru_cache(maxsize=None)
def _workspace_bytes(b: int, k: int) -> int:
    return _native.library("nms").nms_workspace_bytes(b, k)
