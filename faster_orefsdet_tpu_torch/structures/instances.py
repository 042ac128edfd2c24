"""Fixed-capacity, mask-valid containers (counterpart of
``faster_orefsdet_tpu/structures/instances.py``). Every field may carry a
leading batch axis; invalid slots must be masked out by consumers."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Proposals(NamedTuple):
    """boxes [..., K, 4] xyxy canvas coords; scores [..., K]; valid [..., K] bool."""

    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


class Detections(NamedTuple):
    """boxes [..., K, 4] xyxy (resized-image coords); scores [..., K];
    classes [..., K] int32; valid [..., K] bool."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


class GroundTruth(NamedTuple):
    """Fixed-N padded ground truth: boxes [..., N, 4] xyxy in the resized
    canvas frame; classes [..., N] (0 on the single-class path); valid
    [..., N] bool."""

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
