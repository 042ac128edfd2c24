"""The AttentionRPN baseline's FLOPs per image, counted by
``FlopCounterMode`` on its plain reference (``reference/fsod_rcnn.py``) at
the cell's shapes, so that the count is the same whatever implements the
model.

Counted: every convolution and matrix product of the network (ResNet-50 to
res4, the attention RPN and its head, res5 on every proposal, the relation
head). Not counted, as ``flops.py`` leaves them out: the resize of the
frames to the canvas and ROIAlign, whose reference computes both as
products with dense matrices of interpolation weights (work that a gather
does without), and the elementwise work, which FlopCounterMode does not see.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.serving import preprocess


def per_image(reference, frames: torch.Tensor) -> float:
    """reference: a ``reference.fsod_rcnn.Reference``; frames uint8 [B, 3, H, W]."""
    canvases = preprocess(frames, {"input": reference.input})  # outside the count
    with FlopCounterMode(display=False) as counter:
        reference.detect(*canvases)
    counts = counter.get_flop_counts()
    total = sum(counts.get("Global", {}).values())
    pooled = sum(counts.get("RoiPool", {}).values())  # the reference's ROIAlign module, by its class
    return float(total - pooled) / frames.shape[0]
