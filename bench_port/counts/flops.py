"""The model's FLOPs per image, counted by ``FlopCounterMode`` on the plain
reference at the cell's shapes, so that the count is the same whatever
implements the model.

Counted: every convolution and matrix product of the network (backbone,
neck, support refinement, the CGM projection, heads, the DSA stage).
Not counted: the resize of the frames to the canvas and ROIAlign, whose
reference computes both as products with dense matrices of interpolation
weights (work that a gather does without), and the elementwise work, which
FlopCounterMode does not see.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.serving import preprocess


def per_image(reference, frames: torch.Tensor) -> float:
    """reference: a ``reference.serving.Reference``; frames uint8 [B, 3, H, W]."""
    canvases = preprocess(frames, reference.m)  # outside the count
    with FlopCounterMode(display=False) as counter:
        reference.detect(*canvases)
    counts = counter.get_flop_counts()
    total = sum(counts.get("Global", {}).values())
    pooled = sum(counts.get("RoiPool", {}).values())  # the reference's ROIAlign module, by its class
    return float(total - pooled) / frames.shape[0]
