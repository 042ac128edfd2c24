"""CenterNet-S4 over DLA-34-DCN's FLOPs per image, counted by
``FlopCounterMode`` on its plain reference (``reference/onestage_dla.py``)
at the cell's shapes, so that the count is the same whatever implements the
model.

Counted: every convolution and matrix product of the network (DLA-34, the
offset convs, the deformable convs' contraction, a product a tap, the
head). Not counted: the resize of the frames to the canvas, outside the
count as in ``flops.py``; the deformable convs' bilinear gathers, the
upsampling and the elementwise work, which FlopCounterMode does not see.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.serving import preprocess


def per_image(reference, frames: torch.Tensor) -> float:
    """reference: a ``reference.onestage_dla.Reference``; frames uint8 [B, 3, H, W]."""
    canvases = preprocess(frames, reference.m)  # outside the count
    with FlopCounterMode(display=False) as counter:
        reference.detect(*canvases)
    return float(sum(counter.get_flop_counts().get("Global", {}).values())) / frames.shape[0]
