"""Seeded random weights for the AttentionRPN baseline (FsodRCNN over
ResNet-50 C4), whose parameter names the CenterNet2 rules of ``weights.py``
do not cover: one normal draw for every leaf at once on the run's device,
cut into the leaves, each then scaled by its kind. Both the program and the
reference are given these tensors.

The trunk (ResNet-50 to res4, res5) and the support and attention linears
are N(0, 1/fan_in), the stem's besides over 64, the spread of a pixel: the
frames are normalized by a pixel std of 1, so they reach the stem on the
0-255 scale, and without it every map downstream would be 64 times larger
(as the program's own ``utils.params.init_baseline_params`` does).
FrozenBN and LayerNorm scales are near 1, other biases near 0. The heads
take their published initialization, detectron2's StandardRPNHead (convs
N(0, 0.01^2), biases 0) and FsodFastRCNNOutputLayers (the relation layers
N(0, 0.01^2), the box layer N(0, 0.001^2), biases 0), except the three
score layers, which are drawn at N(0, 1e-4^2), 1e-2 below their published
deviation, as the program's own tests of this model draw them: at the
published deviation the local relation's score, a sum over 49 positions and
1024 channels divided by 0.1, puts foreground logits some 200 apart on these
random trunks, so every probability is 0 or 1 and a wrong score would not
show.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

PIXEL_SPREAD = 64.0
# the first prefix that a name starts with gives its deviation
HEAD_STD = {"rpn_head_mod.": 0.01, "relation_head.bbox_pred_cor.": 1e-3, "relation_head.cls_score_": 1e-4,
            "relation_head.": 0.01}


def seeded_state_dict(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """template: FsodRCNN's state_dict (only names and shapes are read)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    names = list(template)
    sizes = [template[k].numel() for k in names]
    noise = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out = {}
    for key, part in zip(names, torch.split(noise, sizes)):
        shape = tuple(template[key].shape)
        n = part.view(shape)
        leaf = key.rsplit(".", 1)[-1]
        head = next((std for prefix, std in HEAD_STD.items() if key.startswith(prefix)), None)
        if key.endswith(("norm.scale", "ln.scale")):
            v = 1.0 + 0.1 * n
        elif head is not None:
            v = head * n if leaf == "weight" else torch.zeros_like(n)
        elif leaf == "weight":
            v = n / math.sqrt(math.prod(shape[1:]))
            if key == "backbone.stem.conv.weight":
                v = v / PIXEL_SPREAD
        else:
            v = 0.1 * n
        out[key] = v
    return out
