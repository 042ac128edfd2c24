"""Seeded random weights for CenterNet-S4 over DLA-34-DCN
(``reference/onestage_dla.py``), whose deformable blocks the rules of
``weights.py`` do not cover: one normal draw for every leaf at once on the
run's device, cut into the leaves, each then scaled by its kind. Both the
program and the reference are given these tensors.

- The trunk's convolutions and the deformable convs' own weights are
  N(0, 2/fan_in), so that the maps keep their scale through relu after relu
  (BatchNorm's statistics are near (0, 1) and do not rescale them) and
  their spatial variation stays a good part of their size. BatchNorm's
  affine is near (1, 0), its running statistics near (0, 1).
- The offset convs (18 offsets and 9 mask logits a position) carry their
  spread in their bias, N(0, OFFSET_BIAS^2): each tap of each block samples
  about 1-2 px off the grid (fractions of a pixel everywhere, past the map's
  edge at its borders) and each mask lies in (0, 1). Their weights are
  N(0, OFFSET_GAIN^2/fan_in), small, so that the offsets vary a little
  with the features. The source zero-initializes both, which would put
  every sample on the grid and leave the bilinear work and its border
  rules idle. Offsets drawn from the weights instead (a spread of 1-2 px
  that follows the features) make the random network chaotic: the
  sampled value moves with the offset by the map's spatial difference, so
  each of the six deformable blocks in a row amplifies a perturbation,
  and float32's own rounding then reorders the 100 best of the 2.5 M
  scored (location, class) pairs.
- The head takes CenterNet2's initialization, convs N(0, 0.01^2) and biases
  0, except two biases. The class logits' sits at the prior (0.01), spread
  by 0.1 a class: every class's scores lie near 0.01, above the score
  threshold. The box regression's sits at BOX_BIAS strides, 24 px boxes at
  stride 4, where CenterNet2 puts 8 (64 px). Boxes of one size whose
  centres lie 4 cells apart meet at IoU (64 - 16) / (64 + 16) = 0.6,
  exactly the NMS threshold, so at 8 strides a random head's answer is
  decided by rounding wherever its regression keeps that size: on an H100
  the program's class-offset NMS parted from the reference's on 22 of 320
  frames (up to 0.25 of a frame's detections), and NMS kept only 61-100 of
  the 1000 candidates. At 24 px no two cells' boxes meet within 0.07 of the
  threshold (4 px apart 0.71, 8 px 0.5, diagonal 0.53), and every frame's
  answer holds its full 100 detections. So this cell cannot show that
  fault of the class-offset NMS, float32's rounding of boxes shifted by up
  to 79 class offsets: ``tests/test_torch_onestage_dla.py`` keeps it in
  view on a planted pair.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.onestage_dla import Detector

OFFSET_BIAS = 1.5
OFFSET_GAIN = 0.1
HEAD_STD = 0.01
CLASS_BIAS_SPREAD = 0.1
BOX_BIAS = 3.0


def seeded_state_dict(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """model: the configuration's `model` (only its shapes are read)."""
    with torch.device("meta"):
        template = Detector(model).state_dict()
    g = torch.Generator(device=device).manual_seed(int(seed))
    names = list(template)
    sizes = [template[k].numel() for k in names]
    noise = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    prior_prob = model["centernet"]["prior_prob"]
    prior = -math.log((1.0 - prior_prob) / prior_prob)
    out = {}
    for key, part in zip(names, torch.split(noise, sizes)):
        shape = tuple(template[key].shape)
        n = part.view(shape)
        leaf = key.rsplit(".", 1)[-1]
        fan_in = math.prod(shape[1:])
        if key.endswith(("bn.scale", "gn.scale")):
            v = 1.0 + 0.1 * n
        elif leaf == "var":
            v = 1.0 + 0.1 * n.abs()
        elif key.startswith("head.scale"):
            v = torch.ones_like(n)
        elif key == "head.cls_logits.bias":
            v = prior + CLASS_BIAS_SPREAD * n
        elif key == "head.bbox_pred.bias":
            v = BOX_BIAS + 0.1 * n
        elif key.startswith("head.") and leaf == "weight":
            v = HEAD_STD * n
        elif key.startswith("head.") and leaf == "bias" and "_gn." not in key:
            v = torch.zeros_like(n)
        elif key.endswith("offset.weight"):
            v = OFFSET_GAIN * n / math.sqrt(fan_in)
        elif key.endswith("offset.bias"):
            v = OFFSET_BIAS * n
        elif leaf == "weight":
            v = n * math.sqrt(2.0 / fan_in)
        else:  # BatchNorm's bias and mean, GroupNorm's bias
            v = 0.1 * n
        out[key] = v
    return out
