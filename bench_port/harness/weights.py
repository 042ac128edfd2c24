"""Seeded random weights for a detector, made on the run's device in a few
large draws: one normal draw for every leaf at once, cut into the leaves,
each then scaled by its kind. Both the program and the reference are given
these tensors.

Backbone, neck and support weights are N(0, 1/fan_in), so that activations
stay O(1) through the deep chain; norm scales and BiFPN fusion weights are
near 1; running means near 0 and variances near 1. The heads take their
published initialization (CenterNet2's head: convs N(0, 0.01^2), the
heatmap bias at the configured prior, the box regression's at 8 strides;
detectron2's box predictor: class scores N(0, 0.01^2), box deltas
N(0, 0.001^2), biases 0), so that a random model's scores stay off 0 and 1
and its boxes stay near their proposals instead of piling up, clipped, at
the frame's edges.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def seeded_state_dict(template: Dict[str, torch.Tensor], seed: int, prior_prob: float, device) -> Dict[str, torch.Tensor]:
    """template: the detector's state_dict (only names and shapes are read)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    names = list(template)
    sizes = [template[k].numel() for k in names]
    noise = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    prior = -math.log((1.0 - prior_prob) / prior_prob)
    out = {}
    for key, part in zip(names, torch.split(noise, sizes)):
        shape = tuple(template[key].shape)
        n = part.view(shape)
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith(("norm.scale", "gn.scale", "bn.scale")) or leaf.startswith("weights_f"):
            v = 1.0 + 0.1 * n
        elif leaf == "mean":
            v = 0.1 * n
        elif leaf == "var":
            v = 1.0 + 0.1 * n.abs()
        elif key.startswith("head.scale"):
            v = torch.ones_like(n)
        elif key == "head.agn_hm.bias":
            v = prior + 0.1 * n
        elif key == "head.bbox_pred.bias":
            v = 8.0 + 0.1 * n
        elif key.startswith("head.") and leaf == "weight":
            v = 0.01 * n
        elif key.startswith("head.") and leaf == "bias" or key.startswith("roi.stage") and leaf == "bias":
            v = torch.zeros_like(n)
        elif key.startswith("roi.stage") and key.endswith("_cls.weight"):
            v = 0.01 * n
        elif key.startswith("roi.stage") and key.endswith("_bbox.weight"):
            v = 0.001 * n
        elif leaf == "weight":
            v = n / math.sqrt(math.prod(shape[1:]))
        else:
            v = 0.1 * n
        out[key] = v
    return out
