"""Federated-loss class sampling and the sigmoid cross-entropy
classification loss (counterpart of ``faster_orefsdet_tpu/ops/fed_loss.py``).
Off in every shipped ore config; part of the predictor's multi-class
surface.

The class set has a fixed size: a Gumbel top-k over the classes that did
not appear, weighted by their frequency, with the appeared classes forced
in. ``fed_loss_mask_from_uniforms`` is the pure function of the uniform
draws, so the same draws give the same mask in both packages."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def load_class_freq(path: str, freq_weight: float = 0.5) -> torch.Tensor:
    """[C] image_count ** freq_weight per class (sorted by category id), f32."""
    with open(path) as f:
        cat_info = json.load(f)
    counts = np.asarray([c["image_count"] for c in sorted(cat_info, key=lambda x: x["id"])], np.float32)
    return torch.from_numpy(counts ** np.float32(freq_weight))


def fed_loss_mask_from_uniforms(u: torch.Tensor, gt_classes: torch.Tensor, num_classes: int,
                                num_sample_cats: int = 50, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C] bool mask of the classes in the federated loss, given uniforms u
    [C]: every appeared class, then the classes of the largest
    log(weight) + Gumbel(u) up to num_sample_cats (ties by index)."""
    c = num_classes
    appeared = torch.zeros(c + 1, dtype=torch.bool, device=u.device)
    appeared[gt_classes.long().clamp(0, c)] = True
    appeared = appeared[:c]
    w = torch.ones(c, device=u.device) if weight is None else weight.to(u.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    score = torch.where(appeared, torch.full_like(g, float("inf")), torch.log(w.clamp(min=1e-12)) + g)
    rank = torch.argsort(torch.argsort(-score, stable=True), stable=True)
    return (rank < min(num_sample_cats, c)) | appeared


def fed_loss_class_mask(gt_classes: torch.Tensor, num_classes: int, num_sample_cats: int = 50,
                        weight: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[C] bool mask of the classes in the federated loss: all appeared
    classes plus weighted random extras up to num_sample_cats, the uniforms
    drawn from `generator` on gt_classes' device."""
    u = torch.rand(num_classes, generator=generator, device=gt_classes.device)
    return fed_loss_mask_from_uniforms(u, gt_classes, num_classes, num_sample_cats, weight)


def sigmoid_cross_entropy_loss(scores: torch.Tensor, gt_classes: torch.Tensor, valid: torch.Tensor,
                               class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE over the C foreground columns of scores [R, C+1] (background is
    the all-zero target), over the valid rows [R], summed and divided by
    their count (at least 1); optionally only the classes of class_mask."""
    c = scores.shape[1] - 1
    fg = scores[:, :c]
    target = F.one_hot(gt_classes.long(), c + 1)[:, :c].to(fg.dtype)
    loss = fg.clamp(min=0) - fg * target + torch.log1p(torch.exp(-fg.abs()))
    if class_mask is not None:
        loss = loss * class_mask[None, :].to(loss.dtype)
    loss = torch.where(valid[:, None], loss, torch.zeros((), dtype=loss.dtype, device=loss.device))
    return loss.sum() / valid.sum().clamp(min=1)
