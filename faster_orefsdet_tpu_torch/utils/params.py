"""Weights for the port: seeded random initialization, and the bridge from
the JAX package's flax parameter tree (counterpart of
``faster_orefsdet_tpu/utils/params.py``).

The port's modules carry the flax tree's names, so a flax path
``a/b/kernel`` is the state_dict key ``a.b.weight`` and every other leaf
keeps its name. Layout changes: conv kernels HWIO -> OIHW, dense kernels
[I, O] -> Linear [O, I]. FrozenBN is the folded affine (``scale``, ``bias``)
in both. The ROI head's fc1 needs no permutation: the port flattens the
pooled features in HWC order, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config
from ..models.detector import CenterNet2Detector


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``params`` tree (nested dicts of numpy arrays)
    -> the port's CenterNet2Detector state_dict (f32 CPU tensors)."""
    sd = {}
    for key, arr in _flatten(tree).items():
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        if key.endswith(".kernel") or key == "kernel":
            key = key[: -len("kernel")] + "weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T  # [I, O] -> [O, I]
            else:
                raise ValueError(f"{key}: kernel of rank {arr.ndim}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``from_jax_params``: a state_dict of the port's
    detector -> the JAX package's flax ``params`` tree (nested dicts of f32
    numpy arrays in its layouts)."""
    tree: Dict = {}
    for key, t in state_dict.items():
        arr = t.detach().float().cpu().numpy()
        parts = key.split(".")
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T  # OIHW -> HWIO, [O, I] -> [I, O]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree


def init_params(cfg: Config, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights for the detector of `cfg` as a state_dict (f32
    CPU tensors, the same numbers on any machine). Weights are N(0, 1/fan_in)
    so that activations stay O(1) through the deep chain; norm scales are
    near 1; the heatmap bias sits at a low prior and the box bias at 8 strides."""
    g = np.random.default_rng(seed)
    template = CenterNet2Detector(cfg).state_dict()
    prior_bias = -math.log((1.0 - cfg.centernet.prior_prob) / cfg.centernet.prior_prob)
    sd = {}
    for key, t in template.items():
        shape = tuple(t.shape)
        noise = g.standard_normal(shape).astype(np.float32)
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith(("norm.scale", "_gn.scale")):
            v = 1.0 + 0.1 * noise
        elif key.startswith("head.scale"):
            v = np.ones(shape, np.float32)
        elif key == "head.agn_hm.bias":
            v = prior_bias + 0.1 * noise
        elif key == "head.bbox_pred.bias":
            v = 8.0 + 0.1 * noise
        elif leaf == "weight":
            v = noise / np.sqrt(np.prod(shape[1:]))
        else:
            v = 0.1 * noise
        sd[key] = torch.from_numpy(np.asarray(v, dtype=np.float32))
    return sd
