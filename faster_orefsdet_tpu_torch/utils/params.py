"""Weights for the port: seeded random initialization, and the bridge from
the JAX package's flax parameter tree (counterpart of
``faster_orefsdet_tpu/utils/params.py``).

The port's modules carry the flax tree's names, so a flax path
``a/b/kernel`` is the state_dict key ``a.b.weight`` and every other leaf
keeps its name. Layout changes: conv kernels HWIO -> OIHW, dense kernels
[I, O] -> Linear [O, I]. FrozenBN is the folded affine (``scale``, ``bias``)
in both. The ROI head's fc1 needs no permutation: the port flattens the
pooled features in HWC order, as the JAX package does. A trainable
BatchNorm's running statistics, the flax ``batch_stats`` collection
(``.../bn/mean``, ``.../bn/var``), are the buffers of the same names.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import Config
from ..models.attention_rpn import FsodRCNN
from ..models.detector import CenterNet2Detector
from ..pipelines.onestage import OneStageCenterNet


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


BATCH_STATS = ("mean", "var")  # the leaves of a flax BatchNorm's batch_stats


def is_batch_stat(key: str) -> bool:
    """Whether a state_dict key is a running statistic (a batch_stats leaf)."""
    return key.rsplit(".", 1)[-1] in BATCH_STATS


def from_jax_params(tree: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``params`` tree (nested dicts of numpy arrays),
    and its ``batch_stats`` tree when the model has one, -> the port's
    CenterNet2Detector state_dict (f32 CPU tensors)."""
    sd = {}
    for key, arr in {**_flatten(tree), **_flatten(batch_stats or {})}.items():
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
    numpy arrays in its layouts), without the running statistics."""
    return _to_tree({k: v for k, v in state_dict.items() if not is_batch_stat(k)})


def to_jax_batch_stats(state_dict: Mapping[str, torch.Tensor]) -> Optional[Dict]:
    """The state_dict's running statistics as the flax ``batch_stats`` tree,
    or None when the model has none (as the JAX package's train state)."""
    stats = {k: v for k, v in state_dict.items() if is_batch_stat(k)}
    return _to_tree(stats) if stats else None


def _to_tree(state_dict: Mapping[str, torch.Tensor]) -> Dict:
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
    so that activations stay O(1) through the deep chain; norm scales and
    BiFPN fusion weights are near 1, running means 0 and variances 1; the
    heatmap bias sits at a low prior and the box bias at 8 strides."""
    return seeded_init(CenterNet2Detector(cfg).state_dict(), seed, cfg.centernet.prior_prob)


def init_onestage_params(cfg: Config, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights for the one-stage detector of `cfg`
    (``pipelines.onestage.OneStageCenterNet``), drawn as ``init_params``
    draws them: the class logits' bias sits at the heatmap's low prior too."""
    return seeded_init(OneStageCenterNet(cfg).state_dict(), seed, cfg.centernet.prior_prob)


def seeded_init(template: Mapping[str, torch.Tensor], seed: int = 0,
                prior_prob: float = 0.01) -> Dict[str, torch.Tensor]:
    """Seeded random values for a state_dict's keys, as ``init_params``
    draws them (any module of the port: a backbone of the zoo, an attention
    block), the heads' heatmap and class biases at `prior_prob`."""
    g = np.random.default_rng(seed)
    prior_bias = -math.log((1.0 - prior_prob) / prior_prob)
    sd = {}
    for key, t in template.items():
        shape = tuple(t.shape)
        noise = g.standard_normal(shape).astype(np.float32)
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith(("norm.scale", "gn.scale", "bn.scale")) or leaf.startswith("weights_f"):
            v = 1.0 + 0.1 * noise
        elif leaf == "mean":
            v = np.zeros(shape, np.float32)
        elif leaf == "var":
            v = np.ones(shape, np.float32)
        elif key.startswith("head.scale"):
            v = np.ones(shape, np.float32)
        elif key in ("head.agn_hm.bias", "head.cls_logits.bias"):
            v = prior_bias + 0.1 * noise
        elif key == "head.bbox_pred.bias":
            v = 8.0 + 0.1 * noise
        elif leaf == "weight":
            v = noise / np.sqrt(np.prod(shape[1:]))
        else:
            v = 0.1 * noise
        sd[key] = torch.from_numpy(np.asarray(v, dtype=np.float32))
    return sd


# the baseline's layers that the JAX package initializes at N(0, 0.01^2)
# rather than by fan-in; the score and box layers smaller still, so that a
# random model's foreground probabilities stay below 1 and its boxes are not
# clipped to lines (its ResNet's activations are larger than the JAX
# init's)
_BASELINE_SMALL_STD = {"rpn_head_mod.": 0.01, "relation_head.conv_1.": 0.01, "relation_head.cls_score_": 1e-4,
                       "relation_head.adapt_": 0.01, "relation_head.bbox_pred_cor.": 1e-4}


# the spread of a pixel on the 0-255 scale: the baseline's images are
# normalized by PIXEL_STD 1, so its stem's fan-in init is divided by it
_PIXEL_SPREAD = 64.0


def init_baseline_params(depth: int = 50, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights for the AttentionRPN baseline (``FsodRCNN``) as
    a state_dict (f32 CPU tensors, the same numbers on any machine): weights
    N(0, 1/fan_in) (the stem's over _PIXEL_SPREAD as well, so that the res4
    maps of 0-255-scale images stay O(1) and the RPN's boxes do not collapse),
    except the RPN head and the relation head's layers at small deviations
    (``_BASELINE_SMALL_STD``); FrozenBN and LayerNorm scales near 1; other
    biases small."""
    g = np.random.default_rng(seed)
    sd = {}
    for key, t in FsodRCNN(depth=depth).state_dict().items():
        shape = tuple(t.shape)
        noise = g.standard_normal(shape).astype(np.float32)
        small = next((std for prefix, std in _BASELINE_SMALL_STD.items() if key.startswith(prefix)), None)
        if key.endswith(("norm.scale", "ln.scale")):
            v = 1.0 + 0.1 * noise
        elif key.endswith(".weight"):
            v = noise * small if small is not None else noise / np.sqrt(np.prod(shape[1:]))
            if key == "backbone.stem.conv.weight":
                v = v / _PIXEL_SPREAD
        else:
            v = 0.1 * noise
        sd[key] = torch.from_numpy(np.asarray(v, dtype=np.float32))
    return sd
