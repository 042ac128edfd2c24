"""Support feature cache (counterpart of
``faster_orefsdet_tpu/pipelines/support_cache.py``).

Fields keep the JAX package's layout and ``.npz`` keys, so a cache written by
either package loads in the other:
  p3/p4/p5:      shot-mean SM-refined, spatially transposed maps [S, S, C]
  rcnn_8/rcnn_4: shot-mean 8x8 / 4x4 multilevel ROI pools [P, P, C]
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..config import Config
from ..models.cascade_roi import ROI_STRIDES
from ..models.detector import CenterNet2Detector
from ..ops.roi_align import multilevel_roi_align
from ..utils.device import resolve_device


class SupportCache(NamedTuple):
    p3: torch.Tensor  # [32, 32, C]
    p4: torch.Tensor  # [16, 16, C]
    p5: torch.Tensor  # [8, 8, C]
    rcnn_8: torch.Tensor  # [8, 8, C]
    rcnn_4: torch.Tensor  # [4, 4, C]

    def to(self, device) -> "SupportCache":
        return SupportCache(*(t.to(device) for t in self))


@torch.inference_mode()
def support_cache_from_model(model: CenterNet2Detector, support_images: torch.Tensor,
                             support_boxes: torch.Tensor) -> SupportCache:
    """support_images [K, 3, Hs, Ws] normalized (240 px crops on a 256 canvas);
    support_boxes [K, 4] xyxy crop coords; both on the model's device."""
    cfg = model.cfg
    feats = model.features(support_images)
    refined = model.refine_support(feats)
    levels = [feats[level] for level in ("p3", "p4", "p5")]
    boxes = support_boxes.float()[:, None, :]  # one box per shot image

    def pool(size):
        return multilevel_roi_align(
            levels, boxes, ROI_STRIDES, size, cfg.roi.pooler_sampling_ratio,
            cfg.roi.canonical_box_size, cfg.roi.canonical_level,
        )[:, 0].mean(dim=0)

    return SupportCache(
        p3=refined["p3"].mean(dim=0),
        p4=refined["p4"].mean(dim=0),
        p5=refined["p5"].mean(dim=0),
        rcnn_8=pool(cfg.roi.pooler_resolution),
        rcnn_4=pool(cfg.roi.pooler_resolution2),
    )


def build_support_cache(cfg: Config, params: Mapping[str, torch.Tensor],
                        support_images: torch.Tensor, support_boxes: torch.Tensor,
                        *, device="cuda") -> SupportCache:
    """Build the detector of `cfg` with `params` (a state_dict) on `device`
    and encode the K support shots into a SupportCache on that device."""
    from .inference import make_detector

    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device
    return support_cache_from_model(model, support_images.to(dev), support_boxes.to(dev))


def stack_support_caches(caches: Sequence[SupportCache]) -> SupportCache:
    """Per-class caches stacked on a leading class axis ([N, ...] per field):
    the cache of the multiclass query path, which scores every class and runs
    NMS across them."""
    return SupportCache(*(torch.stack([getattr(c, f) for c in caches]) for f in SupportCache._fields))


def save_support_cache(path: str, cache: SupportCache) -> None:
    """Write the cache as .npz, f32 arrays under the field names."""
    np.savez(path, **{k: v.detach().float().cpu().numpy() for k, v in cache._asdict().items()})


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16" or (arr.dtype.itemsize == 2 and arr.dtype.kind == "V"):
        # bfloat16 saved by the JAX package (ml_dtypes), read with or without ml_dtypes
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def load_support_cache(path: str, device="cuda") -> SupportCache:
    """Read a cache written by either package onto `device` (the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return SupportCache(*(_to_tensor(z[k]).to(dev) for k in SupportCache._fields))
