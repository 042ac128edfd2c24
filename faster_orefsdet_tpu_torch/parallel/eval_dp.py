"""Data-parallel evaluation: the eval set's batches sharded over a mesh
(counterpart of ``faster_orefsdet_tpu/parallel/eval_dp.py``).

The reference splits the eval image list across its GPUs and gathers the
results on rank 0. Here one process copies each device's share of a batch
of raw uint8 canvases to its pinned replica of the batched query path
(``build_pinned_inference_fn``: one CUDA graph on each card, the support
cache fixed in it) and replays them all, then reads the detections back
and feeds the evaluator, as ``pipelines.evaluate`` does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.coco import ImageRecord
from ..data.loader import Imread, eval_canvas, eval_loader
from ..evaluation import COCOEvaluator
from ..pipelines.evaluate import add_image
from ..pipelines.inference import build_pinned_inference_fn
from ..pipelines.support_cache import SupportCache
from ..utils.device import resolve_device
from .mesh import Mesh


def evaluate_sharded(cfg: Config, params: Mapping[str, torch.Tensor], cache: SupportCache,
                     records: Sequence[ImageRecord], mesh: Mesh, canvas_hw: Optional[Tuple[int, int]] = None,
                     per_device_batch: int = 4, *, imread: Optional[Imread] = None,
                     act_scales: Optional[Mapping[str, float]] = None) -> Dict[str, float]:
    """The COCO AP table of `records` (``pipelines.evaluate.evaluate``'s
    keys, without its timings), with batches of mesh.size x
    per_device_batch raw uint8 canvases split over the mesh's devices. A
    short last batch repeats its last image. act_scales as the builders
    take them (required by the static int8 presets)."""
    canvas_hw = canvas_hw or eval_canvas(records, cfg)
    # each device resolved (refused without a card) before the cache is copied there
    replicas = [build_pinned_inference_fn(cfg, params, cache.to(dev), device=dev, act_scales=act_scales)
                for dev in map(resolve_device, mesh.devices)]
    full = mesh.size * per_device_batch
    evaluator = COCOEvaluator()
    pending: List = []

    def flush():
        k = len(pending)
        while len(pending) % full:  # pad to a whole mesh batch
            pending.append(pending[-1])
        canvases = torch.stack([p[1] for p in pending])
        hws = torch.tensor([[float(p[2][0]), float(p[2][1])] for p in pending], dtype=torch.float32)
        if mesh.devices[0].type == "cuda":  # pinned host memory: each card's copy is asynchronous
            canvases, hws = canvases.pin_memory(), hws.pin_memory()
        dets = [infer(imgs, hw) for infer, imgs, hw in zip(replicas, canvases.chunk(mesh.size), hws.chunk(mesh.size))]
        boxes, scores, valid = (np.concatenate([getattr(d, f).cpu().numpy() for d in dets])
                                for f in ("boxes", "scores", "valid"))
        for i in range(k):
            rec, _, _, scale = pending[i]
            add_image(evaluator, rec, boxes[i], scores[i], valid[i], scale)
        pending.clear()

    for item in eval_loader(records, cfg, canvas_hw, raw_uint8=True, imread=imread):
        pending.append(item)
        if len(pending) == full:
            flush()
    if pending:
        flush()
    return evaluator.evaluate()
