"""Data-parallel serving: raw frames to detections over a mesh (counterpart
of ``faster_orefsdet_tpu/parallel/serve_dp.py``).

Serving needs no collectives, so it stays in one process: a pinned replica
of the raw-frame serving function (``pipelines.inference.
build_pinned_serving_fn``, one CUDA graph per batch on its card) with its
own copy of the weights and the support cache sits on each device of the
mesh. A call sends each device its share of the frame batch (every share
before any replay), copies it into that replica's static buffer and
replays its graph, all from the one host thread with no wait between the
cards, then gathers the results on the mesh's first device. The cards'
work overlaps; the host's is a few operations a card.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..config import Config
from ..pipelines.inference import build_pinned_serving_fn
from ..pipelines.support_cache import SupportCache
from ..structures.instances import Detections
from ..utils.device import resolve_device
from .mesh import Mesh


class ShardedServing:
    """serve_fn(frames) -> Detections over the mesh's pinned replicas (see
    ``make_sharded_serving``)."""

    def __init__(self, cfg: Config, params: Mapping[str, torch.Tensor], input_hw: Tuple[int, int], mesh: Mesh,
                 cache: SupportCache, act_scales: Optional[Mapping[str, float]] = None):
        self.mesh = mesh
        self.replicas = []
        for dev in mesh.devices:
            dev = resolve_device(dev)  # refused without a card before the cache is copied there
            fn, self.canvas_hw = build_pinned_serving_fn(cfg, params, cache.to(dev), input_hw, device=dev,
                                                         act_scales=act_scales)
            self.replicas.append(fn)

    def __call__(self, frames: torch.Tensor) -> Detections:
        n = self.mesh.size
        if frames.shape[0] % n:
            raise ValueError(f"serving batch {frames.shape[0]} not divisible by mesh size {n}; pad the final batch "
                             "(parallel.eval_dp.evaluate_sharded shows the repeat-last-frame pattern)")
        if frames.device.type == "cpu" and self.mesh.devices[0].type == "cuda":
            # staged once in pinned host memory, laid out [B, 3, H, W]: each
            # card's share then goes to its static buffer as an asynchronous
            # copy (from pageable memory the host would wait for each)
            frames = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True).copy_(frames)
        parts = frames.chunk(n)
        if frames.is_cuda:
            # every share is sent before any replay: a copy between cards is
            # enqueued on the source card's stream, behind what it has queued
            parts = [part.to(dev, non_blocking=True) for part, dev in zip(parts, self.mesh.devices)]
        dets = [fn(part) for fn, part in zip(self.replicas, parts)]
        out_dev = self.mesh.devices[0]
        return Detections(*(torch.cat([t.to(out_dev, non_blocking=True) for t in ts]) for ts in zip(*dets)))

    def kernel_launches(self) -> Dict[str, int]:
        """The replicas' replayed kernel launches, summed over the cards."""
        per_card = [fn.kernel_launches() for fn in self.replicas]
        return {k: sum(c[k] for c in per_card) for k in ("cgm", "nms")}


def make_sharded_serving(cfg: Config, params: Mapping[str, torch.Tensor], input_hw: Tuple[int, int], mesh: Mesh,
                         cache: SupportCache, *, act_scales: Optional[Mapping[str, float]] = None
                         ) -> Tuple[ShardedServing, Tuple[int, int]]:
    """Returns (serve_fn, canvas_hw).

    serve_fn(frames [B, 3, H0, W0] uint8 or float, on any device; B a
    multiple of the mesh size) -> Detections [B, K, ...] in frame
    coordinates on the mesh's first device: frames i*B/N .. (i+1)*B/N are
    served on device i by its pinned replica. The parameters and the cache
    go to each device once, here; rebuild after changing either. act_scales
    as ``build_serving_fn`` takes them (the int8 presets; quantization is
    per image, so sharding leaves it unchanged)."""
    serve = ShardedServing(cfg, params, input_hw, mesh, cache, act_scales)
    return serve, serve.canvas_hw
