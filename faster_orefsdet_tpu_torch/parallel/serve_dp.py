"""Data-parallel serving: raw frames to detections over a mesh (counterpart
of ``faster_orefsdet_tpu/parallel/serve_dp.py``).

Serving needs no collectives, so it stays in one process: a replica of the
raw-frame serving function (``pipelines.inference.build_serving_fn``) and
of the support cache sits on each device of the mesh, and a call enqueues
each device's share of the frame batch in turn, then gathers the results.
The query path never waits for the device, so the cards' work overlaps.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import torch

from ..config import Config
from ..pipelines.inference import build_serving_fn
from ..pipelines.support_cache import SupportCache
from ..structures.instances import Detections
from .mesh import Mesh


def make_sharded_serving(cfg: Config, params: Mapping[str, torch.Tensor], input_hw: Tuple[int, int], mesh: Mesh,
                         cache: SupportCache, *, act_scales: Optional[Mapping[str, float]] = None
                         ) -> Tuple[Callable[[torch.Tensor], Detections], Tuple[int, int]]:
    """Returns (serve_fn, canvas_hw).

    serve_fn(frames [B, 3, H0, W0] uint8 or float, on any device; B a
    multiple of the mesh size) -> Detections [B, K, ...] in frame
    coordinates on the mesh's first device: frames i*B/N .. (i+1)*B/N are
    served on device i. The parameters and the cache go to each device
    once, here. act_scales as ``build_serving_fn`` takes them (the int8
    presets; quantization is per image, so sharding leaves it unchanged)."""
    replicas = []
    for dev in mesh.devices:
        fn, canvas_hw = build_serving_fn(cfg, params, input_hw, device=dev, act_scales=act_scales)
        replicas.append((fn, cache.to(dev), dev))
    out_dev = mesh.devices[0]

    def serve_fn(frames: torch.Tensor) -> Detections:
        b = frames.shape[0]
        if b % mesh.size:
            raise ValueError(f"serving batch {b} not divisible by mesh size {mesh.size}; pad the final batch "
                             "(parallel.eval_dp.evaluate_sharded shows the repeat-last-frame pattern)")
        dets = [fn(c, part.to(dev, non_blocking=True))
                for (fn, c, dev), part in zip(replicas, frames.chunk(mesh.size))]
        return Detections(*(torch.cat([t.to(out_dev, non_blocking=True) for t in ts]) for ts in zip(*dets)))

    return serve_fn, canvas_hw
