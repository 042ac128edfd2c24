"""Profiling and cost analysis (counterpart of
``faster_orefsdet_tpu/utils/profiling.py``):

  trace(log_dir)     a torch.profiler trace of the block (host and card),
                     written as a Chrome trace that TensorBoard's profiler
                     plugin and Perfetto read
  cost_analysis(fn)  the flops of one eager call
  measure_model(..)  params and flops of the single-image query path
  device_memory()    allocator statistics per visible card
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from ..utils.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (the CPU, and the card where
    there is one) and write ``<log_dir>/<worker>.<time>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    print(f"profile written to {log_dir}")


def cost_analysis(fn, *args) -> Dict[str, float]:
    """{"flops": ...} of one eager call fn(*args), by
    ``torch.utils.flop_counter.FlopCounterMode``. It counts the matrix
    products and convolutions only (XLA's count adds the elementwise work)
    and cannot see inside a CUDA-graph replay, so fn must run eagerly. There
    is no "bytes accessed" entry."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


def measure_model(cfg=None, device="cuda") -> Dict[str, float]:
    """Params and flops of the single-image query path at a 320x448 canvas
    (image 320x427) with a zero support cache; the params counted as the
    JAX package's tree counts them (FrozenBN affines included, running
    statistics not). bytes_accessed is NaN, as where XLA reports none."""
    from ..config import get_config
    from ..pipelines.inference import make_detector, query_path_single
    from ..pipelines.support_cache import SupportCache
    from .params import init_params, is_batch_stat

    cfg = cfg or get_config("finetune_vovnet")
    dev = resolve_device(device)
    params = init_params(cfg, seed=0)
    model = make_detector(cfg, params, device=dev)
    c = cfg.fpn.out_channels
    z = lambda s: torch.zeros(s, s, c, device=dev)  # noqa: E731
    cache = SupportCache(p3=z(32), p4=z(16), p5=z(8), rcnn_8=z(cfg.roi.pooler_resolution),
                         rcnn_4=z(cfg.roi.pooler_resolution2))
    image = torch.zeros(3, 320, 448, device=dev)
    hw = torch.tensor([320.0, 427.0], device=dev)
    ca = cost_analysis(lambda: query_path_single(model, cache, image, hw))
    return {
        "params": int(sum(t.numel() for k, t in params.items() if not is_batch_stat(k))),
        "flops": ca.get("flops", float("nan")),
        "bytes_accessed": ca.get("bytes accessed", float("nan")),
    }


def device_memory() -> Dict[str, Any]:
    """{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}} for each
    visible card (empty without one)."""
    stats = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats
