"""Metric logging: scalars to the terminal and to ``metrics.jsonl``
(counterpart of ``faster_orefsdet_tpu/utils/events.py``).

Scalars accumulate per step and flush as one JSON row per window, with the
mean of each scalar over the window's steps, the iteration, and the wall
time per iteration (``time_per_iter``). With tensorboard=True each row's
scalars also go to a tensorboard event file under ``tb/`` beside
``metrics.jsonl``."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Mapping, Sequence, Tuple

import torch


def drain_device_metrics(window: Sequence[Tuple[int, Mapping[str, torch.Tensor]]]
                         ) -> List[Tuple[int, Dict[str, float]]]:
    """[(step, {name: 0-dim device tensor})] -> [(step, {name: float})] with
    one read-back for the whole window: a read per step would make every
    step wait for the device."""
    if not window:
        return []
    keys = sorted(window[0][1])
    stacked = torch.stack([torch.stack([torch.as_tensor(m[k]).float() for k in keys]) for _, m in window])
    vals = stacked.cpu().numpy()
    return [(step, {k: float(vals[i, j]) for j, k in enumerate(keys)}) for i, (step, _) in enumerate(window)]


class EventLogger:
    def __init__(self, output_dir: str, period: int = 20, tensorboard: bool = False):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.period = period
        self._buffer: Dict[str, list] = defaultdict(list)
        self._nsteps = 0
        self._last_time = time.perf_counter()
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except Exception as e:  # tensorboard is optional
                print(f"tensorboard unavailable ({e}); jsonl only")

    def log(self, step: int, scalars: Mapping[str, float], count: int = 1) -> None:
        """Add the scalars of `count` optimizer steps (count=0: scalars that
        are no step's, such as eval results, which join the next row without
        adding to its step count). The caller flushes."""
        w = max(count, 1)
        for k, v in scalars.items():
            self._buffer[k].append((float(v), w))
        self._nsteps += count

    def exclude_wall(self, seconds: float) -> None:
        """Leave non-training wall time (an eval pass) out of the next row's
        time_per_iter."""
        self._last_time += seconds

    def flush(self, step: int) -> None:
        if not self._buffer:
            return
        now = time.perf_counter()
        means = {k: sum(v * w for v, w in pairs) / sum(w for _, w in pairs) for k, pairs in self._buffer.items()}
        n = self._nsteps or max(len(v) for v in self._buffer.values())
        means["iteration"] = step
        means["time_per_iter"] = (now - self._last_time) / max(n, 1)
        with open(self.path, "a") as f:
            f.write(json.dumps(means) + "\n")
        if self._tb is not None:
            for k, v in means.items():
                if k != "iteration":
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
        loss_str = "  ".join(f"{k}: {v:.4g}" for k, v in sorted(means.items())
                             if k.startswith("loss") or k == "total_loss")
        print(f"iter {step}  {loss_str}  ({means['time_per_iter']:.3f} s/it)")
        self._buffer.clear()
        self._nsteps = 0
        self._last_time = now
