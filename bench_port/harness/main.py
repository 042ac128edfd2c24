"""One run of one cell: set-up, the timed window, with --trace 1 a profile of
a steady part of it, then the check of the window's answers against the
reference, and the result's line. What is particular to a kind of traffic
is the kind's module (``interface.py``); this file names none."""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from . import cells, compare
from . import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "faster_orefsdet_tpu")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def card_state() -> str:
    """The card's clocks, power and temperature now, and why it is held back."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu,"
                              "clocks_throttle_reasons.active", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def main(argv=None, t0: Optional[float] = None, device: Optional[str] = None, break_path=None,
         root: Optional[Path] = None) -> int:
    """`device`, `break_path` and `root` are for the harness's own tests: a
    run on the CPU, a fault planted in the program after its set-up, and
    another checkout's BENCHMARK.json and bench_port/."""
    t0 = time.monotonic() if t0 is None else t0
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload, root or cells.ROOT)
    kind = cell.kind

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"bench_port: {args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    on_card = device == "cuda"
    rng = np.random.default_rng(args.seed % (1 << 63))
    program = kind.setup(cell, args.seed, device)
    if break_path is not None:
        break_path(program)
    kind.warm_up(program)
    prof = profiler() if (args.trace and on_card) else None
    # the harness's own garbage collection stays out of the window
    gc.collect()
    gc.disable()
    setup_s = time.monotonic() - t0
    try:
        win = kind.window(program, args.seconds, rng, prof)
    finally:
        gc.enable()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    card_after = card_state() if on_card else None
    trace = tracing.read(prof) if prof is not None else None
    kind.free(program)
    checked = kind.check(cell, program, win, rng, device)
    limits = cell.config["limits"]
    nums = checked.numbers
    rep = kind.report(cell, program, win, checked, trace)

    metrics: Dict[str, dict] = {}
    if not args.trace:
        values = {"setup_s": setup_s, **rep.end_to_end}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        run = SimpleNamespace(kind=cell.traffic["kind"], trace=trace, **rep.facts)
        for name, reader in cell.per_layer.items():
            value = reader(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.per_layer_units[name]}

    info = {"workload": args.workload, "seed": args.seed, "window_s": win.seconds, "setup_s": setup_s, **rep.info}
    if card_after is not None:
        info.update(card_after_window=card_after)
    if trace is not None:
        info.update(traced_requests=trace.requests, traced_request_ms_mean=trace.request_s / trace.requests * 1e3)
    print(json.dumps({"info": info}), flush=True)

    found = forbidden_modules()
    if found:
        print(f"bench_port: the process loaded {found} (the JAX package or JAX); no result", file=sys.stderr)
        return 3
    result = {"correct": compare.within(nums, limits), "attempted": rep.attempted, "failed": rep.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    for k in limits:
        print(f"check {k}: {nums[k]!r} limit {limits[k]!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
