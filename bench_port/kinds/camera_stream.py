"""Traffic kind `camera_stream`: an open loop. The frames of the mix's
cameras fall due at `fps`, each camera at its fixed phase (`phases_ms`, so
that every seed offers the same arrivals), and are served one at a time
(batch 1) in due order, each as soon as it is due and the last is done.
Each frame is one of a seeded pool of `pool` belt frames, in a seeded
order. A frame's latency runs from its due time. With a profiler, the
frames due in the first `trace_seconds` are traced; the rest of the window
then runs at the mix's load, its arrivals moved by the profiler's stop.

End to end: `frame_p95_ms`, the 95th percentile of latency over every
frame of the window. How late the generator ran goes on the info line.
"""

import math
import statistics
import time
from typing import Optional

import numpy as np
from torch.profiler import record_function

from bench_port.harness import serving
from bench_port.harness.interface import Report, Request, Window
from bench_port.harness.trace import REQUEST

setup, free, check, reference_control = serving.setup, serving.free, serving.check, serving.reference_control
SPIN_S = 1e-3  # the loop sleeps until this close to a due time, then spins


def warm_up(served: serving.Served) -> None:
    serving.warm_up(served, served.pool[0:1])


def schedule(phases, fps: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of cameras at `fps` with these phases (s,
    each in [0, 1/fps)), merged in time order."""
    ticks = np.arange(int(math.ceil(seconds * fps)) + 1) / fps
    due = (np.asarray(phases)[:, None] + ticks[None, :]).ravel()
    return np.sort(due[due < seconds])


def window(served: serving.Served, seconds: float, rng: np.random.Generator, profiler=None,
           cameras: Optional[int] = None) -> Window:
    """The open loop for `seconds`. A profiler is started before the window.
    `cameras`, where given, replaces the mix's phases by that many cameras
    at seeded phases (the sweep, ``sweep.py``)."""
    t = served.traffic
    if cameras is None:
        phases = np.asarray(t["phases_ms"]) / 1e3
    else:
        phases = rng.uniform(0.0, 1.0 / t["fps"], cameras)
    due = schedule(phases, t["fps"], seconds)
    pool = t["pool"]
    order = rng.permutation(pool)
    win = Window()
    trace_seconds = t["trace_seconds"] if profiler is not None else 0.0
    tracing = trace_seconds > 0
    if tracing:
        profiler.start()
    win.start = time.perf_counter() + 0.05
    shift = 0.0  # the profiler's stop, which stalls the loop, moves the later arrivals by its length
    for i, d in enumerate(due):
        if tracing and d >= trace_seconds:
            t0 = time.perf_counter()
            profiler.stop()
            shift = time.perf_counter() - t0
            tracing = False
        due_abs = win.start + shift + d
        now = time.perf_counter()
        if now < due_abs:
            with record_function("bench.wait"):
                if due_abs - now > SPIN_S:
                    time.sleep(due_abs - now - SPIN_S)
                while time.perf_counter() < due_abs:
                    pass
        key = int(order[i % pool])
        t0 = time.perf_counter()
        with record_function(REQUEST):
            out = served.request(served.pool[key:key + 1])
        t1 = time.perf_counter()
        win.requests.append(Request(key, t0, t1, 1, due=due_abs, traced=tracing))
        win.outputs.append(out)
    if tracing:
        profiler.stop()
    win.end = win.requests[-1].done
    return win


def latencies_ms(win: Window) -> np.ndarray:
    return np.asarray([(r.done - r.due) * 1e3 for r in win.requests])


def report(cell, served: serving.Served, win: Window, checked, trace) -> Report:
    lat = latencies_ms(win)
    reqs = win.requests
    # the generator is late where a frame is sent after its due time with no frame in service
    late = [(r.send - r.due) * 1e3 for i, r in enumerate(reqs) if i == 0 or reqs[i - 1].done <= r.due]
    info = {"requests": len(reqs), "images": len(reqs),
            "request_ms_median": statistics.median((r.done - r.send) * 1e3 for r in reqs),
            "latency_ms_p50": float(np.median(lat)), "latency_ms_max": float(np.max(lat)),
            "generator_late_ms_p50": float(np.median(late)) if late else None,
            "generator_late_ms_max": float(np.max(late)) if late else None}
    return Report({"frame_p95_ms": float(np.percentile(lat, 95))}, len(reqs), 0, {"requests": reqs}, info)
