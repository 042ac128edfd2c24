"""Traffic kind `closed_batches`: one client in a closed loop. Each request
is `batch` distinct frames of a seeded pool of `pool` belt frames (`hw`,
`blobs` ore blobs each), handed to the pinned raw-frame serving function;
the next is sent when the last one's detections are on the host. The
batches go round in a new seeded order each round. With a profiler, the
first `trace_requests` requests are traced.

End to end: `images_per_s`, every frame completed in the window over the
window's time. Facts for the readers: the requests, K1's and K2's least
time per traced request (the yardstick's counts on the reference's record
of the same frames), the model's FLOPs per image and the stated peak.
"""

import statistics
import time
from typing import List

import numpy as np
from torch.profiler import record_function

from bench_port.harness import serving
from bench_port.harness.interface import Report, Request, Window
from bench_port.harness.trace import REQUEST

setup, free, check, reference_control = serving.setup, serving.free, serving.check, serving.reference_control


def batch_of(served: serving.Served, key: int):
    b = served.traffic["batch"]
    return served.pool[key * b:(key + 1) * b]


def warm_up(served: serving.Served) -> None:
    serving.warm_up(served, batch_of(served, 0))


def window(served: serving.Served, seconds: float, rng: np.random.Generator, profiler=None) -> Window:
    """The closed loop for `seconds`. A profiler is started before the
    window (its start takes a second or more) and stopped after the traced
    requests."""
    n_keys = served.traffic["pool"] // served.traffic["batch"]
    win = Window()
    order: List[int] = []
    traced_left = served.traffic["trace_requests"] if profiler is not None else 0
    tracing = bool(traced_left)
    if tracing:
        profiler.start()
    win.start = time.perf_counter()
    deadline = win.start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        if not order:
            order = list(rng.permutation(n_keys))
        key = order.pop()
        with record_function(REQUEST):
            out = served.request(batch_of(served, key))
        t1 = time.perf_counter()
        win.requests.append(Request(key, t0, t1, out.shape[0], traced=tracing))
        win.outputs.append(out)
        if tracing:
            traced_left -= 1
            if not traced_left:
                profiler.stop()
                tracing = False
    if tracing:
        profiler.stop()
    win.end = win.requests[-1].done
    return win


def kernel_bounds(cell, record: dict) -> List[tuple]:
    """(K1 s, K2 s) of each batch's work, by the yardstick, from the
    reference's record of its blocks (one block a batch)."""
    from bench_port.counts import k1, k2

    qb = 2 if cell.config["precision"] == "bfloat16" else 4
    levels = len(record["k2_decode"]) and len(record["k1"]) // len(record["k2_decode"])
    out = []
    for j, (dec, roi) in enumerate(zip(record["k2_decode"], record["k2_roi"])):
        t1 = sum(k1.call_seconds(*shape, qb, qb) for shape in record["k1"][j * levels:(j + 1) * levels])
        out.append((t1, k2.call_seconds(*dec) + k2.call_seconds(*roi)))
    return out


def report(cell, served: serving.Served, win: Window, checked, trace) -> Report:
    images = sum(r.images for r in win.requests)
    facts = {"requests": win.requests}
    if trace is not None:
        bounds = kernel_bounds(cell, checked.reference.record)
        traced = [r.key for r in win.requests if r.traced]
        facts["k1_s"] = float(np.mean([bounds[k][0] for k in traced]))
        facts["k2_s"] = float(np.mean([bounds[k][1] for k in traced]))
        facts["flops_per_image"], facts["peak_flops"] = serving.model_flops(cell, served, checked.reference,
                                                                            served.device)
    info = {"requests": len(win.requests), "images": images,
            "request_ms_median": statistics.median((r.done - r.send) * 1e3 for r in win.requests)}
    info.update({k: facts[k] for k in ("k1_s", "k2_s", "flops_per_image") if k in facts})
    return Report({"images_per_s": images / win.seconds}, images, 0, facts, info)
