#!/usr/bin/env python3
"""The camera sweep that fixes a camera mix's number of cameras: one
program set-up, then the open loop at each count of cameras in turn, each
for a short window; prints the 95th percentile of latency from due time,
and the mean latency of the first and last fifth of the window (a growing
backlog shows as the last above the first).

    python3 bench_port/sweep.py --workload vovnet_camera_b1 --seed 5 --seconds 4 --cameras 4 6 8 10

The knee is the highest rate whose p95 meets the mix's limit with no
growing backlog; the mix takes the largest whole count at or under 80% of it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port.harness import cells, main as harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--cameras", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = cells.load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    print(json.dumps({"card": harness.card_line() if device == "cuda" else "cpu"}), flush=True)
    kind = cell.kind  # kinds/camera_stream.py
    served = kind.setup(cell, args.seed, device)
    kind.warm_up(served)
    for n in args.cameras:
        rng = np.random.default_rng(args.seed)
        win = kind.window(served, args.seconds, rng, cameras=n)
        lat = np.asarray([(r.done - r.due) * 1e3 for r in win.requests])
        fifth = max(1, len(lat) // 5)
        print(json.dumps({"cameras": n, "offered_per_s": n * cell.traffic["fps"], "frames": len(lat),
                          "served_per_s": len(lat) / (win.end - win.start),
                          "p95_ms": float(np.percentile(lat, 95)), "p50_ms": float(np.median(lat)),
                          "p95_within_limit": bool(np.percentile(lat, 95) <= cell.traffic["limit_ms"]),
                          "first_fifth_mean_ms": float(lat[:fifth].mean()),
                          "last_fifth_mean_ms": float(lat[-fifth:].mean()),
                          "service_ms_median": float(np.median([(r.done - r.send) * 1e3 for r in win.requests]))}),
              flush=True)


if __name__ == "__main__":
    main()
