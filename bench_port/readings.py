#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from: the
program's compared numbers over many seeds (the lower reading), and the
control's over a few (the upper reading), each from a short window at the
cell's own load, in one process.

    python3 bench_port/readings.py --workload <name> --seeds 11 12 ... \
        [--control-seeds 21 22 23] [--seconds 2]

The control is the configuration's `control`: the program with a lower
precision path switched on, or the reference put in the program's place
and computed in the precision below the stated one. The benchmark's own
runs never run it. Prints one JSON line a reading.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port.harness import cells, compare, main as harness  # noqa: E402


def program_reading(cell, seed, seconds, device, overrides=()):
    """The program's compared numbers after a short window at the cell's load."""
    kind = cell.kind
    rng = np.random.default_rng(seed)
    program = kind.setup(cell, seed, device, overrides)
    kind.warm_up(program)
    win = kind.window(program, seconds, rng)
    kind.free(program)
    checked = kind.check(cell, program, win, rng, device)
    ok = compare.within(checked.numbers, cell.config["limits"])
    return {"seed": seed, **checked.numbers, "within_limits": ok, "requests": len(win.requests)}


def control_reading(cell, seed, seconds, device):
    """The configuration's control: the program with its lower precision
    path switched on, or the reference in its place at the lower precision."""
    ctl = cell.config["control"]
    if ctl["kind"] == "program":
        return program_reading(cell, seed, seconds, device, ctl["overrides"])
    return {"seed": seed, **cell.kind.reference_control(cell, seed, device, getattr(torch, ctl["autocast"]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    cell = cells.load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    print(json.dumps({"card": harness.card_line() if device == "cuda" else "cpu"}), flush=True)
    for seed in args.seeds:
        torch.backends.cudnn.allow_tf32 = True  # the program runs under PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"workload": args.workload, "side": "program",
                          **program_reading(cell, seed, args.seconds, device)}), flush=True)
    for seed in args.control_seeds:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"workload": args.workload, "side": "control",
                          **control_reading(cell, seed, args.seconds, device)}), flush=True)


if __name__ == "__main__":
    main()
