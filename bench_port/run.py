#!/usr/bin/env python3
"""The benchmark of faster_orefsdet_tpu_torch, one cell a run:

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card. The last line of standard
output is the run's result (JSON); see bench_port/README.md.
"""

import os
import sys
import time

T0 = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
# the compile caches live at fixed paths inside the checkout, so that only a
# checkout's first run builds (the port's own nvcc builds sit in its _build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
sys.path.insert(0, os.path.dirname(HERE))

from bench_port.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
