"""The suite's CPU thread budget for torch, set once in each pytest process
that imports it; every ``tests/test_torch_*.py`` does
(``tests/test_torch_budget.py`` holds them to it).

Under xdist, ``PYTEST_XDIST_WORKER_COUNT`` workers share the machine's cores,
and torch would give each of them an intra-op pool as wide as the whole
machine: the pools oversubscribe the cores, and the suite's small tensors
run many times slower (10-100x slower requests measured under load). So
each process takes ``max(1, os.cpu_count() // PYTEST_XDIST_WORKER_COUNT)``
threads, the count being 1 outside xdist. Every xdist worker collects, and
so imports, every module it was given, so the budget is in force before any
test of the worker runs. Ranks a test spawns on the CPU set their own one
thread (``parallel.mesh.spawn_ranks``); this setting does not reach them.
``tests/test_torch_dla.py`` alone runs at another count (its docstring says
why)."""

import os

import torch


def threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


torch.set_num_threads(threads())
