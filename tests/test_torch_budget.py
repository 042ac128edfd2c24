"""The suite's CPU thread budget (``tests/torch_budget.py``) is in force in
the process that runs this test: torch takes the machine's cores over the
xdist workers sharing them, at least one, and all of them outside xdist.
Every port test module imports the budget, so that it holds whichever of
them a worker is given. Without it every worker's pool spans the whole
machine and the suite slows several times over, with nothing failing."""

import ast
import os
from pathlib import Path

import torch

import torch_budget  # noqa: F401 (the suite's torch thread budget)


def test_torch_threads_are_the_cores_over_the_workers():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, (os.cpu_count() or 1) // workers), (
        torch.get_num_threads(), os.cpu_count(), workers)


def test_every_port_test_module_imports_the_budget():
    def imports_budget(path):
        return any(isinstance(node, ast.Import) and any(a.name == "torch_budget" for a in node.names)
                   for node in ast.parse(path.read_text()).body)

    modules = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(modules) > 30
    assert [p.name for p in modules if not imports_budget(p)] == []
