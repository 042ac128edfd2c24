"""Everything a run needs, found by name from ``BENCHMARK.json``: the cell,
its configuration's file, its traffic mix's file, the module of the mix's
kind (``kinds/<kind>.py``, see ``interface.py``) and the readers of its
per-layer metrics. A later change adds a configuration, a mix, a kind of
traffic or a metric by adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    kind: ModuleType  # kinds/<traffic's kind>.py
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: Dict[str, Callable] = field(default_factory=dict)  # name -> reader
    per_layer_units: Dict[str, str] = field(default_factory=dict)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric is reported in the cells its `workloads` lists,
    or, without the key, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str, root: Path = BENCH_DIR) -> Callable:
    """The `read(run)` of ``metrics/<name>.py``."""
    return _load(root / "metrics" / f"{name}.py", f"bench_port_metric_{name.replace('.', '_')}").read


def load_kind(name: str, root: Path = BENCH_DIR) -> ModuleType:
    """The module ``kinds/<name>.py`` of a kind of traffic."""
    return _load(root / "kinds" / f"{name}.py", f"bench_port_kind_{name}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    bench_dir = root / "bench_port"
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    cell = Cell(name, int(w["chips"]), config, traffic, load_kind(traffic["kind"], bench_dir), e2e)
    for m in bench["per_layer"]:
        if _reports(m, name, e2e_names):
            cell.per_layer[m["name"]] = load_reader(m["name"], bench_dir)
            cell.per_layer_units[m["name"]] = m["unit"]
    return cell
