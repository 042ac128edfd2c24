"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries are found by name, and nothing that was there is
edited."""

import hashlib
import json
import shutil
from pathlib import Path

from bench_port.harness import cells

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    files = [root / "BENCHMARK.json"] + [p for p in (root / "bench_port").rglob("*") if p.is_file()]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def test_additions_are_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name in [w["name"] for w in bench["workloads"]]:
        assert cells.load_cell(name, tmp_path).per_layer

    # the additions: a configuration file, a mix file, a metric's reader, and their entries
    conf = json.loads((tmp_path / "bench_port/configs/vovnet19_slim_25shot.json").read_text())
    conf["name"] = "vovnet_copy"
    (tmp_path / "bench_port/configs/vovnet_copy.json").write_text(json.dumps(conf))
    mix = json.loads((tmp_path / "bench_port/traffic/frames_b8.json").read_text())
    mix["batch"] = 4
    (tmp_path / "bench_port/traffic/frames_b4.json").write_text(json.dumps(mix))
    (tmp_path / "bench_port/metrics/requests.b4.py").write_text("def read(run):\n    return len(run.requests)\n")
    bench["configs"].append({**bench["configs"][0], "name": "vovnet_copy", "file": "bench_port/configs/vovnet_copy.json"})
    bench["workloads"].append({"name": "vovnet_copy_b4", "config": "vovnet_copy", "traffic": "frames_b4",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("vovnet_copy_b4")
    bench["per_layer"].append({"name": "requests.b4", "unit": "1", "better": "higher", "source": "host_clock",
                               "layer": "entry points", "moves": "images_per_s", "workloads": ["vovnet_copy_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell("vovnet_copy_b4", tmp_path)
    assert cell.config["name"] == "vovnet_copy" and cell.traffic["batch"] == 4
    assert list(cell.per_layer) == ["requests.b4"]
    assert cell.per_layer["requests.b4"](type("Run", (), {"requests": [1, 2, 3]})()) == 3
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s", "setup_s"]
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.config["limits"] and all(v is not None for v in cell.config["limits"].values())
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_port/")


TOY_KIND = '''"""A kind of traffic of the test's own: rows of a seeded product, one a request."""
import time

import numpy as np
import torch

from bench_port.harness.interface import Checked, Report, Request, Window


def setup(cell, seed, device, overrides=()):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(cell.traffic["rows"], 16, generator=g), "w": torch.randn(16, 4, generator=g)}


def warm_up(p):
    p["x"][:1] @ p["w"]


def window(p, seconds, rng, profiler=None):
    win = Window()
    win.start = time.perf_counter()
    while time.perf_counter() < win.start + seconds or not win.requests:
        key = int(rng.integers(p["x"].shape[0]))
        t0 = time.perf_counter()
        win.outputs.append((p["x"][key] @ p["w"]).numpy())
        win.requests.append(Request(key, t0, time.perf_counter(), 1))
    win.end = win.requests[-1].done
    return win


def free(p):
    pass


def check(cell, p, win, rng, device):
    x, w = p["x"].double().numpy(), p["w"].double().numpy()
    return Checked({"gap": max(float(np.abs(o - x[r.key] @ w).max()) for r, o in zip(win.requests, win.outputs))})


def report(cell, p, win, checked, trace):
    return Report({"rows_per_s": len(win.requests) / win.seconds}, len(win.requests), 0, {"requests": win.requests})
'''


def test_a_new_kind_of_traffic_is_files(tmp_path, capsys):
    """A cell whose mix is of a kind the harness has never seen runs whole,
    from a kind module, a mix, a configuration and a reader added as files."""
    from bench_port.harness import main as harness

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(tmp_path)
    (tmp_path / "bench_port/kinds/toy_rows.py").write_text(TOY_KIND)
    (tmp_path / "bench_port/traffic/toy_mix.json").write_text(json.dumps({"kind": "toy_rows", "rows": 32}))
    (tmp_path / "bench_port/configs/toy.json").write_text(json.dumps({"name": "toy", "limits": {"gap": 1e-4}}))
    (tmp_path / "bench_port/metrics/rows.toy.py").write_text("def read(run):\n    return len(run.requests)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test", "file": "bench_port/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy_cell", "config": "toy", "traffic": "toy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["toy_cell"]})
    bench["per_layer"].append({"name": "rows.toy", "unit": "1", "better": "higher", "source": "host_clock",
                               "layer": "entry points", "moves": "rows_per_s", "workloads": ["toy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    results = []
    for trace in ("0", "1"):
        rc = harness.main(["--workload", "toy_cell", "--seed", "4000000009", "--seconds", "0.05", "--trace", trace],
                          device="cpu", root=tmp_path)
        assert rc == 0
        results.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert results[0]["correct"] is True and set(results[0]["metrics"]) == {"rows_per_s", "setup_s"}
    assert results[1]["correct"] is True and list(results[1]["metrics"]) == ["rows.toy"]
    assert results[1]["metrics"]["rows.toy"]["value"] == results[1]["attempted"] > 0
    after = _digests(tmp_path)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
