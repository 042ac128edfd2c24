"""What the benchmark loads: no module whose top-level name is JAX's or the
JAX package's (compared whole), and a reference that loads nothing of the
program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "faster_orefsdet_tpu"}


def _tops(code: str) -> set:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; import json; "
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _tops("import bench_port.reference.serving, bench_port.reference.model, bench_port.counts.flops")
    assert not tops & FORBIDDEN
    assert "faster_orefsdet_tpu_torch" not in tops


def test_the_harness_loads_no_jax():
    code = ("import bench_port.harness.main as m, bench_port.harness.serving as s; "
            "from bench_port.harness import cells; "
            "[cells.load_cell(w['name']) for w in json.load(open('BENCHMARK.json'))['workloads']]; "
            "import faster_orefsdet_tpu_torch.pipelines.inference, faster_orefsdet_tpu_torch.pipelines.support_cache; "
            "import faster_orefsdet_tpu_torch.config")
    tops = _tops("import json; " + code)
    assert not tops & FORBIDDEN
    assert "faster_orefsdet_tpu_torch" in tops  # the program is loaded, and its top-level name is its own


def test_the_name_check_compares_whole_names():
    from bench_port.harness.main import FORBIDDEN as checked

    assert "faster_orefsdet_tpu" in checked and "faster_orefsdet_tpu_torch" not in checked
