"""The AttentionRPN baseline's cell, `fsodrcnn_serve_b8`: found by name with
its configuration checked against the program's, a reference (with its
FLOP count and weight rule) that loads nothing of the program, a whole run
of its kind (`fsodrcnn_batches`) on the CPU at a tiny size, a fault that
must turn `correct` false, and its control on the card.

The tiny size is the cell's files copied and cut down in a temporary
checkout: a yaml on top of Base-FSOD-C4.yaml with the test size 96 and 8
proposals, 3 shots of 64 px, 4 frames of 96x128 in batches of 2."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from bench_port import readings
from bench_port.harness import cells, compare
from bench_port.harness import main as harness
from test_benchport_imports import FORBIDDEN, _tops

ROOT = Path(__file__).resolve().parents[2]
CELL = "fsodrcnn_serve_b8"
STAGES = ("preprocess", "features", "attention_rpn", "proposals", "roi_pool", "res5", "relation", "detections")
TINY_YAML = """_BASE_: "Base-FSOD-C4.yaml"
MODEL:
  RPN:
    POST_NMS_TOPK_TEST: 8
INPUT:
  FS:
    SUPPORT_SHOT: 3
  MIN_SIZE_TEST: 96
"""


def test_the_cell_is_found_by_name():
    cell = cells.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "fsodrcnn_batches"
    assert cell.config["name"] == "fsodrcnn_r50c4_10shot" and cell.config["reduced"] == []
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s", "setup_s"]
    assert set(cell.per_layer) == ({"request_ms.fsodrcnn", "idle_share.batch", "mfu.batch", "k2_roofline.batch"}
                                   | {f"stage_ms.{s}.fsodrcnn" for s in STAGES})
    cfg, icfg = cell.kind.program_config(cell.config)  # the yaml with the file's overrides is the file's model
    assert cfg.rpn_pre_nms_topk_test == 6000 and (icfg.min_size_test, icfg.max_size_test) == (600, 1000)


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops("import bench_port.reference.fsod_rcnn, bench_port.counts.fsod_flops, bench_port.harness.fsod_weights")
    assert not tops & FORBIDDEN and "faster_orefsdet_tpu_torch" not in tops


def _tiny_checkout(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (tmp_path / "configs/fsod").mkdir(parents=True)
    shutil.copy(ROOT / "configs/fsod/Base-FSOD-C4.yaml", tmp_path / "configs/fsod/Base-FSOD-C4.yaml")
    (tmp_path / "configs/fsod/tiny.yaml").write_text(TINY_YAML)
    conf_path = tmp_path / "bench_port/configs/fsodrcnn_r50c4_10shot.json"
    conf = json.loads(conf_path.read_text())
    conf["serve"].update(yaml="configs/fsod/tiny.yaml", shots=3, shot_crop=64, shot_canvas=64)
    conf["model"].update(rpn_post_nms_topk_test=8, support_shot=3)
    conf["input"].update(min_size_test=96)
    conf_path.write_text(json.dumps(conf))
    mix_path = tmp_path / "bench_port/traffic/frames_b8_fsodrcnn.json"
    mix = json.loads(mix_path.read_text())
    mix.update(batch=2, pool=4, frame_hw=[96, 128], trace_requests=1)
    mix_path.write_text(json.dumps(mix))
    return tmp_path


def _run(root, trace, capsys, break_path=None):
    rc = harness.main(["--workload", CELL, "--seed", "4000000013", "--seconds", "0.05", "--trace", trace],
                      device="cpu", root=root, break_path=break_path)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_whole_run_at_a_tiny_size(tmp_path, capsys):
    torch.set_num_threads(4)
    root = _tiny_checkout(tmp_path)
    plain = _run(root, "0", capsys)
    assert plain["correct"] is True and plain["failed"] == 0 and plain["attempted"] > 0
    assert set(plain["metrics"]) == {"images_per_s", "setup_s"}
    assert plain["checks"]["unmatched_mean"]["value"] == 0.0
    traced = _run(root, "1", capsys)  # on the CPU the harness traces nothing: the host's reader alone reads
    assert traced["correct"] is True and list(traced["metrics"]) == ["request_ms.fsodrcnn"]


def _moved(served):
    run = served.fn

    def fn(frames):
        det = run(frames)
        shift = torch.zeros_like(det.boxes)
        shift[..., 0::2] = 60.0  # every frame's boxes moved 60 px to the right
        return det._replace(boxes=det.boxes + shift)

    served.fn = fn


def test_moved_answers_are_not_correct(tmp_path, capsys):
    torch.set_num_threads(4)
    result = _run(_tiny_checkout(tmp_path), "0", capsys, break_path=_moved)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.card
def test_the_control_is_not_correct(card):
    """The reference under bf16 autocast in the program's place, at the
    cell's own size: not correct by the configuration's limits."""
    cell = cells.load_cell(CELL)
    out = readings.control_reading(cell, 31, 1.0, card)
    assert not compare.within(out, cell.config["limits"])
