"""The one-stage cell, `dla34dcn_onestage_b8`: found by name with its
configuration checked against the program's, a reference (with its FLOP
count, deformable yardstick and weight rule) that loads nothing of the
program, a whole run of its kind (`onestage_batches`) on the CPU at a tiny
size, the faults that must turn `correct` false, and its control on the
card.

The tiny size is the cell's files copied and cut down in a temporary
checkout: the test size 96 (a 96x128 canvas, the stride-4 map 24x32, 61,440
scored pairs at 80 classes), 4 frames of 96x128 in batches of 2."""

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
CELL = "dla34dcn_onestage_b8"
STAGES = ("preprocess", "backbone", "decoder", "head", "decode")


def test_the_cell_is_found_by_name():
    cell = cells.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "onestage_batches"
    assert cell.config["name"] == "centernet_s4_dla34_dcn" and cell.config["reduced"] == []
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s", "setup_s"]
    assert set(cell.per_layer) == ({"request_ms.onestage", "idle_share.batch", "mfu.batch", "k2_roofline.batch",
                                    "dcn_roofline.onestage"} | {f"stage_ms.{s}.onestage" for s in STAGES})
    from bench_port.harness.serving import program_config

    cfg = program_config(cell.config)  # the preset with the file's overrides is the file's model
    assert cfg.backbone_name == "dla_seg" and cfg.centernet.num_classes == 80
    assert (cfg.input.min_size_test, cfg.input.max_size_test) == (608, 900)


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops("import bench_port.reference.onestage_dla, bench_port.counts.onestage_flops, "
                 "bench_port.counts.dcn, bench_port.harness.onestage_weights")
    assert not tops & FORBIDDEN and "faster_orefsdet_tpu_torch" not in tops


def test_the_deformable_yardstick_counts_each_block_once():
    from bench_port.counts import dcn, peaks

    # a 64 -> 64 block on the 152x208 map at batch 8: its operations bound it
    b, c, h, w = 8, 64, 152, 208
    flops = 2 * b * h * w * 9 * c * (c + 27)
    nbytes = 4 * (b * c * h * w + b * h * w * 27 + 9 * c * (c + 27) + 27 + b * h * w * c)
    peak = peaks.BY_PRECISION[cells.load_cell(CELL).config["precision"]]
    assert flops / peak > nbytes / peaks.BYTES_PER_S
    assert dcn.call_seconds(b, c, h, w, c, h, w, peak) == flops / peak


def _tiny_checkout(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    conf_path = tmp_path / "bench_port/configs/centernet_s4_dla34_dcn.json"
    conf = json.loads(conf_path.read_text())
    conf["serve"]["overrides"] = [o.replace("input.min_size_test=608", "input.min_size_test=96")
                                  for o in conf["serve"]["overrides"]]
    conf["model"]["input"]["min_size_test"] = 96
    conf_path.write_text(json.dumps(conf))
    mix_path = tmp_path / "bench_port/traffic/frames_b8_onestage.json"
    mix = json.loads(mix_path.read_text())
    mix.update(batch=2, pool=4, frame_hw=[96, 128], trace_requests=1)
    mix_path.write_text(json.dumps(mix))
    return tmp_path


def _run(root, trace, capsys, break_path=None):
    rc = harness.main(["--workload", CELL, "--seed", "4000000019", "--seconds", "0.05", "--trace", trace],
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
    assert traced["correct"] is True and list(traced["metrics"]) == ["request_ms.onestage"]


def _moved(served):
    run = served.fn

    def fn(frames):
        det = run(frames)
        shift = torch.zeros_like(det.boxes)
        shift[..., 0::2] = 60.0  # every frame's boxes moved 60 px to the right
        return det._replace(boxes=det.boxes + shift)

    served.fn = fn


def _half(served):
    run = served.fn

    def fn(frames):
        det = run(frames)
        h = det.boxes.shape[0] // 2
        return det._make(torch.cat([t[:h], t[:h]]) for t in det)  # half a batch's answers copied

    served.fn = fn


def _permuted(served):
    run = served.fn

    def fn(frames):
        det = run(frames)
        return det._replace(classes=(det.classes + 1) % 80)  # every class id moved to the next

    served.fn = fn


@pytest.mark.parametrize("fault", [_moved, _half, _permuted], ids=["moved", "half", "classes"])
def test_a_broken_timed_path_is_not_correct(tmp_path, capsys, fault):
    torch.set_num_threads(4)
    result = _run(_tiny_checkout(tmp_path), "0", capsys, break_path=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.card
def test_the_control_is_not_correct(card):
    """The reference under bf16 autocast in the program's place, at the
    cell's own size: not correct by the configuration's limits."""
    cell = cells.load_cell(CELL)
    out = readings.control_reading(cell, 31, 1.0, card)
    assert not compare.within(out, cell.config["limits"])
