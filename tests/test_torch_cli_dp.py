"""The train and demo command lines with --num-devices, on the CPU:

- train --device cpu --num-devices 2 solver.ims_per_batch=2 spawns two
  gloo ranks: 2 steps with an eval at step 2 (rank 0 alone logs,
  checkpoints and writes the weights), then a one-process --resume to step
  3 and a two-rank --resume to step 4 (checkpoints cross both ways), then
  --eval-only through ``evaluate_sharded``;
- train's refusals: an ims_per_batch that does not split over the ranks,
  and --steps-per-dispatch above 1 (the JAX package's texts);
- demo --num-devices 2 on a short video (--frame-batch 4, each card's
  share 2 frames) against the JAX package's demo with --num-devices 2,
  frame by frame by test_torch_cli.py's criteria, and the demo's
  refusals."""

import functools
import json
import os

import cv2
import numpy as np
import pytest

from faster_orefsdet_tpu_torch.cli import demo
from faster_orefsdet_tpu_torch.cli import train as cli
from faster_orefsdet_tpu_torch.cli.build_support import build_support, cv2_resize
from faster_orefsdet_tpu_torch.data.synthetic import make_synthetic_setup
from faster_orefsdet_tpu_torch.parallel import mesh
from faster_orefsdet_tpu_torch.utils import checkpoint
from test_torch_cli import TINY, _assert_match, _run_demo, workflow  # noqa: F401 (a fixture)
from test_torch_cli_video import FRAMES, _frames, clip  # noqa: F401 (a fixture)
from test_torch_train_checkpoint import TINY as TRAIN_TINY
import torch_budget  # noqa: F401 (the suite's torch thread budget)

RANKS_TIMEOUT_S = 300  # each two-rank run of the CLI (the whole test takes 15-23 s under the suite's load)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_data")
    make_synthetic_setup(4, seed=0, crop_size=64, image_hw=(96, 128), blob_size=(20.0, 40.0), root=str(root),
                         writer=cv2.imwrite)
    return ["--train-json", str(root / "instances.json"), "--train-images", str(root / "images"),
            "--support-index", str(root / "support_index.json"), "--device", "cpu"], root


def _rows(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_train_dp_resume_and_eval(train_data, tmp_path, capfd, monkeypatch):
    # the CLI's ranks under a limit: a rank that hangs fails this test, not the suite's run
    monkeypatch.setattr(mesh, "spawn_ranks", functools.partial(mesh.spawn_ranks, timeout=RANKS_TIMEOUT_S))
    data, root = train_data
    out = tmp_path / "run"
    test = ["--test-json", str(root / "instances.json"), "--test-images", str(root / "images")]
    base = data + ["--output-dir", str(out)] + TRAIN_TINY + ["solver.ims_per_batch=2"]
    cli.main(base + ["--num-devices", "2", "--max-iter", "2", "--eval-period", "2", "--eval-batch", "2"] + test)
    rows = _rows(out)
    assert rows[-1]["iteration"] == 2 and np.isfinite(rows[-1]["eval/AP"])
    assert all(np.isfinite(rows[-1][k]) for k in ("total_loss", "loss_centernet_loc", "loss_cls_stage0"))
    ckpt = str(out / "checkpoints")
    assert checkpoint.latest_step(ckpt) == 2
    assert (out / "model_final.npz").exists()
    assert not [p for p in os.listdir(out) if p.startswith("dist_store_")]  # the rendezvous is removed

    cli.main(base + ["--num-devices", "1", "--max-iter", "3", "--resume"])  # the ranks' checkpoint, one process
    assert checkpoint.latest_step(ckpt) == 3
    cli.main(base + ["--num-devices", "2", "--max-iter", "4", "--resume"])  # and back to two ranks
    assert checkpoint.latest_step(ckpt) == 4 and _rows(out)[-1]["iteration"] == 4

    results = cli.main(data[2:] + ["--eval-only", "--init-npz", str(out / "model_final.npz"), "--num-devices", "2",
                                   "--output-dir", str(out)] + test + TRAIN_TINY)
    assert np.isfinite(results["AP"]) and "latency_mean_s" not in results  # evaluate_sharded's table
    assert capfd.readouterr().out.count("training done") == 3  # the ranks print too: fd capture


@pytest.mark.parametrize("flags, match", [
    (["solver.ims_per_batch=3"], "ims_per_batch 3 must divide over 2 devices"),
    (["solver.ims_per_batch=2", "--steps-per-dispatch", "2"], "composes with single-device only"),
], ids=["ims_per_batch", "steps_per_dispatch"])
def test_train_dp_refusals(train_data, tmp_path, flags, match):
    data, _ = train_data
    with pytest.raises(SystemExit, match=match):
        cli.main(data + ["--num-devices", "2", "--max-iter", "1", "--output-dir", str(tmp_path)] + TRAIN_TINY + flags)


def test_demo_dp_video_matches_jax(workflow, clip):  # noqa: F811
    w = workflow
    index = str(w["root"] / "index_dp.json")
    _, built = build_support(w["json"], w["images"], str(w["root"] / "support_dp"), 96, imread=cv2.imread,
                             imwrite=cv2.imwrite, resize=cv2_resize)
    os.replace(built, index)
    draws = {}
    for which in ("jax", "port"):
        out = str(w["root"] / f"video_dp_{which}" / "clip_out.mp4")
        draws[which] = []
        _run_demo(which, ["--video-input", clip, "--output", out, "--frame-batch", "4", "--num-devices", "2",
                          "--support-index", index, "--params", w["npz"], "--confidence", "0.0", *TINY],
                  draws[which])
        assert _frames(out) == FRAMES
    assert len(draws["port"]) == len(draws["jax"]) == FRAMES
    for g, r in zip(draws["port"], draws["jax"]):
        _assert_match(g, r)


@pytest.mark.parametrize("flags, match", [
    (["--video-input", "v.avi", "--parallel"], "mutually exclusive"),
    (["--input", "x/*.png"], "requires --video-input/--webcam with --frame-batch > 1"),
    (["--video-input", "v.avi", "--frame-batch", "1"], "requires --video-input/--webcam with --frame-batch > 1"),
    (["--webcam", "--frame-batch", "3"], "--frame-batch 3 not divisible by --num-devices 2"),
], ids=["parallel", "glob", "per_frame", "indivisible"])
def test_demo_dp_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        demo.main(["--support-index", "i.json", "--num-devices", "2", *flags])
