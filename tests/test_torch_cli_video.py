"""The port's demo on a video against the JAX package's, on the CPU: a clip
written with cv2 goes through --video-input with --frame-batch 4 (batched
raw-frame serving, the tail batch padded) in both packages; every frame's
detections, recorded at ``draw_detections``, are greedy-matched as in
``test_torch_cli.py``, and both write a clip of as many frames."""

import os

import cv2
import numpy as np
import pytest

from test_torch_cli import TINY, _assert_match, _run_demo, workflow  # noqa: F401 (a fixture)
import torch_budget  # noqa: F401 (the suite's torch thread budget)

FRAMES, FRAME_BATCH, FRAME_WH = 6, 4, (128, 96)


@pytest.fixture(scope="module")
def clip(workflow):  # noqa: F811
    path = str(workflow["root"] / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, FRAME_WH)
    base = cv2.resize(cv2.imread(os.path.join(workflow["images"], "00000.jpg")), FRAME_WH)
    for i in range(FRAMES):
        writer.write(np.roll(base, 3 * i, axis=1))
    writer.release()
    return path


def _frames(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_demo_video_matches_jax(workflow, clip):  # noqa: F811
    w = workflow
    index = str(w["root"] / "index.json")
    from faster_orefsdet_tpu_torch.cli.build_support import build_support, cv2_resize

    _, built = build_support(w["json"], w["images"], str(w["root"] / "support"), 96, imread=cv2.imread,
                             imwrite=cv2.imwrite, resize=cv2_resize)
    os.replace(built, index)
    draws = {}
    for which in ("jax", "port"):
        out = str(w["root"] / f"video_{which}" / "clip_out.mp4")
        draws[which] = []
        _run_demo(which, ["--video-input", clip, "--output", out, "--frame-batch", str(FRAME_BATCH),
                          "--support-index", index, "--params", w["npz"], "--confidence", "0.0", *TINY],
                  draws[which])
        assert _frames(out) == FRAMES
    assert len(draws["port"]) == len(draws["jax"]) == FRAMES
    for g, r in zip(draws["port"], draws["jax"]):
        _assert_match(g, r)
