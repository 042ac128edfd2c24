"""AsyncPredictor on the CPU: at depth 1 and 3, with 0 and 2 readback
workers, it gives each frame's own sequential result (host preprocessing,
the pinned function, rescaling to the frame), in input order."""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.pipelines.async_predictor import AsyncPredictor
from faster_orefsdet_tpu_torch.pipelines.preprocess import ceil_to, preprocess_host, resize_shortest_edge_size
from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache
from faster_orefsdet_tpu_torch.utils.params import init_params

import torch_budget  # noqa: F401 (the suite's torch thread budget)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("finetune_vovnet")
    cfg = cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=128, post_nms_topk_test=32),
        roi=dataclasses.replace(cfg.roi, detections_per_image=24),
        input=dataclasses.replace(cfg.input, min_size_test=96, max_size_test=160),
    )
    g = np.random.default_rng(0)
    cache = SupportCache(*(torch.from_numpy((0.5 * g.standard_normal((s, s, 128))).astype(np.float32))
                           for s in (32, 16, 8, 8, 4)))
    params = init_params(cfg, seed=1)
    mean = np.asarray(cfg.input.pixel_mean, np.float32)
    # mixed frame sizes: canvases (96, 128) and (128, 96)
    sizes = [(120, 160), (100, 150), (160, 120), (120, 160), (96, 128), (130, 100)]
    frames = [np.clip(np.rint(mean + 8.0 * g.standard_normal((*s, 3))), 0, 255).astype(np.uint8) for s in sizes]
    sequential = AsyncPredictor(cfg, params, cache, device="cpu")
    ref = []
    inp = cfg.input
    for f in frames:
        nh, nw = resize_shortest_edge_size(*f.shape[:2], inp.min_size_test, inp.max_size_test)
        canvas, hw, (sy, sx) = preprocess_host(f, inp.min_size_test, inp.max_size_test,
                                               (ceil_to(nh), ceil_to(nw)), inp.pixel_mean, inp.pixel_std)
        packed = sequential._pinned(canvas, torch.tensor([float(hw[0]), float(hw[1])])).numpy()
        valid = packed[:, 6] > 0.5
        ref.append({"boxes": packed[valid, :4] * np.asarray([sx, sy, sx, sy]), "scores": packed[valid, 4]})
    return cfg, params, cache, frames, ref


@pytest.mark.parametrize("depth,workers", [(1, 0), (1, 2), (3, 0), (3, 2)])
def test_async_predictor_in_order(setup, depth, workers):
    cfg, params, cache, frames, ref = setup
    pred = AsyncPredictor(cfg, params, cache, depth=depth, readback_workers=workers, device="cpu")
    got = list(pred.run(iter(frames)))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(r["scores"]) > 0
        np.testing.assert_array_equal(g["boxes"], r["boxes"])
        np.testing.assert_array_equal(g["scores"], r["scores"])


def test_async_predictor_raises_a_producer_error(setup):
    cfg, params, cache, frames, _ = setup
    pred = AsyncPredictor(cfg, params, cache, depth=2, canvas_hw=(64, 64), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        list(pred.run(frames))


def test_async_predictor_stops_its_producer_early(setup):
    cfg, params, cache, frames, ref = setup

    def endless():
        while True:
            yield frames[0]

    run = AsyncPredictor(cfg, params, cache, depth=2, device="cpu").run(endless())
    first = next(run)
    np.testing.assert_array_equal(first["scores"], ref[0]["scores"])
    closer = threading.Thread(target=run.close)  # joins the producer thread
    closer.start()
    closer.join(timeout=60)
    assert not closer.is_alive()
    assert not any(t.name == "AsyncPredictor-producer" for t in threading.enumerate())


def test_async_predictor_stress(setup):
    """More read-back workers than cores and a short switch interval: the
    results still come back complete and in input order."""
    cfg, params, cache, frames, ref = setup
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pred = AsyncPredictor(cfg, params, cache, depth=4, readback_workers=4 * (os.cpu_count() or 1),
                              device="cpu")
        got = list(pred.run(frames * 3))
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 3 * len(ref)
    for g, r in zip(got, ref * 3):
        np.testing.assert_array_equal(g["scores"], r["scores"])
