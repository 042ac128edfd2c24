"""The plain reference against the program's CPU path (its plain twins of
both kernels), in float32 on a small canvas: the same weights, shots and
frames give the same detections."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_port.harness import compare, frames, weights
from bench_port.harness.serving import json_normal
from bench_port.reference import model as M
from bench_port.reference.serving import Reference, resized_size

CASES = {"vovnet": ("serving_vovnet", ["compute_dtype=float32"]), "dla": ("finetune_dla", ["use_pallas_cgm=True"])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_program_on_the_cpu(case):
    from faster_orefsdet_tpu_torch.config import apply_overrides, get_config
    from faster_orefsdet_tpu_torch.pipelines.inference import build_pinned_serving_fn
    from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache

    preset, overrides = CASES[case]
    cfg = apply_overrides(get_config(preset), overrides + ["input.min_size_test=128"])
    model = json_normal(dataclasses.asdict(cfg))
    with torch.device("meta"):
        template = M.Detector(model).state_dict()
    sd = weights.seeded_state_dict(template, 2**31 + 17, cfg.centernet.prior_prob, "cpu")
    shots, boxes = frames.support_shots(5, 3, 64, 64, cfg.input.pixel_mean, cfg.input.pixel_std, "cpu")
    clip = frames.belt_frames(5, 2, (96, 128), (1, 3), "cpu")

    ref = Reference(model, sd, shots, boxes, "cpu")
    rb, rs, rv = ref(clip)
    fn, canvas = build_pinned_serving_fn(cfg, sd, build_support_cache(cfg, sd, shots, boxes, device="cpu"),
                                         (96, 128), device="cpu")
    det = fn(clip)
    assert canvas == (128, 192)
    for i in range(2):
        assert int(rv[i].sum()) == int(det.valid[i].sum()) > 0
        share = compare.unmatched_share(det.boxes[i].numpy(), det.scores[i].numpy(), det.valid[i].numpy(),
                                        rb[i].numpy(), rs[i].numpy(), rv[i].numpy())
        assert share == 0.0
        np.testing.assert_allclose(torch.sort(det.scores[i]).values.numpy(), torch.sort(rs[i]).values.numpy(),
                                   atol=1e-5)
    # the reference recorded each kernel site's work for the yardstick
    assert len(ref.record["k1"]) == 3 and ref.record["k2_decode"][0][0] == min(
        cfg.static.nms_budget_test, 3 * cfg.centernet.pre_nms_topk_test,
        sum((128 // s) * (192 // s) for s in (8, 16, 32)))


def test_unmatched_share_counts_moved_missing_and_rescored():
    b = np.asarray([[0, 0, 100, 100], [200, 200, 400, 500], [50, 50, 300, 300]], np.float64)
    s = np.asarray([0.9, 0.5, 0.3])
    v = np.asarray([True, True, True])
    assert compare.unmatched_share(b, s, v, b, s, v) == 0.0
    assert compare.unmatched_share(b + 0.2, s + 0.001, v, b, s, v) == 0.0  # rounding
    moved = b.copy()
    moved[1] += 4.0
    assert compare.unmatched_share(moved, s, v, b, s, v) == pytest.approx(1 / 3)
    assert compare.unmatched_share(b, s, np.asarray([True, True, False]), b, s, v) == pytest.approx(1 / 3)
    assert compare.unmatched_share(b, s + np.asarray([0, 0.2, 0]), v, b, s, v) == pytest.approx(1 / 3)
    assert compare.numbers([0.0, 0.5]) == {"unmatched_mean": 0.25, "unmatched_worst": 0.5}


def test_model_flops_leave_roialign_out():
    from torch.utils.flop_counter import FlopCounterMode

    from bench_port.counts import flops
    from faster_orefsdet_tpu_torch.config import apply_overrides, get_config

    cfg = apply_overrides(get_config("serving_vovnet"), ["input.min_size_test=128"])
    model = json_normal(dataclasses.asdict(cfg))
    with torch.device("meta"):
        template = M.Detector(model).state_dict()
    sd = weights.seeded_state_dict(template, 3, cfg.centernet.prior_prob, "cpu")
    shots, boxes = frames.support_shots(3, 2, 64, 64, cfg.input.pixel_mean, cfg.input.pixel_std, "cpu")
    ref = Reference(model, sd, shots, boxes, "cpu")
    clip = frames.belt_frames(3, 2, (96, 128), (1, 3), "cpu")
    with FlopCounterMode(display=False) as counter:
        ref(clip)
    counts = counter.get_flop_counts()
    total, pooled = sum(counts["Global"].values()), sum(counts["RoiPool"].values())
    # the resize to the canvas: two products with dense weights a frame, [rh, H] and [W, rw]
    (h, w), (rh, rw) = clip.shape[-2:], resized_size(*clip.shape[-2:], 128, cfg.input.max_size_test)
    resize = 2 * 2 * 3 * (rh * h * w + rh * w * rw)
    assert 0 < pooled < total
    assert flops.per_image(ref, clip) == (total - pooled - resize) / 2
