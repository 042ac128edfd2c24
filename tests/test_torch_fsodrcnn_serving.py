"""The AttentionRPN baseline (FsodRCNN over ResNet-50 C4) served on raw
frames by ``pipelines.attention_rpn.build_pinned_baseline_serving_fn``, on
the CPU (where the pinned function runs its eager path): against the
benchmark's plain reference (``bench_port/reference/fsod_rcnn.py``), batch
against single images, its stage spans, and the body a CUDA graph captures
on the card.

Size: ResNet-50 at full width, 96x128 uint8 frames served at the test size
96 (``InputConfig``: 96x128 resized and canvas, res4 6x8, 720 anchors), 3
shots of 64 px, pre-NMS 6000 (so every anchor), post-NMS 8. Weights: the
benchmark's seeded rule for this model (``bench_port/harness/fsod_weights``:
the heads at their published initialization, the score layers a further
1e-2 smaller, so that the foreground probabilities stay off 0 and 1).

Tolerances: against the reference, every frame's unmatched share 0 (the
benchmark's comparison: IoU >= 0.98 and |dscore| <= 0.05) and the sorted
scores within 1e-5; batch 2 against two single-frame calls of
``baseline_inference_single``, scores and boxes within 1e-5 (convolutions
at batch 2 and 1 may sum in another order).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from bench_port.harness import compare, frames
from bench_port.harness.fsod_weights import seeded_state_dict
from bench_port.reference.fsod_rcnn import Reference
from faster_orefsdet_tpu_torch.config import InputConfig
from faster_orefsdet_tpu_torch.models.attention_rpn import FsodRCNN
from faster_orefsdet_tpu_torch.ops import nms_cuda
from faster_orefsdet_tpu_torch.pipelines import attention_rpn as tpipe
from faster_orefsdet_tpu_torch.pipelines.inference import pack_detections
from faster_orefsdet_tpu_torch.pipelines.preprocess import preprocess_device
from faster_orefsdet_tpu_torch.structures.instances import Detections
from test_torch_pinned import CaptureSafety, _opaque
import torch_budget  # noqa: F401 (the suite's torch thread budget)

FRAME_HW, SHOTS, SHOT = (96, 128), 3, 64
STAGES = ["preprocess", "features", "attention_rpn", "proposals", "roi_pool", "res5", "relation", "detections"]
SCORE_TOL = 1e-5
SEED = 4000000011


@pytest.fixture(scope="module")
def served():
    cfg = tpipe.BaselineConfig(rpn_pre_nms_topk_test=6000, rpn_post_nms_topk_test=8, support_shot=SHOTS)
    icfg = InputConfig(min_size_test=FRAME_HW[0], max_size_test=1000)
    with torch.device("meta"):
        template = FsodRCNN(depth=cfg.depth).state_dict()
    state = seeded_state_dict(template, SEED, "cpu")
    shots, boxes = frames.support_shots(SEED, SHOTS, SHOT, SHOT, icfg.pixel_mean, icfg.pixel_std, "cpu")
    pool = frames.belt_frames(SEED, 2, FRAME_HW, (1, 6), "cpu")
    cache = tpipe.build_baseline_cache(cfg, state, shots, boxes, device="cpu")
    fn, canvas_hw = tpipe.build_pinned_baseline_serving_fn(cfg, state, cache, FRAME_HW, icfg, device="cpu")
    return dict(cfg=cfg, icfg=icfg, state=state, shots=shots, boxes=boxes, pool=pool, cache=cache, fn=fn,
                canvas_hw=canvas_hw, det=fn(pool))


def _sorted_valid_scores(scores, valid):
    return np.sort(np.asarray(scores)[np.asarray(valid)])[::-1]


def test_serving_matches_the_plain_reference(served):
    """The raw-frame function against the benchmark's float32 reference on
    the same frames, weights and shots."""
    s = served
    assert s["canvas_hw"] == FRAME_HW
    config = {"model": json.loads(json.dumps(dataclasses.asdict(s["cfg"]))),
              "input": json.loads(json.dumps(dataclasses.asdict(s["icfg"])))}
    ref = Reference(config, s["state"], s["shots"], s["boxes"], "cpu")
    rb, rs, rv = (t.numpy() for t in ref(s["pool"]))
    packed = pack_detections(s["det"]).numpy()
    assert packed.shape == (2, 8, 7)
    for i in range(2):
        got = packed[i]
        assert got[:, 6].sum() > 0  # detections to compare
        assert compare.unmatched_share(got[:, :4], got[:, 4], got[:, 6] > 0.5, rb[i], rs[i], rv[i]) == 0.0
        ours, theirs = _sorted_valid_scores(got[:, 4], got[:, 6] > 0.5), _sorted_valid_scores(rs[i], rv[i])
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=SCORE_TOL)
        # scores away from 0 and 1, as the weight rule intends
        assert 0.05 < ours.min() and ours.max() < 0.99
    # the reference recorded both NMS calls: every anchor, then the post-NMS set
    assert [k for k, _ in ref.record["k2_rpn"]] == [720] and [k for k, _ in ref.record["k2_final"]] == [8]


def test_batch_equals_single_images(served):
    """Batch 2 through the raw-frame function against each frame's canvas
    through ``baseline_inference_single`` (the B = 1 case of the same path)."""
    s = served
    model = tpipe.make_fsod_rcnn(s["cfg"], s["state"], device="cpu")
    canvases = preprocess_device(s["pool"], FRAME_HW, s["canvas_hw"], s["icfg"].pixel_mean, s["icfg"].pixel_std)
    hw = torch.tensor([float(FRAME_HW[0]), float(FRAME_HW[1])])
    for i in range(2):
        one = tpipe.baseline_inference_single(model, s["cache"], canvases[i], hw, s["cfg"])
        assert tuple(one.boxes.shape) == (8, 4)
        got = Detections(*(t[i] for t in s["det"]))
        assert torch.equal(one.valid, got.valid) and torch.equal(one.classes, got.classes)
        torch.testing.assert_close(one.scores, got.scores, rtol=0, atol=SCORE_TOL)
        torch.testing.assert_close(one.boxes, got.boxes, rtol=SCORE_TOL, atol=SCORE_TOL)


def test_eager_profile_names_the_stages_in_order(served):
    s = served
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        s["fn"](s["pool"][:1])
    events = sorted((e for e in prof.function_events if e.name in STAGES), key=lambda e: e.time_range.start)
    assert [e.name for e in events] == STAGES


def test_the_served_body_is_capture_safe(served, monkeypatch):
    """The body the card captures (``test_torch_pinned.CaptureSafety``): no
    host sync, no data-sized op, nothing made from host data."""
    monkeypatch.setattr(nms_cuda, "nms_mask_plain", _opaque(nms_cuda.nms_mask_plain))
    s = served
    run = s["fn"].run
    run(s["pool"])
    with CaptureSafety() as mode:
        run(s["pool"])
    assert mode.refused == []


def test_the_serving_fn_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.build_pinned_baseline_serving_fn(tpipe.BaselineConfig(), None, None, FRAME_HW, InputConfig())
