"""CenterNet-S4 over DLA-34-DCN (``backbone_name="dla_seg"`` in
``pipelines/onestage.OneStageCenterNet``) on the CPU, where the pinned
function runs its eager path: against the benchmark's plain reference
(``bench_port/reference/onestage_dla.py``), the raw-frame pinned builder
against the eager path, its stage spans and capture safety, the VoVNet
branch as it was, the refusals, and the deformable conv's f32 sample
coordinates under bf16 offsets.

Size: DLA-34 and DLA-Up at full width, 96x120 uint8 frames served at the
test size 128 (a 128x160 canvas, the stride-4 map 32x40), batch 2, at 3
classes and at COCO's 80. Weights: the benchmark's seeded rule for this
model (``bench_port/harness/onestage_weights``: offsets 1-2 px off the grid
from the offset convs' bias, the head at CenterNet2's initialization).

Tolerances, float32 on both sides: the head's maps within 1e-5 of each
map's largest |value|, and the detections by the benchmark's comparison
(IoU >= 0.98, |dscore| <= 0.05, a box paired only within its class) with
every frame's unmatched share 0 and the sorted scores within 1e-6. The two
sides sum in other orders (the reference contracts the deformable conv a
tap at a time, the program all nine taps at once; the program's convs run
channels-last): about 1e-7 of a value a layer, which the weight rule keeps
from growing through the network. The pinned function equals the eager
path bit for bit (the same ops on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bench_port.harness import compare, frames
from bench_port.harness.onestage_weights import seeded_state_dict
from bench_port.harness.serving import json_normal
from bench_port.reference.onestage_dla import Reference
from bench_port.reference.serving import preprocess
from faster_orefsdet_tpu_torch.config import apply_overrides, get_config
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector
from faster_orefsdet_tpu_torch.ops import deform_conv, nms, nms_cuda
from faster_orefsdet_tpu_torch.pipelines import onestage
from faster_orefsdet_tpu_torch.pipelines.preprocess import frame_geometry, preprocess_device
from test_torch_pinned import CaptureSafety, _opaque
import torch_budget  # noqa: F401 (the suite's torch thread budget)

FRAME_HW = (96, 120)
STAGES = ["preprocess", "backbone", "decoder", "head", "decode"]
MAP_TOL, SCORE_TOL = 1e-5, 1e-6
SEED = 4000000021
DLA_SEG = ["backbone_name=dla_seg", "centernet.in_features=('dla2',)", "centernet.fpn_strides=(4,)",
           "centernet.sizes_of_interest=((0, 1000000),)", "centernet.only_proposal=False",
           "centernet.with_agn_hm=False", "centernet.nms_thresh_test=0.6", "centernet.post_nms_topk_test=100",
           "input.min_size_test=128", "input.pixel_mean=(123.675, 116.28, 103.53)",
           "input.pixel_std=(58.395, 57.12, 57.375)"]


def dla_seg_config(num_classes: int):
    return apply_overrides(get_config("finetune_dla"), DLA_SEG + [f"centernet.num_classes={num_classes}"])


@pytest.fixture(scope="module", params=[3, 80], ids=["3classes", "80classes"])
def served(request):
    cfg = dla_seg_config(request.param)
    model = json_normal(dataclasses.asdict(cfg))
    state = seeded_state_dict(model, SEED + request.param, "cpu")
    clip = frames.belt_frames(SEED, 2, FRAME_HW, (1, 6), "cpu")
    fn, canvas_hw = onestage.build_pinned_onestage_serving_fn(cfg, state, FRAME_HW, device="cpu")
    return dict(cfg=cfg, model=model, state=state, clip=clip, fn=fn, canvas_hw=canvas_hw, det=fn(clip))


def _apart(boxes, classes):
    return np.asarray(boxes, np.float64) + 1e4 * np.asarray(classes, np.float64)[:, None]


def test_program_matches_the_plain_reference(served):
    s = served
    assert s["canvas_hw"] == (128, 160)
    ref = Reference(s["model"], s["state"], "cpu")
    canvases, resized_hw, _ = preprocess(s["clip"], s["model"])
    model = onestage.make_onestage(s["cfg"], s["state"], device="cpu")
    with torch.no_grad():
        got, want = model(canvases), ref.det(canvases)
    (clss, agn_hms, regs), (ref_clss, ref_agn_hms, ref_regs) = got, want
    assert agn_hms == ref_agn_hms == [None]  # the source's one-stage head has no agnostic heatmap
    assert clss[0].shape == (2, s["cfg"].centernet.num_classes, 32, 40) and regs[0].shape == (2, 4, 32, 40)
    for g, w in ((clss[0], ref_clss[0]), (regs[0], ref_regs[0])):
        torch.testing.assert_close(g, w, rtol=0, atol=MAP_TOL * float(w.abs().max()))

    rb, rs, rc, rv = ref(s["clip"])
    det = s["det"]
    for i in range(2):
        assert int(rv[i].sum()) == int(det.valid[i].sum()) > 50
        share = compare.unmatched_share(_apart(det.boxes[i], det.classes[i]), det.scores[i].numpy(),
                                        det.valid[i].numpy(), _apart(rb[i], rc[i]), rs[i].numpy(), rv[i].numpy())
        assert share == 0.0
        np.testing.assert_allclose(np.sort(det.scores[i].numpy()), np.sort(rs[i].numpy()), rtol=0, atol=SCORE_TOL)
    # the reference recorded the NMS call and the 16 deformable calls' shapes for the yardsticks
    assert ref.record["k2"][0][0] == 1000 and len(ref.record["dcn"][0]) == 16
    assert sum(1 for b, cin, h, w, cout, ho, wo in ref.record["dcn"][0] if (h, w, cin, cout) == (32, 40, 64, 64)) == 5


def test_pinned_raw_frames_equal_the_eager_path(served):
    s = served
    cfg = s["cfg"]
    geo = frame_geometry(*FRAME_HW, cfg.input)
    canvases = preprocess_device(s["clip"], geo.resized_hw, geo.canvas_hw, tuple(cfg.input.pixel_mean),
                                 tuple(cfg.input.pixel_std))
    eager = onestage.build_onestage_inference_fn(cfg, s["state"], device="cpu")(canvases, geo.resized_hw)
    sy, sx = geo.scale_hw
    det = s["det"]
    assert torch.equal(det.boxes, eager.boxes * torch.tensor([sx, sy, sx, sy]))
    for name in ("scores", "classes", "valid"):
        assert torch.equal(getattr(det, name), getattr(eager, name))


def test_eager_profile_names_the_stages_in_order(served):
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        served["fn"](served["clip"][:1])
    events = sorted((e for e in prof.function_events if e.name in STAGES), key=lambda e: e.time_range.start)
    assert [e.name for e in events] == STAGES


def test_the_served_body_is_capture_safe(served, monkeypatch):
    """The body the card captures (``test_torch_pinned.CaptureSafety``): no
    host sync, no data-sized op, nothing made from host data."""
    monkeypatch.setattr(nms_cuda, "nms_mask_plain", _opaque(nms_cuda.nms_mask_plain))
    run = served["fn"].run
    run(served["clip"])
    with CaptureSafety() as mode:
        run(served["clip"])
    assert mode.refused == []


def _vovnet_onestage():
    cfg = get_config("finetune_vovnet")
    return cfg.replace(centernet=dataclasses.replace(cfg.centernet, only_proposal=False, num_classes=3))


def test_the_vovnet_branch_is_unchanged():
    """backbone_name="vovnet_fpn" builds VoVNet + FPN + the head under the
    same names as before, and its forward is that composition, bit for bit."""
    torch.manual_seed(0)
    model = onestage.OneStageCenterNet(_vovnet_onestage()).eval()
    assert {k.split(".")[0] for k in model.state_dict()} == {"backbone", "fpn", "head"}
    assert not any("dla" in k or "offset" in k for k in model.state_dict())
    x = torch.randn(1, 3, 128, 160)
    with torch.no_grad():
        got = model(x)
        feats = model.fpn(model.backbone(x.contiguous(memory_format=torch.channels_last)))
        want = model.head([feats[level] for level in model.cfg.centernet.in_features])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def test_the_refusals():
    cfg = dla_seg_config(3)
    with pytest.raises(ValueError, match="dla_seg"):
        CenterNet2Detector(cfg)
    with pytest.raises(ValueError, match="float32"):
        onestage.OneStageCenterNet(cfg.replace(compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="in_features"):
        onestage.OneStageCenterNet(cfg.replace(centernet=dataclasses.replace(cfg.centernet, in_features=("p3",))))
    with pytest.raises(ValueError, match="one-stage detector has"):
        onestage.OneStageCenterNet(cfg.replace(backbone_name="resnet_fpn"))


def test_the_serving_fn_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        onestage.build_pinned_onestage_serving_fn(dla_seg_config(3), None, FRAME_HW)


def test_sample_coordinates_are_f32_under_bf16_offsets():
    """bf16 offsets sample where their f32 values do: in bf16 the
    coordinates above 128 would round to a pixel or more (the map here is
    300 wide) and every fraction below 2^-8 of them would be lost."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4, 12, 300, generator=g)
    offsets = (0.5 * torch.randn(1, 18, 12, 300, generator=g)).to(torch.bfloat16)
    mask = torch.rand(1, 9, 12, 300, generator=g)
    weight = torch.randn(5, 4, 3, 3, generator=g)
    got = deform_conv.deform_conv2d(x, offsets, weight, mask)
    want = deform_conv.deform_conv2d(x, offsets.float(), weight, mask)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_the_counter_counts_only_card_calls():
    before = (deform_conv.counter.calls, deform_conv.counter.samples)
    x = torch.randn(2, 4, 6, 7)
    deform_conv.deform_conv2d(x, torch.zeros(2, 18, 6, 7), torch.randn(3, 4, 3, 3), torch.ones(2, 9, 6, 7))
    assert (deform_conv.counter.calls, deform_conv.counter.samples) == before


def test_open_fault_the_class_offset_nms_decides_a_near_tie_by_rounding():
    """An open fault, kept in view here: the class-aware NMS
    (``ops.nms.batched_nms_mask``, which K2 matches bit for bit on the card)
    shifts each box by its class times the row's largest coordinate + 1, in
    float32. At 80 classes on the 608x832 canvas the shift reaches 79 x 832
    = 65,728 px, where float32's step is 2^-7 px, so two boxes of one class
    whose IoU lies within about 1e-4 of the threshold are kept or
    suppressed by rounding. Two 64-px boxes of class 79, four stride-4 cells
    apart, at IoU 0.59996 (under the cell's 0.6): a greedy NMS of their own
    class keeps both, and so does the class-aware NMS at class 0, where
    nothing is shifted; at class 79 it suppresses the second. The
    benchmark's one-stage cell draws 24-px boxes, whose neighbours' IoUs lie
    0.07 or more from the threshold, so its runs cannot show this fault.
    The fix compares classes in K2 and its twin instead of shifting the
    coordinates; this test then fails, and its last assertion becomes
    keep == [True, True, True]."""
    boxes = torch.tensor([[[130.02976989746094, 501.9582214355469, 194.0242919921875, 565.9852294921875],
                           [146.02569580078125, 502.00244140625, 209.97735595703125, 565.9743041992188],
                           [0.0, 0.0, 831.0, 607.0]]])
    scores, valid = torch.tensor([[0.9, 0.8, 0.1]]), torch.ones(1, 3, dtype=torch.bool)
    own_class = nms.nms_mask(boxes[:, :2], scores[:, :2], valid[:, :2], 0.6)
    assert own_class.tolist() == [[True, True]]
    unshifted = nms.batched_nms_mask(boxes, scores, torch.tensor([[0, 0, 1]]), valid, 0.6)
    assert unshifted.tolist() == [[True, True, True]]
    shifted = nms.batched_nms_mask(boxes, scores, torch.tensor([[79, 79, 0]]), valid, 0.6)
    assert shifted.tolist() == [[True, False, True]]  # the open fault
