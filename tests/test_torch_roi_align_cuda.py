"""The ROIAlign gather (``ops.roi_align_cuda``, K3): its CPU route, the dense
composition of ``ops.roi_align`` bit for bit, its refusals and counters, the
poolers' route by what the input needs, and, on the card, the kernel
against the dense plain version at the three serving shapes.

The tests marked ``card`` skip without a CUDA card; run them there with
``python -m pytest --noconftest tests/test_torch_roi_align_cuda.py`` (the
suite's conftest imports JAX, which the card's machine does not have).
On the card the kernel is held against the plain version run on the CPU:
f32 within 1e-5 + 1e-5 |ref| (sums of the same products in another order);
bf16 no further from the f64 result than the dense bf16 path (which rounds
an intermediate to bf16) plus one bf16 ulp of the value plus the f32
tolerance (near zero an f32 sum of terms of order 1 is off by more than a
bf16 ulp of its value)."""

import math

import numpy as np
import pytest
import torch

from faster_orefsdet_tpu_torch.config import ROIConfig
from faster_orefsdet_tpu_torch.models.cascade_roi import ROI_STRIDES, DSACascadeHead
from faster_orefsdet_tpu_torch.ops import _native, roi_align_cuda
from faster_orefsdet_tpu_torch.ops.roi_align import assign_levels, multilevel_roi_align, roi_align

import torch_budget  # noqa: F401 (the suite's torch thread budget)

BASE_STRIDE = 16  # the baseline's res4
CPU_CANVAS = (256, 384)  # boxes of every level: sizes past 224 and 448 px


def _boxes(g, b, r, hw, huge):
    """[b, r, 4] boxes over an hw canvas, from a few pixels to past the
    canvas, with the edge cases first: wholly outside (both sides), partly
    outside, degenerate (zero width and height, zero width), the whole
    canvas, and one `huge` pixels wide (bins past the sampling cap of 8)."""
    h, w = hw
    x1, y1 = g.uniform(-0.1 * w, w, (b, r)), g.uniform(-0.1 * h, h, (b, r))
    bw = np.exp(g.uniform(np.log(2.0), np.log(1.2 * max(h, w)), (b, r)))
    bh = bw * np.exp(g.uniform(-1.0, 1.0, (b, r)))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    boxes[:, :7] = [[-60, -50, -12, -7], [w + 10, h + 10, w + 70, h + 50], [w - 6, h - 4, w + 40, h + 30],
                    [10.5, 12.25, 10.5, 12.25], [3.3, 4.7, 3.3, 90.1], [0, 0, w, h], [-5, -8, huge, 0.8 * huge]]
    return torch.tensor(boxes, dtype=torch.float32)


def _inputs(seed, b, r, c, hw, strides, dtype, device="cpu"):
    g = np.random.default_rng(seed)
    feats = [torch.tensor(g.standard_normal((b, c, hw[0] // s, hw[1] // s)), dtype=torch.float32).to(device, dtype)
             for s in strides]
    return feats, _boxes(g, b, r, hw, huge=9.0 * 14 * strides[-1]).to(device)


def _levels(boxes, strides=ROI_STRIDES):
    lo = int(math.log2(strides[0]))
    return (assign_levels(boxes, lo, int(math.log2(strides[-1]))) - lo).contiguous()


# ---- on the CPU: the dense composition, bit for bit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [1, 3])
@pytest.mark.parametrize("p", [7, 8, 14])
def test_cpu_gather_equals_dense(p, n_levels, dtype):
    strides = ROI_STRIDES if n_levels == 3 else (BASE_STRIDE,)
    feats, boxes = _inputs(p * 10 + n_levels, 2, 16, 8, CPU_CANVAS, strides, dtype)
    if n_levels == 3:
        lv = _levels(boxes)
        assert set(lv.flatten().tolist()) == {0, 1, 2}
        ref = multilevel_roi_align(feats, boxes, strides, p, 0)
        got = roi_align_cuda.roi_align_gather(feats, boxes, lv, [1.0 / s for s in strides], p, 0)
        pooled = roi_align_cuda.multilevel_roi_pool(feats, boxes, strides, p, 0)
    else:
        ref = roi_align(feats[0], boxes, 1.0 / BASE_STRIDE, p, 0)
        got = roi_align_cuda.roi_align_gather(feats, boxes, None, [1.0 / BASE_STRIDE], p, 0)
        pooled = roi_align_cuda.roi_pool(feats[0], boxes, 1.0 / BASE_STRIDE, p, 0)
    assert got.dtype == dtype and got.shape == (2, 16, p, p, 8)
    assert torch.equal(got, ref) and torch.equal(pooled, ref)


def test_inputs_that_require_grad_are_refused():
    feats, boxes = _inputs(1, 1, 8, 4, CPU_CANVAS, ROI_STRIDES, torch.float32)
    lv, scales = _levels(boxes), [1.0 / s for s in ROI_STRIDES]
    grad_feats = [f.clone().requires_grad_() for f in feats]
    for f, b in ((grad_feats, boxes), (feats, boxes.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="no backward"):
            roi_align_cuda.roi_align_gather(f, b, lv, scales, 8, 0)
        with torch.no_grad():
            roi_align_cuda.roi_align_gather(f, b, lv, scales, 8, 0)


def _malformed(feats, boxes, lv):
    three = [1.0 / s for s in ROI_STRIDES]
    return {
        "boxes_f64": (feats, boxes.double(), lv, three, 8, 0),
        "boxes_strided": (feats, boxes[:, ::2], lv[:, ::2], three, 8, 0),
        "boxes_xywh_missing": (feats, boxes[..., :3].contiguous(), lv, three, 8, 0),
        "boxes_other_batch": (feats, boxes[:1].contiguous(), lv[:1].contiguous(), three, 8, 0),
        "levels_int64": (feats, boxes, lv.long(), three, 8, 0),
        "levels_strided": (feats, boxes, lv.t().contiguous().t(), three, 8, 0),
        "levels_missing": (feats, boxes, None, three, 8, 0),
        "maps_f16": ([f.half() for f in feats], boxes, lv, three, 8, 0),
        "maps_mixed_dtypes": ([feats[0].bfloat16()] + feats[1:], boxes, lv, three, 8, 0),
        "maps_other_channels": (feats[:2] + [feats[2][:, :2]], boxes, lv, three, 8, 0),
        "maps_3d": ([f[0] for f in feats], boxes, lv, three, 8, 0),
        "scales_short": (feats, boxes, lv, three[:2], 8, 0),
        "output_size_0": (feats, boxes, lv, three, 0, 0),
        "ratio_negative": (feats, boxes, lv, three, 8, -1),
    }


MALFORMED = ("boxes_f64", "boxes_strided", "boxes_xywh_missing", "boxes_other_batch", "levels_int64",
             "levels_strided", "levels_missing", "maps_f16", "maps_mixed_dtypes", "maps_other_channels", "maps_3d",
             "scales_short", "output_size_0", "ratio_negative")


@pytest.mark.parametrize("case", MALFORMED)
def test_malformed_inputs_raise(case):
    feats, boxes = _inputs(2, 2, 8, 4, CPU_CANVAS, ROI_STRIDES, torch.float32)
    args = _malformed(feats, boxes, _levels(boxes))[case]
    with pytest.raises(ValueError, match="roi_align_gather"):
        roi_align_cuda.roi_align_gather(*args)


def test_counters_stay_zero_on_cpu():
    before = (roi_align_cuda.counter.launches, roi_align_cuda.counter.dense_calls)
    feats, boxes = _inputs(3, 1, 8, 4, CPU_CANVAS, ROI_STRIDES, torch.float32)
    roi_align_cuda.multilevel_roi_pool(feats, boxes, ROI_STRIDES, 8, 0)
    roi_align_cuda.roi_pool(feats[0], boxes, 0.125, 8, 0)
    grad_feats = [f.clone().requires_grad_() for f in feats]
    roi_align_cuda.multilevel_roi_pool(grad_feats, boxes, ROI_STRIDES, 8, 0).sum().backward()
    roi_align_cuda.roi_pool(grad_feats[0], boxes, 0.125, 8, 0)
    assert (roi_align_cuda.counter.launches, roi_align_cuda.counter.dense_calls) == before


def _as_cuda(monkeypatch):
    """Tensors read as CUDA tensors, and the kernel's library cannot be
    loaded: a call that reaches the kernel raises RuntimeError."""

    def no_library(name):
        raise RuntimeError(f"no {name} library in this test")

    monkeypatch.setattr(_native, "library", no_library)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def test_cuda_tensors_launch_or_raise(monkeypatch):
    """A CUDA tensor goes to the kernel (here a library that cannot be
    loaded), so the call raises and never falls back to the plain version.
    The poolers route inputs that need a gradient to the dense composition
    and count those calls on CUDA."""
    plain_calls = []
    plain = roi_align_cuda.roi_align_plain
    monkeypatch.setattr(roi_align_cuda, "roi_align_plain", lambda *a: plain_calls.append(1) or plain(*a))
    feats, boxes = _inputs(5, 1, 8, 4, CPU_CANVAS, ROI_STRIDES, torch.float32)
    _as_cuda(monkeypatch)
    before = (roi_align_cuda.counter.launches, roi_align_cuda.counter.dense_calls)
    with pytest.raises(RuntimeError):
        roi_align_cuda.multilevel_roi_pool(feats, boxes, ROI_STRIDES, 8, 0)
    with pytest.raises(RuntimeError):
        roi_align_cuda.roi_pool(feats[0], boxes, 0.125, 8, 0)
    assert (roi_align_cuda.counter.launches, roi_align_cuda.counter.dense_calls) == before and not plain_calls
    grad_feats = [f.clone().requires_grad_() for f in feats]
    roi_align_cuda.multilevel_roi_pool(grad_feats, boxes, ROI_STRIDES, 8, 0)
    roi_align_cuda.roi_pool(grad_feats[0], boxes, 0.125, 8, 0)
    assert (roi_align_cuda.counter.launches, roi_align_cuda.counter.dense_calls) == (before[0], before[1] + 2)
    assert len(plain_calls) == 2


@pytest.mark.parametrize("dtype, channels, fits", [(torch.float32, 6, False), (torch.float32, 12, True),
                                                   (torch.bfloat16, 4, False), (torch.bfloat16, 24, True)])
def test_cuda_channels_fill_16_byte_vectors(monkeypatch, dtype, channels, fits):
    """The kernel reads channels 16 bytes at a time: a CUDA call whose C
    does not fill them is refused (ValueError); one that does reaches the
    kernel. The CPU route takes any C."""
    feats, boxes = _inputs(6, 1, 8, channels, CPU_CANVAS, ROI_STRIDES, dtype)
    lv, scales = _levels(boxes), [1.0 / s for s in ROI_STRIDES]
    assert roi_align_cuda.roi_align_gather(feats, boxes, lv, scales, 8, 0).shape[-1] == channels
    _as_cuda(monkeypatch)
    with pytest.raises(RuntimeError if fits else ValueError, match="library" if fits else "16-byte"):
        roi_align_cuda.roi_align_gather(feats, boxes, lv, scales, 8, 0)


def test_cascade_head_routes_by_what_the_features_need(monkeypatch):
    """The head pools through the dense, differentiable composition when its
    features require grad (training) and through the gather otherwise; on
    the CPU both give the same rows, so the same head route gives the same
    outputs bit for bit. The head's own route (``DSACascadeHead.forward``)
    is the chain where a gradient is wanted, its fold otherwise, equal to
    the chain within f32's reassociation (``test_torch_dsa_fold.py``)."""
    torch.manual_seed(0)
    cfg = ROIConfig()
    head = DSACascadeHead(cfg, channels=16)
    feats, boxes = _inputs(4, 2, 12, 16, CPU_CANVAS, ROI_STRIDES, torch.float32)
    s8 = torch.randn(cfg.pooler_resolution, cfg.pooler_resolution, 16)
    s4 = torch.randn(4, 4, 16)
    calls = []
    gather, dense = roi_align_cuda.roi_align_gather, roi_align_cuda.roi_align_plain
    monkeypatch.setattr(roi_align_cuda, "roi_align_gather", lambda *a: calls.append("gather") or gather(*a))
    monkeypatch.setattr(roi_align_cuda, "roi_align_plain", lambda *a: calls.append("dense") or dense(*a))

    with torch.no_grad():
        served = head(feats, boxes, s8, s4, 0)  # the gather, the fold
    grad_feats = [f.clone().requires_grad_() for f in feats]
    trained = head(grad_feats, boxes, s8, s4, 0)  # the dense composition, the chain
    detached = head(feats, boxes, s8, s4, 0)  # grad mode on, nothing to differentiate on the pooler's inputs: the chain
    head.requires_grad_(False)
    frozen = head(feats, boxes, s8, s4, 0)  # grad mode on, nothing to differentiate at all: the fold
    # the gather's CPU route is the dense composition too; training skips the gather
    assert calls == ["gather", "dense", "dense", "gather", "dense", "gather", "dense"]
    assert torch.equal(trained.scores, detached.scores) and torch.equal(trained.deltas, detached.deltas)
    assert torch.equal(served.scores, frozen.scores) and torch.equal(served.deltas, frozen.deltas)
    for a, b in zip(served, trained):
        assert (a - b.detach()).abs().max() <= 1e-5 * (b.max() - b.min()).detach()
    trained.scores.sum().backward()
    assert all(f.grad is not None and torch.isfinite(f.grad).all() for f in grad_feats)


# ---- on the card: the kernel against the dense plain version


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


# the serving shapes: (batch, ROIs an image, channels, P, canvas, strides)
SHAPES = {
    "vovnet": (8, 256, 128, 8, (320, 448), ROI_STRIDES),
    "dla": (8, 256, 160, 7, (320, 448), ROI_STRIDES),
    "baseline": (8, 100, 1024, 14, (608, 800), (BASE_STRIDE,)),
}


def _card_inputs(name, dtype, device):
    b, r, c, p, hw, strides = SHAPES[name]
    feats, boxes = _inputs(len(name), b, r, c, hw, strides, dtype, device)
    if len(strides) == 3:
        # NCHW for two levels, channels_last memory (read in place) for one
        feats[1] = feats[1].contiguous(memory_format=torch.channels_last)
        lv = _levels(boxes, strides)
        assert set(lv.flatten().tolist()) == {0, 1, 2}
    else:
        lv = None
    return feats, boxes, lv, [1.0 / s for s in strides], p


def _cap_reached(boxes, lv, scales, p):
    scale = torch.tensor(scales, device=boxes.device)[lv.long()] if lv is not None else scales[0]
    return bool((((boxes[..., 2] - boxes[..., 0]) * scale / p) > 8).any())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_the_dense_version(card, name, dtype):
    feats, boxes, lv, scales, p = _card_inputs(name, dtype, card)
    assert _cap_reached(boxes, lv, scales, p)
    before = roi_align_cuda.counter.launches
    got = roi_align_cuda.roi_align_gather(feats, boxes, lv, scales, p, 0)
    torch.cuda.synchronize()
    assert roi_align_cuda.counter.launches == before + 1 and got.dtype == dtype
    got = got.cpu()
    # the plain version on the CPU: on the card PyTorch divides by a scalar
    # through its reciprocal, which moves the dense path's sample positions
    # by an ulp (up to 3.2e-5 on the outputs at the baseline's coordinates)
    feats, boxes, lv = [f.cpu() for f in feats], boxes.cpu(), None if lv is None else lv.cpu()
    ref = roi_align_cuda.roi_align_plain(feats, boxes, lv, scales, p, 0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        return
    ref64 = roi_align_cuda.roi_align_plain([f.double() for f in feats], boxes, lv, scales, p, 0)
    err, dense_err = (got.double() - ref64).abs(), (ref.double() - ref64).abs()
    ulp = torch.where(ref64 == 0, torch.zeros_like(ref64), torch.exp2(torch.floor(torch.log2(ref64.abs())) - 7))
    # the kernel rounds an f32 sum once: the f32 case's tolerance, then one bf16 ulp
    over = err > dense_err + ulp + 1e-5 + 1e-5 * ref64.abs()
    worst = [(float(ref64[i]), float(got[i]), float(ref[i])) for i in map(tuple, over.nonzero()[:5].tolist())]
    assert not over.any(), f"{int(over.sum())} values (f64, kernel, dense): {worst}"


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_is_deterministic_and_replays_bit_for_bit(card, name):
    feats, boxes, lv, scales, p = _card_inputs(name, torch.bfloat16 if name == "vovnet" else torch.float32, card)
    run = lambda: roi_align_cuda.roi_align_gather(feats, boxes, lv, scales, p, 0)  # noqa: E731
    first, second = run(), run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = roi_align_cuda.counter.launches
    with torch.cuda.graph(graph):
        captured = run()
    assert roi_align_cuda.counter.launches == before + 1
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, captured)


@pytest.mark.card
def test_kernel_reads_a_map_off_16_byte_alignment(card):
    """A channels_last view that starts one value past a 16-byte boundary
    (no copy is needed to make it channel-last) is copied to an aligned
    map, and pools as the aligned map does, bit for bit."""
    feats, boxes, lv, scales, p = _card_inputs("dla", torch.float32, card)
    off = []
    for f in feats:
        nhwc = f.permute(0, 2, 3, 1)
        buf = torch.empty(nhwc.numel() + 1, dtype=f.dtype, device=card)
        view = buf[1:].view(nhwc.shape)
        view.copy_(nhwc)
        off.append(view.permute(0, 3, 1, 2))
    assert all(f.data_ptr() % 16 and f.is_contiguous(memory_format=torch.channels_last) for f in off)
    got = roi_align_cuda.roi_align_gather(off, boxes, lv, scales, p, 0)
    assert torch.equal(got, roi_align_cuda.roi_align_gather(feats, boxes, lv, scales, p, 0))
