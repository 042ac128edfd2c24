"""The port's serving entry points against the JAX package, on the CPU:
raw-frame serving, the pinned function, class-aware NMS, stacked caches and
the multiclass query path. The config is the small-budget finetune_vovnet of
``tests/test_multiclass.py`` (pre-NMS top-k 128, 32 proposals, 24
detections, test scale 96 / 160), in f32; the weights are the converted
random checkpoint of ``test_torch_parity``; the support caches are seeded
random maps, the same arrays on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.ops.nms import batched_nms_mask as jax_batched_nms_mask
from faster_orefsdet_tpu.pipelines import inference as jinf
from faster_orefsdet_tpu.pipelines import support_cache as jsc
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.ops import nms, nms_cuda
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache, stack_support_caches
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_composed_parity_full import greedy_match
from test_torch_parity import make_torch_state_dict
from test_torch_slice import _assert_detections_match, _np
import torch_budget  # noqa: F401 (the suite's torch thread budget)

FRAME_HW = (120, 160)
BOX_RTOL, BOX_ATOL, SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-3, 1e-4, 1e-5  # test_multiclass.py's


def _small(cfg):
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=128, post_nms_topk_test=32),
        roi=dataclasses.replace(cfg.roi, detections_per_image=24),
        input=dataclasses.replace(cfg.input, min_size_test=96, max_size_test=160),
    )


def _cache_arrays(seed, scale=0.5):
    g = np.random.default_rng(seed)
    shapes = ((32, 32), (16, 16), (8, 8), (8, 8), (4, 4))
    return [(scale * g.standard_normal((*s, 128))).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def pair():
    jcfg = _small(jax_get_config("finetune_vovnet"))
    cfg = _small(get_config("finetune_vovnet"))
    params = convert_torch_checkpoint(make_torch_state_dict(seed=5))
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    arrays = [_cache_arrays(s) for s in (0, 1, 2)]
    jcaches = [jsc.SupportCache(*map(jnp.asarray, a)) for a in arrays]
    caches = [SupportCache(*map(torch.from_numpy, a)) for a in arrays]
    return dict(jcfg=jcfg, cfg=cfg, params=params, sd=sd, jcaches=jcaches, caches=caches)


def _frames(seed, n):
    # pixels near the mean, as test_torch_slice's: O(1) normalized values
    mean = np.asarray(get_config().input.pixel_mean, np.float32)
    g = np.random.default_rng(seed)
    return np.clip(np.rint(mean + 8.0 * g.standard_normal((n, *FRAME_HW, 3))), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_serving(pair):
    """Two frames through the JAX package's jitted raw-frame serving
    program: (frames, its canvas, its detections)."""
    p = pair
    frames = _frames(10, 2)
    jfn, jcanvas = jinf.build_serving_fn(p["jcfg"], FRAME_HW)
    return frames, tuple(jcanvas), jfn(p["params"], p["jcaches"][0], jnp.asarray(frames))


def _assert_served(det, ref):
    assert det.boxes.shape == (2, 24, 4)
    boxes = det.boxes[det.valid]
    assert torch.isfinite(boxes).all() and (boxes[:, 2] <= FRAME_HW[1] + 1e-3).all()
    assert (boxes[:, 3] <= FRAME_HW[0] + 1e-3).all()
    for i in range(2):
        _assert_detections_match({k: v[i] for k, v in _np(det).items()}, {k: v[i] for k, v in _np(ref).items()})


def test_serving_fn_matches_jax(pair, jax_serving):
    p = pair
    frames, jcanvas, ref = jax_serving
    fn, canvas = tinf.build_serving_fn(p["cfg"], p["sd"], FRAME_HW, device="cpu")
    assert canvas == jcanvas == (96, 128)
    _assert_served(fn(p["caches"][0], torch.from_numpy(frames).permute(0, 3, 1, 2)), ref)
    with pytest.raises(ValueError, match="serves 120x160"):
        fn(p["caches"][0], torch.zeros(1, 3, 96, 128))


def test_pinned_serving_fn_matches_jax(pair, jax_serving):
    """build_pinned_serving_fn (the cache fixed at build time; on the CPU
    the eager path) against the JAX package's jitted build_serving_fn."""
    p = pair
    frames, jcanvas, ref = jax_serving
    fn, canvas = tinf.build_pinned_serving_fn(p["cfg"], p["sd"], p["caches"][0], FRAME_HW, device="cpu")
    assert canvas == jcanvas
    _assert_served(fn(torch.from_numpy(frames).permute(0, 3, 1, 2)), ref)


def test_pinned_cpu_equals_eager(pair):
    """On the CPU the pinned function runs the eager path: the same bits as
    the batch-1 and batched builders, packed or not."""
    p = pair
    cfg, sd, cache = p["cfg"], p["sd"], p["caches"][1]
    g = np.random.default_rng(11)
    img = torch.from_numpy(g.standard_normal((3, 96, 128)).astype(np.float32))
    ref = tinf.build_inference_fn(cfg, sd, device="cpu")(cache, img, (96.0, 120.0))
    pinned = tinf.build_pinned_inference_fn(cfg, sd, cache, device="cpu")
    for got in (pinned(img, (96.0, 120.0)), pinned(img, torch.tensor([96.0, 120.0]))):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    u8 = torch.from_numpy(_frames(12, 2)[:, :96, :128]).permute(0, 3, 1, 2).contiguous()
    hw = torch.tensor([[96.0, 120.0], [80.0, 100.0]])
    ref8 = tinf.build_batched_inference_fn(cfg, sd, device="cpu")(cache, u8, hw)
    packed = tinf.build_pinned_inference_fn(cfg, sd, cache, device="cpu", packed=True)(u8, hw)
    assert torch.equal(packed, tinf.pack_detections(ref8))
    assert not pinned.graphs and pinned.kernel_launches() == {"cgm": 0, "nms": 0}


@pytest.mark.parametrize("k", [0, 1, 37, 300])
def test_batched_nms_mask_matches_jax(k):
    g = np.random.default_rng(k)
    b = 3
    xy = g.uniform(0, 150, (b, k, 2))
    wh = g.uniform(5, 60, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = g.choice(np.asarray([0.3, 0.5, 0.5, 0.8], np.float32), (b, k)) if k == 300 else \
        g.uniform(0, 1, (b, k)).astype(np.float32)
    classes = g.integers(0, 3, (b, k)).astype(np.int32)
    valid = g.uniform(size=(b, k)) < 0.85
    args = [torch.from_numpy(x) for x in (boxes, scores, classes, valid)]
    for thr in (0.5, 0.9):
        plain = nms.batched_nms_mask(*args, thr)
        wrapped = nms_cuda.batched_nms_mask(*args, thr)
        for i in range(b):
            ref = np.asarray(jax_batched_nms_mask(*(jnp.asarray(x[i]) for x in (boxes, scores, classes, valid)), thr))
            np.testing.assert_array_equal(plain[i].numpy(), ref)
            np.testing.assert_array_equal(wrapped[i].numpy(), ref)


def test_batched_nms_mask_cap_on_cuda(monkeypatch):
    """The CUDA path takes K past 2048 (a 9-class request's 2304, 64
    classes' 16384): the kernel library (stubbed here, as there is no card)
    gets the class-offset boxes and a workspace of the size it asks for."""
    calls = []

    class Lib:
        @staticmethod
        def nms_workspace_bytes(b, k):
            return b * k * -(-k // 64) * 8 + 64

        @staticmethod
        def nms_forward(boxes, scores, valid, thr, b, k, workspace, keep, stream):
            calls.append((b, k, thr))
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(nms_cuda._native, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    nms_cuda._workspace_bytes.cache_clear()
    try:
        for k in (2304, 16384):
            before = nms_cuda.counter.launches
            keep = nms_cuda.batched_nms_mask(torch.zeros(1, k, 4), torch.zeros(1, k), torch.arange(k)[None] // 256,
                                             torch.ones(1, k, dtype=torch.bool), 0.9)
            assert keep.shape == (1, k) and keep.dtype == torch.bool
            assert calls[-1] == (1, k, 0.9) and nms_cuda.counter.launches == before + 1
    finally:
        nms_cuda._workspace_bytes.cache_clear()


def test_batched_nms_mask_matches_jax_at_nine_classes():
    """The plain twin against the JAX fixpoint on a 9-class request's
    cross-class set: K = 9 x 256 = 2304, class-major."""
    g = np.random.default_rng(2304)
    k = 9 * 256
    xy = g.uniform(0, 300, (k, 2))
    boxes = np.concatenate([xy, xy + g.uniform(5, 80, (k, 2))], -1).astype(np.float32)
    scores = g.uniform(0, 1, k).astype(np.float32)
    classes = (np.arange(k) // 256).astype(np.int32)
    valid = g.uniform(size=k) < 0.9
    for thr in (0.6, 0.9):
        ref = np.asarray(jax_batched_nms_mask(*(jnp.asarray(x) for x in (boxes, scores, classes, valid)), thr))
        got = nms_cuda.batched_nms_mask(*(torch.from_numpy(x)[None] for x in (boxes, scores, classes, valid)), thr)
        np.testing.assert_array_equal(got[0].numpy(), ref)


def test_stack_support_caches(pair):
    p = pair
    got = stack_support_caches(p["caches"])
    ref = jsc.stack_support_caches(p["jcaches"])
    for name in SupportCache._fields:
        assert getattr(got, name).shape[0] == 3
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))


@pytest.fixture(scope="module")
def jax_multiclass(pair):
    """One image through the JAX package's jitted multiclass builder over
    the three stacked caches: (image, image_hw, its detections)."""
    p = pair
    img = np.random.default_rng(3).standard_normal((96, 128, 3)).astype(np.float32)
    hw = (96.0, 128.0)
    ref = jinf.build_multiclass_inference_fn(p["jcfg"])(
        p["params"], jsc.stack_support_caches(p["jcaches"]), jnp.asarray(img), jnp.asarray(hw))
    return img, hw, ref


def _assert_multiclass_match(det, ref):
    assert det.boxes.shape == (24, 4) and det.classes.dtype == torch.int32
    got, want = _np(det), _np(ref)
    gcls, rcls = det.classes.numpy(), np.asarray(ref.classes)
    gv, rv = got["valid"], want["valid"]
    # classes may give the same box (clipped to the image): match boxes of
    # the same class only, by shifting each class to its own region
    for d, cls in ((got, gcls), (want, rcls)):
        d["boxes"] = d["boxes"] + 1000.0 * cls[:, None]
    _assert_detections_match(got, want)
    pairs, _, _, _ = greedy_match(got["boxes"][gv], got["scores"][gv], want["boxes"][rv], want["scores"][rv])
    assert all(gcls[gv][j] == rcls[rv][r] for j, r in pairs)
    assert np.array_equal(np.bincount(gcls[gv], minlength=3), np.bincount(rcls[rv], minlength=3))
    assert len(set(gcls[gv].tolist())) > 1  # more than one class survives the cross-class NMS


def test_multiclass_matches_jax(pair, jax_multiclass):
    p = pair
    img, hw, ref = jax_multiclass
    fn = tinf.build_multiclass_inference_fn(p["cfg"], p["sd"], device="cpu")
    _assert_multiclass_match(fn(stack_support_caches(p["caches"]), torch.from_numpy(img).permute(2, 0, 1), hw), ref)


def test_pinned_multiclass_matches_jax(pair, jax_multiclass):
    """build_pinned_multiclass_inference_fn (the stacked cache and its taps
    fixed at build time) against the JAX package's jitted builder."""
    p = pair
    img, hw, ref = jax_multiclass
    fn = tinf.build_pinned_multiclass_inference_fn(p["cfg"], p["sd"], stack_support_caches(p["caches"]),
                                                   device="cpu")
    _assert_multiclass_match(fn(torch.from_numpy(img).permute(2, 0, 1), hw), ref)


def test_multiclass_single_class_consistency(pair):
    """With one class stacked, the multiclass path keeps the single-class
    path's detections (test_multiclass.py's check, on the port)."""
    p = pair
    cfg, sd, cache = p["cfg"], p["sd"], p["caches"][2]
    img = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 96, 128)).astype(np.float32))
    hw = (96.0, 128.0)
    a = tinf.build_inference_fn(cfg, sd, device="cpu")(cache, img, hw)
    b = tinf.build_multiclass_inference_fn(cfg, sd, device="cpu")(stack_support_caches([cache]), img, hw)
    assert a.valid.sum() == b.valid.sum() > 0
    np.testing.assert_allclose(b.boxes[b.valid].numpy(), a.boxes[a.valid].numpy(), rtol=BOX_RTOL, atol=BOX_ATOL)
    np.testing.assert_allclose(b.scores[b.valid].numpy(), a.scores[a.valid].numpy(),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert not b.classes.any()


def test_multiclass_fused_is_one_cgm_call_a_level(pair, monkeypatch):
    """Under use_pallas_cgm a 3-class request calls the fused CGM once a
    level, with the classes' stacked taps ([3, C]), and gives what the
    composition path (a call a class) gives."""
    from faster_orefsdet_tpu_torch.models import detector

    p = pair
    cfg = p["cfg"].replace(use_pallas_cgm=True)
    img = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 96, 128)).astype(np.float32))
    mcache = stack_support_caches(p["caches"])
    ref = tinf.build_multiclass_inference_fn(p["cfg"], p["sd"], device="cpu")(mcache, img, (96.0, 128.0))
    calls = []
    real = detector.cgm_correlate_fused
    monkeypatch.setattr(detector, "cgm_correlate_fused", lambda q, k1, *a, **k: calls.append(tuple(k1.shape))
                        or real(q, k1, *a, **k))
    det = tinf.build_multiclass_inference_fn(cfg, p["sd"], device="cpu")(mcache, img, (96.0, 128.0))
    assert calls == [(3, 128)] * 3
    _assert_detections_match(_np(det), _np(ref))
    assert torch.equal(det.classes[det.valid], ref.classes[ref.valid])


def test_multiclass_fused_batch2_matches_jax(pair):
    """The port's multiclass query path under use_pallas_cgm over two images
    at once (rows class-major, c*B + i) against the JAX package's multiclass
    path on each image."""
    p = pair
    cfg = p["cfg"].replace(use_pallas_cgm=True)
    g = np.random.default_rng(4)
    imgs = g.standard_normal((2, 96, 128, 3)).astype(np.float32)
    hws = ((96.0, 128.0), (80.0, 112.0))
    model = tinf.make_detector(cfg, p["sd"], device="cpu")
    det = tinf.query_path_multiclass(model, stack_support_caches(p["caches"]),
                                     torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(), torch.tensor(hws))
    jfn = jinf.build_multiclass_inference_fn(p["jcfg"])
    mcache = jsc.stack_support_caches(p["jcaches"])
    for i in range(2):
        ref = jfn(p["params"], mcache, jnp.asarray(imgs[i]), jnp.asarray(hws[i]))
        got, want = {k: v[i] for k, v in _np(det).items()}, _np(ref)
        gcls, rcls = det.classes[i].numpy(), np.asarray(ref.classes)
        for d, cls in ((got, gcls), (want, rcls)):
            d["boxes"] = d["boxes"] + 1000.0 * cls[:, None]
        _assert_detections_match(got, want)
        assert np.array_equal(np.bincount(gcls[got["valid"]], minlength=3),
                              np.bincount(rcls[want["valid"]], minlength=3))
