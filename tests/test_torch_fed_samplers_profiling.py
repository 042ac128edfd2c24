"""The federated loss, the samplers, the profiling utilities and the native
COCO matcher of the port against the JAX package, on the CPU.

- ``fed_loss_mask_from_uniforms`` on the JAX function's own uniform draws
  gives its mask exactly; ``sigmoid_cross_entropy_loss`` rtol 1e-6;
  ``load_class_freq`` equal.
- The samplers' first 1,000 indices equal for two seeds;
  ``efficientdet_resize_crop`` with cv2's resize equal byte for byte.
- ``cost_analysis`` of a 64x64 matmul is 2 * 64**3 flops; ``measure_model``
  counts the JAX package's ``param_count``; ``trace`` writes a trace.
- The C++ matcher (``csrc/cocoeval.cc``, built with g++ at first use)
  equals the numpy twin on random scenes, and ``coco_ap`` equals the JAX
  package's."""

import json
import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faster_orefsdet_tpu_torch.evaluation.coco_eval as ce
from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.data import coco as jcoco
from faster_orefsdet_tpu.data import samplers as jsamplers
from faster_orefsdet_tpu.evaluation import coco_eval as jce
from faster_orefsdet_tpu.ops import fed_loss as jfed
from faster_orefsdet_tpu.pipelines.inference import make_detector as jax_make_detector
from faster_orefsdet_tpu.utils.params import init_params as jax_init_params
from faster_orefsdet_tpu.utils.params import param_count
from faster_orefsdet_tpu_torch.data import coco, samplers
from faster_orefsdet_tpu_torch.ops import fed_loss
from faster_orefsdet_tpu_torch.utils import profiling

import torch_budget  # noqa: F401 (the suite's torch thread budget)

LOSS_RTOL = 1e-6


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_fed_loss_mask_equals_jax_on_its_draws(seed, weighted):
    c, k = 40, 12
    g = np.random.default_rng(seed)
    gt = g.integers(0, c + 1, 9).astype(np.int32)  # c is the background class
    weight = g.uniform(0.5, 30.0, c).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jfed.fed_loss_class_mask(key, jnp.asarray(gt), c, k,
                                              None if weight is None else jnp.asarray(weight)))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (c,))))
    got = fed_loss.fed_loss_mask_from_uniforms(u, torch.from_numpy(gt), c, k,
                                               None if weight is None else torch.from_numpy(weight))
    np.testing.assert_array_equal(got.numpy(), ref)
    appeared = set(gt[gt < c].tolist())
    assert int(got.sum()) == max(k, len(appeared)) and all(got[a] for a in appeared)


def test_fed_loss_mask_draws_from_its_generator():
    gt = torch.tensor([3, 5, 50])
    masks = [fed_loss.fed_loss_class_mask(gt, 50, 10, generator=torch.Generator().manual_seed(s)) for s in (4, 4, 5)]
    assert torch.equal(masks[0], masks[1]) and not torch.equal(masks[0], masks[2])
    assert all(int(m.sum()) == 10 and m[3] and m[5] for m in masks)


@pytest.mark.parametrize("with_mask", [False, True])
def test_sigmoid_cross_entropy_matches_jax(with_mask):
    g = np.random.default_rng(2)
    scores = (3 * g.standard_normal((16, 9))).astype(np.float32)
    gt = g.integers(0, 9, 16).astype(np.int32)
    valid = g.uniform(size=16) < 0.8
    mask = g.uniform(size=8) < 0.5 if with_mask else None
    ref = float(jfed.sigmoid_cross_entropy_loss(jnp.asarray(scores), jnp.asarray(gt), jnp.asarray(valid),
                                                None if mask is None else jnp.asarray(mask)))
    got = float(fed_loss.sigmoid_cross_entropy_loss(torch.from_numpy(scores), torch.from_numpy(gt),
                                                    torch.from_numpy(valid),
                                                    None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(ref, rel=LOSS_RTOL)


def test_load_class_freq_matches_jax(tmp_path):
    path = tmp_path / "cat_info.json"
    path.write_text(json.dumps([{"id": i, "image_count": c} for i, c in ((3, 7), (1, 120), (2, 1))]))
    np.testing.assert_array_equal(fed_loss.load_class_freq(str(path), 0.5).numpy(),
                                  np.asarray(jfed.load_class_freq(str(path), 0.5)))


def _records(mod, seed):
    g = np.random.default_rng(seed)
    out = []
    for i in range(30):
        classes = g.integers(1, 6, g.integers(1, 4))
        anns = [mod.Annotation(j, (0.0, 0.0, 8.0, 8.0), int(c)) for j, c in enumerate(classes)]
        out.append(mod.ImageRecord(f"{i}.jpg", i, 64, 64, anns))
    return out


def _first(sampler, n=1000):
    it = iter(sampler)
    return [int(next(it)) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 7])
def test_samplers_give_the_jax_index_stream(seed):
    assert _first(samplers.ClassAwareSampler(_records(coco, 3), seed)) == \
        _first(jsamplers.ClassAwareSampler(_records(jcoco, 3), seed))
    sizes, ratios = [10, 250, 37], [1.0, 2.5, 0.5]
    assert _first(samplers.MultiDatasetSampler(sizes, ratios, seed)) == \
        _first(jsamplers.MultiDatasetSampler(sizes, ratios, seed))


@pytest.mark.parametrize("target", [96, 400])
def test_efficientdet_resize_crop_matches_jax(target):
    g = np.random.default_rng(target)
    img = g.integers(0, 256, (120, 200, 3), dtype=np.uint8)
    boxes = np.asarray([[10, 20, 90, 100], [150, 5, 199, 119]], np.float32)
    ref = jsamplers.efficientdet_resize_crop(img, boxes, target, np.random.default_rng(5))
    for resize in (None, lambda im, hw: cv2.resize(im, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)):
        got = samplers.efficientdet_resize_crop(img, boxes, target, np.random.default_rng(5), resize=resize)
        assert got[0].dtype == ref[0].dtype and got[0].tobytes() == ref[0].tobytes()
        np.testing.assert_array_equal(got[1], ref[1])


def test_cost_analysis_counts_a_matmul():
    a = torch.randn(64, 64)
    assert profiling.cost_analysis(torch.matmul, a, a) == {"flops": 2.0 * 64 ** 3}


def test_measure_model_counts_the_jax_params():
    jcfg = jax_get_config("finetune_vovnet")
    shapes = jax.eval_shape(lambda k: jax_init_params(jax_make_detector(jcfg), jcfg, k), jax.random.PRNGKey(0))
    got = profiling.measure_model(device="cpu")
    assert got["params"] == param_count(shapes)
    assert got["flops"] > 0 and math.isnan(got["bytes_accessed"])


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.randn(32, 32) @ torch.randn(32, 32)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_device_memory_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory() == {}


def _scene(rng, trial):
    d, g = int(rng.integers(1, 30)), int(rng.integers(0, 15))
    dt = np.sort(rng.uniform(0, 100, (d, 2, 2)), axis=1).reshape(d, 4)[:, [0, 2, 1, 3]]
    gt = np.sort(rng.uniform(0, 100, (g, 2, 2)), axis=1).reshape(g, 4)[:, [0, 2, 1, 3]] if g else np.zeros((0, 4))
    scores = rng.uniform(0, 1, d)
    crowd = rng.uniform(size=g) < 0.2
    areas = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) if g else np.zeros(0)
    return dt, scores, ce.GTImage(trial, gt, crowd, areas)


def test_native_matcher_equals_numpy_twin(rng):
    """The JAX test's random scenes (tests/test_native_cocoeval.py), and
    more of them."""
    assert ce._native_matcher() is ce._NATIVE is not None  # built (or found) and loaded
    for trial in range(40):
        dt, scores, gti = _scene(rng, trial)
        arng = (0.0, 1e10) if trial % 2 == 0 else (100.0, 3000.0)
        native = ce._NATIVE
        try:
            got = ce._evaluate_image(dt, scores, gti, arng, 100)
            ce._NATIVE = None
            ref = ce._evaluate_image(dt, scores, gti, arng, 100)
        finally:
            ce._NATIVE = native
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_coco_ap_with_the_native_matcher_equals_jax():
    g = np.random.default_rng(3)
    dets, gts, jdets, jgts = [], [], [], []
    for i in range(12):
        dt, scores, gti = _scene(g, i)
        dt = dt + g.normal(0, 2, dt.shape)
        dets.append(ce.DetResult(i, dt, scores))
        gts.append(gti)
        jdets.append(jce.DetResult(i, dt, scores))
        jgts.append(jce.GTImage(i, gti.boxes, gti.iscrowd, gti.areas))
    got, ref = ce.coco_ap(dets, gts), jce.coco_ap(jdets, jgts)
    assert got.keys() == ref.keys()
    for k in ref:
        assert (math.isnan(got[k]) and math.isnan(ref[k])) or got[k] == ref[k], k


def test_failed_matcher_build_raises(monkeypatch, tmp_path):
    """A failed g++ build raises, naming the command; nothing falls back."""
    from faster_orefsdet_tpu_torch.ops import _native

    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_native, "CXX_FLAGS", ("-no-such-flag",))
    _native.host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ -no-such-flag"):
            _native.host_library("cocoeval")
    finally:
        _native.host_library.cache_clear()
