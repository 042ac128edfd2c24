"""Sharded serving and sharded evaluation of the port (``parallel/serve_dp.py``,
``parallel/eval_dp.py``) on the CPU, over a mesh of two host replicas, the
config, weights and caches of ``test_torch_serving.py``:

- ``make_sharded_serving`` against single-device ``build_serving_fn`` on
  the same frames: valid masks exact, boxes within 1e-3 px, scores within
  1e-5 (tests/test_serve_dp.py's tolerances); each half of the batch bit
  for bit what one pinned replica (``build_pinned_serving_fn``) gives it;
- against the JAX package's ``make_sharded_serving`` on a 2-device CPU
  mesh, image by image by test_torch_slice's criteria;
- a batch that does not split over the mesh is refused;
- int8_resident serves sharded with its calibrated ``act_scales``, against
  its single-device function at the same tolerances;
- ``evaluate_sharded``'s AP table against ``evaluate``'s at batch 4
  (within 1e-6, as test_torch_eval.py holds batch 4 against batch 1), and
  what each fed its evaluator matched image by image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.data.synthetic import make_synthetic_setup
from faster_orefsdet_tpu.parallel import make_mesh as jax_make_mesh
from faster_orefsdet_tpu.parallel import make_sharded_serving as jax_make_sharded_serving
from faster_orefsdet_tpu_torch.evaluation import coco_eval
from faster_orefsdet_tpu_torch.parallel import make_mesh, make_sharded_serving
from faster_orefsdet_tpu_torch.parallel.eval_dp import evaluate_sharded
from faster_orefsdet_tpu_torch.pipelines import evaluate
from faster_orefsdet_tpu_torch.pipelines.inference import build_pinned_serving_fn, build_serving_fn
from faster_orefsdet_tpu_torch.pipelines.quant_calib import calibrate_act_scales
from test_torch_eval import AP_KEYS, _assert_fed_match, _record_fed_detections
from test_torch_serving import FRAME_HW, _frames, pair  # noqa: F401 (a fixture)
from test_torch_slice import _assert_detections_match, _np
import torch_budget  # noqa: F401 (the suite's torch thread budget)

BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5  # tests/test_serve_dp.py's
MESH = 2
BATCH = 4


def _nchw(frames):
    return torch.from_numpy(frames).permute(0, 3, 1, 2)


def _assert_same_detections(got, ref):
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid.numpy())
    v = ref.valid.numpy()
    assert v.any()
    np.testing.assert_allclose(got.boxes.numpy()[v], ref.boxes.numpy()[v], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got.scores.numpy()[v], ref.scores.numpy()[v], rtol=0, atol=SCORE_ATOL)


def test_sharded_serving_matches_single_device_and_jax(pair):  # noqa: F811
    p = pair
    frames = _frames(20, BATCH)
    serve, canvas = make_sharded_serving(p["cfg"], p["sd"], FRAME_HW, make_mesh(MESH, device="cpu"), p["caches"][0])
    single, single_canvas = build_serving_fn(p["cfg"], p["sd"], FRAME_HW, device="cpu")
    assert canvas == single_canvas == (96, 128)
    det = serve(_nchw(frames))
    assert det.boxes.shape == (BATCH, 24, 4)
    _assert_same_detections(det, single(p["caches"][0], _nchw(frames)))

    jserve, jcanvas = jax_make_sharded_serving(p["jcfg"], FRAME_HW, jax_make_mesh(MESH), p["params"],
                                               p["jcaches"][0])
    assert tuple(jcanvas) == canvas
    ref = jserve(jnp.asarray(frames))
    for i in range(BATCH):
        _assert_detections_match({k: v[i] for k, v in _np(det).items()}, {k: v[i] for k, v in _np(ref).items()})


def test_sharded_serving_equals_one_pinned_replica(pair):  # noqa: F811
    """Each replica is build_pinned_serving_fn on its device: over a CPU mesh
    of two, each half of the batch is what one replica gives it, bit for
    bit, and the whole is one replica's batch within the tolerances."""
    p = pair
    frames = _nchw(_frames(22, BATCH))
    serve, _ = make_sharded_serving(p["cfg"], p["sd"], FRAME_HW, make_mesh(MESH, device="cpu"), p["caches"][0])
    one, _ = build_pinned_serving_fn(p["cfg"], p["sd"], p["caches"][0], FRAME_HW, device="cpu")
    det = serve(frames)
    half = BATCH // MESH
    for i in range(MESH):
        for a, b in zip(det, one(frames[i * half:(i + 1) * half])):
            assert torch.equal(a[i * half:(i + 1) * half], b)
    _assert_same_detections(det, one(frames))
    assert serve.kernel_launches() == {"cgm": 0, "nms": 0}  # no graph on the CPU


def test_sharded_serving_refuses_an_indivisible_batch(pair):  # noqa: F811
    p = pair
    serve, _ = make_sharded_serving(p["cfg"], p["sd"], FRAME_HW, make_mesh(MESH, device="cpu"), p["caches"][0])
    with pytest.raises(ValueError, match="not divisible"):
        serve(torch.zeros(3, 3, *FRAME_HW, dtype=torch.uint8))


def test_sharded_serving_int8_resident(pair):  # noqa: F811
    p = pair
    cfg = p["cfg"].replace(quantize="int8_resident")
    calib = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 96, 128)).astype(np.float32))
    scales = calibrate_act_scales(cfg, p["sd"], calib, device="cpu")
    frames = _nchw(_frames(21, BATCH))
    with pytest.raises(ValueError, match="needs calibrated activation scales"):
        make_sharded_serving(cfg, p["sd"], FRAME_HW, make_mesh(MESH, device="cpu"), p["caches"][0])
    serve, _ = make_sharded_serving(cfg, p["sd"], FRAME_HW, make_mesh(MESH, device="cpu"), p["caches"][0],
                                    act_scales=scales)
    single, _ = build_serving_fn(cfg, p["sd"], FRAME_HW, device="cpu", act_scales=scales)
    _assert_same_detections(serve(frames), single(p["caches"][0], frames))


def test_evaluate_sharded_matches_evaluate(pair, tmp_path, monkeypatch):  # noqa: F811
    p = pair
    records, entries = make_synthetic_setup(str(tmp_path), num_images=6, seed=0, image_hw=FRAME_HW)
    cache = evaluate.encode_support_set(p["cfg"], p["sd"], entries, device="cpu")
    fed = {}
    _record_fed_detections(monkeypatch, coco_eval.COCOEvaluator, fed)
    fed["run"] = "single"
    ref = evaluate.evaluate(p["cfg"], p["sd"], cache, records, batch_size=BATCH, device="cpu")
    fed["run"] = "sharded"
    got = evaluate_sharded(p["cfg"], p["sd"], cache, records, make_mesh(MESH, device="cpu"),
                           per_device_batch=BATCH // MESH)
    assert set(got) == set(coco_eval.COCOEvaluator().evaluate()) and set(AP_KEYS) <= set(got)
    for k in AP_KEYS:
        assert np.isnan(got[k]) == np.isnan(ref[k]), k
        if not np.isnan(ref[k]):
            assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    ids = [r.image_id for r in records]
    assert sorted(fed["single"]) == sorted(fed["sharded"]) == sorted(ids)
    for i in ids:
        _assert_fed_match(fed["sharded"][i], fed["single"][i])
