"""The quantized serving presets through the port's serving entry points, on
the CPU: the batch-1 query path of each preset against the JAX package's
jitted builder (the same weights, cache, canvases and calibrated scales;
detections matched by test_torch_slice's criteria, scores within 2e-4);
batched, pinned, raw-frame, multiclass and async serving against the
port's own batch-1 path; the refusals the JAX package makes; evaluate's
auto-calibration; the demo's
--calib-glob against the builders. Configs: each preset in f32 with
test_torch_serving's small budgets (pre-NMS top-k 128, 32 proposals, 24
detections, test scale 96 / 160).

Measured gap, this file's inputs: the batch-1 detections of all three
presets match the jitted JAX builders' one to one, |dscore| at most 1.7e-5
(int8, dynamic scales) and 2.1e-7 (the static presets). Under jit XLA
fuses FrozenBN into an FMA (``test_torch_quant.py``), so the int8 grids
may differ in rare roundings; the scores' tolerance covers what that moved
here.

Batch 2 against batch 1 on the port: the CPU runs the eSE's float 1x1 conv
and mean by other algorithms for other batch sizes (the float preset's
stage outputs differ in the last bits as well), and an int8 rounding at a
boundary then flips: held at BATCH_SCORE_ATOL (measured 5.0e-3 under
int8_resident, below 2e-4 under the other two). The pinned, raw-frame and
async paths run the batched path's shapes and are held to it exactly."""

import dataclasses
import fnmatch

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.data.synthetic import make_synthetic_setup
from faster_orefsdet_tpu.pipelines import evaluate as jevaluate
from faster_orefsdet_tpu.pipelines import inference as jinf
from faster_orefsdet_tpu.pipelines import preprocess as jpreprocess
from faster_orefsdet_tpu.pipelines import support_cache as jsc
from faster_orefsdet_tpu.pipelines import train_step as jtrain_step
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.cli import demo
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.data import coco
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector
from faster_orefsdet_tpu_torch.pipelines import evaluate, preprocess, train_step
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines.async_predictor import AsyncPredictor
from faster_orefsdet_tpu_torch.pipelines.evaluate import encode_support_set
from faster_orefsdet_tpu_torch.pipelines.quant_calib import calibrate_act_scales
from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache, stack_support_caches
from faster_orefsdet_tpu_torch.utils.params import from_jax_params, init_params
from test_composed_parity_full import greedy_match
from test_torch_eval import _assert_tables_close
from test_torch_parity import make_torch_state_dict
from test_torch_serving import _cache_arrays, _small
from test_torch_slice import _assert_detections_match, _np
import torch_budget  # noqa: F401 (the suite's torch thread budget)

PRESETS = ("serving_vovnet_int8", "serving_vovnet_int8_static", "serving_vovnet_int8_resident")
STATIC_PRESETS = PRESETS[1:]
HW = (96.0, 120.0)  # true size on the 96x128 canvas
BATCH_SCORE_ATOL = 1e-2


def _assert_match(got, ref, score_atol):
    """test_torch_slice's criteria with another score tolerance."""
    gv, rv = got["valid"], ref["valid"]
    assert gv.sum() == rv.sum() > 0, (gv.sum(), rv.sum())
    gs, rs = got["scores"][gv], ref["scores"][rv]
    pairs, dscore, used_g, used_r = greedy_match(got["boxes"][gv], gs, ref["boxes"][rv], rs)
    assert len(pairs) >= int(0.85 * len(rs)), f"{len(pairs)}/{len(rs)} matched"
    assert dscore.max() <= score_atol, dscore.max()
    assert set(np.argsort(-gs, kind="mergesort")[:10].tolist()) <= used_g
    assert set(np.argsort(-rs, kind="mergesort")[:10].tolist()) <= used_r


def _cfg(get, name):
    return _small(get(name)).replace(compute_dtype="float32")


@pytest.fixture(scope="module")
def served():
    params = convert_torch_checkpoint(make_torch_state_dict(seed=3))
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    imgs = np.random.default_rng(42).standard_normal((3, 96, 128, 3)).astype(np.float32)
    timgs = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
    arrays = _cache_arrays(0)
    scales = {name: calibrate_act_scales(_cfg(get_config, name), sd, timgs, device="cpu")
              if name in STATIC_PRESETS else None for name in PRESETS}
    return dict(params=params, sd=sd, imgs=imgs, timgs=timgs, scales=scales,
                jcache=jsc.SupportCache(*map(jnp.asarray, arrays)), cache=SupportCache(*map(torch.from_numpy, arrays)))


@pytest.mark.parametrize("name", PRESETS)
def test_query_path_matches_jax(served, name):
    s = served
    scales = s["scales"][name]
    ref = jinf.build_inference_fn(_cfg(jax_get_config, name), act_scales=scales)(
        s["params"], s["jcache"], jnp.asarray(s["imgs"][0]), jnp.asarray(HW))
    det = tinf.build_inference_fn(_cfg(get_config, name), s["sd"], device="cpu", act_scales=scales)(
        s["cache"], s["timgs"][0], HW)
    assert det.boxes.shape == (24, 4)
    _assert_detections_match(_np(det), _np(ref))


@pytest.mark.parametrize("name", PRESETS)
def test_serving_entry_points_agree(served, name):
    """Batched uint8 canvases, the pinned function, raw-frame serving, a
    one-class multiclass request and the async predictor, each with the
    preset's scales, against the batch-1 path."""
    s = served
    cfg, sd, cache, scales = _cfg(get_config, name), s["sd"], s["cache"], s["scales"][name]
    single = tinf.build_inference_fn(cfg, sd, device="cpu", act_scales=scales)
    mean = np.asarray(cfg.input.pixel_mean, np.float32)
    g = np.random.default_rng(7)
    u8 = torch.from_numpy(np.clip(np.rint(mean + 8.0 * g.standard_normal((2, 96, 128, 3))), 0, 255)
                          .astype(np.uint8)).permute(0, 3, 1, 2).contiguous()
    hw = torch.tensor([HW, HW])
    batched = tinf.build_batched_inference_fn(cfg, sd, device="cpu", act_scales=scales)(cache, u8, hw)
    for i in range(2):
        one = single(cache, tinf.normalize_uint8(u8[i:i + 1], hw[:1], cfg)[0], HW)
        _assert_match(_np(one), {k: v[i] for k, v in _np(batched).items()}, BATCH_SCORE_ATOL)
    pinned = tinf.build_pinned_inference_fn(cfg, sd, cache, device="cpu", packed=True, act_scales=scales)
    assert torch.equal(pinned(u8, hw), tinf.pack_detections(batched))
    # raw frames: the same canvases as preprocess_device makes them, rescaled to the frame
    frames = u8[..., :96, :120]
    serve, canvas = tinf.build_serving_fn(cfg, sd, (96, 120), device="cpu", act_scales=scales)
    canvases = preprocess.preprocess_device(frames, (96, 120), canvas, cfg.input.pixel_mean, cfg.input.pixel_std)
    ref = tinf.build_batched_inference_fn(cfg, sd, device="cpu", act_scales=scales)(cache, canvases, hw)
    got = serve(cache, frames)
    assert canvas == (96, 128) and torch.equal(got.boxes, ref.boxes) and torch.equal(got.scores, ref.scores)
    # one class stacked: the single-class detections (test_torch_serving's check)
    img = s["timgs"][1]
    a = single(cache, img, HW)
    b = tinf.build_multiclass_inference_fn(cfg, sd, device="cpu", act_scales=scales)(
        stack_support_caches([cache]), img, HW)
    assert a.valid.sum() == b.valid.sum() > 0
    np.testing.assert_allclose(b.boxes[b.valid].numpy(), a.boxes[a.valid].numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(b.scores[b.valid].numpy(), a.scores[a.valid].numpy(), rtol=1e-4, atol=1e-5)
    # the async predictor: each frame's result is its own pinned call's
    frames_hwc = [np.ascontiguousarray(f.permute(1, 2, 0).numpy()) for f in u8[..., :90, :120]]
    pred = AsyncPredictor(cfg, sd, cache, depth=2, device="cpu", act_scales=scales)
    outs = list(pred.run(iter(frames_hwc)))
    own = tinf.build_pinned_inference_fn(cfg, sd, cache, device="cpu", packed=True, act_scales=scales)
    for frame, out in zip(frames_hwc, outs):
        canvas, (nh, nw), (sy, sx) = preprocess.preprocess_host(
            frame, cfg.input.min_size_test, cfg.input.max_size_test, (96, 128), cfg.input.pixel_mean,
            cfg.input.pixel_std)
        p = tinf.unpack_detections_np(own(canvas, (float(nh), float(nw))))
        np.testing.assert_array_equal(out["boxes"], p["boxes"][p["valid"]] * np.asarray([sx, sy, sx, sy]))
        np.testing.assert_array_equal(out["scores"], p["scores"][p["valid"]])


_BUILDERS = {
    "build_inference_fn": lambda cfg, sd, cache: tinf.build_inference_fn(cfg, sd, device="cpu"),
    "build_batched_inference_fn": lambda cfg, sd, cache: tinf.build_batched_inference_fn(cfg, sd, device="cpu"),
    "build_serving_fn": lambda cfg, sd, cache: tinf.build_serving_fn(cfg, sd, (96, 120), device="cpu"),
    "build_multiclass_inference_fn": lambda cfg, sd, cache: tinf.build_multiclass_inference_fn(cfg, sd,
                                                                                               device="cpu"),
    "build_pinned_inference_fn": lambda cfg, sd, cache: tinf.build_pinned_inference_fn(cfg, sd, cache,
                                                                                       device="cpu"),
    "AsyncPredictor": lambda cfg, sd, cache: AsyncPredictor(cfg, sd, cache, device="cpu"),
}


@pytest.mark.parametrize("builder", sorted(_BUILDERS))
@pytest.mark.parametrize("name", STATIC_PRESETS)
def test_static_presets_refuse_without_scales(served, name, builder):
    """The JAX package's refusal, before any model is built."""
    match = "needs calibrated activation scales"
    with pytest.raises(ValueError, match=match):
        jinf.build_inference_fn(jax_get_config(name))
    with pytest.raises(ValueError, match=match):
        _BUILDERS[builder](get_config(name), served["sd"], served["cache"])


def test_quantize_gates_match_jax():
    """An unknown quantize string, and int8 on a backbone other than
    vovnet_fpn, raise in both packages with the same words."""
    from faster_orefsdet_tpu.utils.params import init_params as jax_init_params

    cases = (("finetune_vovnet", dict(quantize="int4"), "expected 'none', 'int8', 'int8_static' or 'int8_resident'"),
             ("finetune_dla", dict(quantize="int8"), "plumbed for the vovnet_fpn family"))
    for name, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jax_init_params(jinf.make_detector(jax_get_config(name).replace(**kw)), jax_get_config(name),
                            jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match=match):
            CenterNet2Detector(get_config(name).replace(**kw))


@pytest.mark.parametrize("name", PRESETS)
def test_training_refuses_quantized(name):
    match = "serving-only preset"
    with pytest.raises(ValueError, match=match):
        jtrain_step._check_trainable(jax_get_config(name))
    for fn in (lambda c: train_step.make_train_model(c, device="cpu"),
               lambda c: train_step.build_train_state(c, device="cpu"), train_step.build_train_step):
        with pytest.raises(ValueError, match=match):
            fn(get_config(name))


def test_evaluate_auto_calibrates_like_jax(tmp_path, monkeypatch, capsys):
    """evaluate under int8_static without scales calibrates on the first
    <= 8 eval canvases, as the JAX package's does: the canvases the port's
    loop calibrates on are the JAX loop's eval canvases (the same pixels:
    both resize with the port's function, as in test_torch_eval), its scales
    are the port's calibration of them (held against the JAX package's
    calibration in test_torch_quant.py), it serves with them (the table of
    the same loop given those scales), and the AP table on the set's ground
    truth is within 0.5 points of the JAX loop's.

    Measured, not held: the random weights score 0 AP on the set's ground
    truth in both packages. On ground truth taken from the JAX loop's own
    detections (test_torch_eval's second check, which the float presets
    pass with equal tables) the int8 loops differ: AP 47.6 (JAX) against
    22.0 (port) for the int8 preset with each package's own support cache.
    The detections' scores tie at 1.0 on this set, so a flipped int8
    rounding (XLA's FMA under jit, the float ops' last bits) picks another
    box among equals."""
    from faster_orefsdet_tpu.data.loader import eval_canvas as jax_eval_canvas
    from faster_orefsdet_tpu.data.loader import eval_loader as jax_eval_loader
    from faster_orefsdet_tpu_torch.pipelines import quant_calib

    records, entries = make_synthetic_setup(str(tmp_path), num_images=6, seed=0)
    monkeypatch.setattr(jpreprocess, "resize_image_host", preprocess.resize_image_host)

    def small(cfg):
        cfg = cfg.replace(compute_dtype="float32")
        return cfg.replace(input=dataclasses.replace(cfg.input, min_size_test=128, max_size_test=192),
                           fs=dataclasses.replace(cfg.fs, support_shot=2))

    jcfg, cfg = small(jax_get_config("serving_vovnet_int8_static")), small(get_config("serving_vovnet_int8_static"))
    params = convert_torch_checkpoint(make_torch_state_dict(seed=3))
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    model = jinf.make_detector(jcfg)
    ref = jevaluate.evaluate(model, params, jevaluate.encode_support_set(model, params, entries, jcfg), records,
                             jcfg)
    assert "auto-calibrated 25 activation scales (6 eval images)" in capsys.readouterr().out
    cache = evaluate.encode_support_set(cfg, sd, entries, device="cpu")
    seen = []
    calibrate = quant_calib.calibrate_act_scales

    def recording(cfg_, params_, images, *a, **k):
        seen.append((images, calibrate(cfg_, params_, images, *a, **k)))
        return seen[-1][1]

    monkeypatch.setattr(quant_calib, "calibrate_act_scales", recording)
    got = evaluate.evaluate(cfg, sd, cache, records, device="cpu")
    assert "auto-calibrated 25 activation scales (6 eval images)" in capsys.readouterr().out
    (images, scales), = seen
    jcanvases = np.stack([np.asarray(c) for _, c, _, _ in jax_eval_loader(records, jcfg,
                                                                          jax_eval_canvas(records, jcfg))])
    np.testing.assert_array_equal(images.permute(0, 2, 3, 1).numpy(), jcanvases)
    assert scales == calibrate(cfg, sd, torch.from_numpy(jcanvases).permute(0, 3, 1, 2), device="cpu")
    given = evaluate.evaluate(cfg, sd, cache, records, device="cpu", act_scales=scales)
    assert len(seen) == 1
    for k in ("AP", "AP50", "AP75", "AR@100"):
        assert given[k] == got[k], k
    _assert_tables_close(got, ref)


# ---------------------------------------------------------------- the demo
TINY = ["centernet.pre_nms_topk_test=64", "centernet.post_nms_topk_test=16", "roi.detections_per_image=8",
        "input.min_size_test=96", "input.max_size_test=160", "fs.support_shot=2", "fs.support_crop_size=96",
        "compute_dtype=float32"]


def _scene(g, h=120, w=160):
    img = g.normal(110, 12, (h, w, 3))
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(3):
        a, b = g.uniform(6, 30, 2)
        cx, cy = g.uniform(a, w - a), g.uniform(b, h - b)
        img[((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 <= 1.0] = g.uniform(35, 75)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture
def media(tmp_path):
    """Frames, support crops and a support index held in memory, and a
    Media that reads them and records each drawn frame's detections."""
    g = np.random.default_rng(11)
    store = {f"in/{i}.png": _scene(g) for i in range(3)}
    store.update({f"calib/{i}.png": _scene(g, 100, 140) for i in range(2)})
    store.update({f"crops/{i}.png": _scene(g, 96, 96) for i in range(2)})
    entries = [coco.SupportEntry(i, i, 1, f"crops/{i}.png", (8.0, 10.0, 80.0, 70.0)) for i in range(2)]
    coco.save_support_index(str(tmp_path / "index.json"), entries)
    draws = []

    def draw(img, boxes, scores, thresh):
        draws.append((np.asarray(boxes), np.asarray(scores)))
        return img

    m = demo.Media(imread=store.get, imwrite=lambda path, img: True,
                   glob=lambda pattern: sorted(fnmatch.filter(store, pattern)), open_video=None,
                   open_writer=None, draw=draw, debug=None)
    return dict(media=m, store=store, entries=entries, index=str(tmp_path / "index.json"), draws=draws,
                out=str(tmp_path / "out"))


@pytest.mark.parametrize("name", STATIC_PRESETS)
def test_demo_calib_glob_matches_builders(media, name, capsys):
    """The demo calibrates on --calib-glob's images at their common canvas;
    its detections equal build_inference_fn's with those scales, bit for bit."""
    m = media
    args = demo.parse_args(["--config", name, "--input", "in/*.png", "--calib-glob", "calib/*.png",
                            "--support-index", m["index"], "--output", m["out"], "--confidence", "0.0",
                            "--device", "cpu", *TINY])
    assert demo.run(args, m["media"]) == 3
    assert "calibrated 25 activation scales (2 images)" in capsys.readouterr().out
    from faster_orefsdet_tpu_torch.config import apply_overrides

    cfg = apply_overrides(get_config(name), TINY)
    inp = cfg.input
    params = init_params(cfg, seed=0)
    calib = [m["store"][f"calib/{i}.png"] for i in range(2)]
    canvases = torch.stack([preprocess.preprocess_host(img, inp.min_size_test, inp.max_size_test, (96, 160),
                                                       inp.pixel_mean, inp.pixel_std)[0] for img in calib])
    scales = calibrate_act_scales(cfg, params, canvases, device="cpu")
    cache = encode_support_set(cfg, params, m["entries"], imread=m["store"].get, device="cpu")
    fn = tinf.build_inference_fn(cfg, params, device="cpu", act_scales=scales)
    for i, (boxes, scores) in enumerate(m["draws"]):
        canvas, (nh, nw), (sy, sx) = preprocess.preprocess_host(m["store"][f"in/{i}.png"], inp.min_size_test,
                                                                inp.max_size_test, (96, 128), inp.pixel_mean,
                                                                inp.pixel_std)
        det = fn(cache, canvas, (float(nh), float(nw)))
        valid = det.valid.numpy()
        assert len(scores) == valid.sum() > 0
        np.testing.assert_array_equal(boxes, det.boxes.numpy()[valid] * np.asarray([sx, sy, sx, sy]))
        np.testing.assert_array_equal(scores, det.scores.numpy()[valid])


def test_demo_stream_without_calibration_exits(media):
    """A static preset on a video with no calibration images exits with the
    JAX demo's message before any model work; with --input the glob's
    images calibrate."""
    m = media
    args = demo.parse_args(["--config", "serving_vovnet_int8_resident", "--video-input", "clip.avi",
                            "--support-index", m["index"], "--device", "cpu", *TINY])
    with pytest.raises(SystemExit, match="needs calibration images: pass --calib-glob"):
        demo.run(args, m["media"])
    args = demo.parse_args(["--config", "serving_vovnet_int8_static", "--input", "none/*.png",
                            "--support-index", m["index"], "--device", "cpu", *TINY])
    with pytest.raises(SystemExit, match=r"serving_vovnet_int8_static \(quantize=int8_static\) needs calibration"):
        demo.run(args, m["media"])
