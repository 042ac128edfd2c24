"""The port's serving slice end to end against the JAX package, on the CPU:
support cache -> batch-1 query path -> batched uint8 path, under
serving_vovnet in f32. The JAX side runs its jitted builders with the Pallas
kernels in interpret mode (its CPU default); the port runs with
device="cpu", i.e. through the kernels' plain twins. Same weights (the
converted published tree), same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.pipelines import inference as jinf
from faster_orefsdet_tpu.pipelines import support_cache as jsc
from faster_orefsdet_tpu.pipelines.support_cache import build_support_cache as jax_build_cache
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines.support_cache import (
    build_support_cache,
    load_support_cache,
    save_support_cache,
)
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_composed_parity_full import greedy_match
from test_torch_parity import make_torch_state_dict
import torch_budget  # noqa: F401 (the suite's torch thread budget)

CACHE_TOL = dict(rtol=1e-3, atol=2e-4)
SCORE_ATOL = 2e-4


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = jax_get_config("serving_vovnet").replace(compute_dtype="float32")
    cfg = get_config("serving_vovnet").replace(compute_dtype="float32")
    params = convert_torch_checkpoint(make_torch_state_dict(seed=3))
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    g = np.random.default_rng(42)
    sup = g.standard_normal((2, 256, 256, 3)).astype(np.float32)
    sup_boxes = np.asarray([[20.0, 30.0, 200.0, 210.0], [8.0, 8.0, 120.0, 180.0]], np.float32)
    jcache = jax_build_cache(jinf.make_detector(jcfg), params, jnp.asarray(sup), jnp.asarray(sup_boxes), jcfg)
    cache = build_support_cache(cfg, sd, torch.from_numpy(sup).permute(0, 3, 1, 2),
                                torch.from_numpy(sup_boxes), device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, params=params, sd=sd, jcache=jcache, cache=cache, g=g)


def _assert_detections_match(got, ref):
    """got / ref: numpy dicts of one image's boxes, scores, valid."""
    gv, rv = got["valid"], ref["valid"]
    assert gv.sum() == rv.sum() > 0, (gv.sum(), rv.sum())
    gb, gs, rb, rs = got["boxes"][gv], got["scores"][gv], ref["boxes"][rv], ref["scores"][rv]
    pairs, dscore, used_g, used_r = greedy_match(gb, gs, rb, rs)
    assert len(pairs) >= int(0.85 * len(rs)), f"{len(pairs)}/{len(rs)} matched"
    assert dscore.max() <= SCORE_ATOL
    top_g = set(np.argsort(-gs, kind="mergesort")[:10].tolist())
    top_r = set(np.argsort(-rs, kind="mergesort")[:10].tolist())
    assert top_g <= used_g and top_r <= used_r


def _np(det):
    return {k: np.asarray(getattr(det, k)) for k in ("boxes", "scores", "valid")}


def test_support_cache(slice_pair, tmp_path):
    p = slice_pair
    for name in p["cache"]._fields:
        np.testing.assert_allclose(getattr(p["cache"], name).numpy(), np.asarray(getattr(p["jcache"], name)),
                                   **CACHE_TOL, err_msg=name)
    path = str(tmp_path / "cache.npz")
    save_support_cache(path, p["cache"])
    for a, b in zip(load_support_cache(path, device="cpu"), p["cache"]):
        assert torch.equal(a, b)
    # the .npz crosses between the packages both ways, bf16 fields included
    for a, b in zip(jsc.load_support_cache(path), p["cache"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jpath = str(tmp_path / "jax_cache.npz")
    jbf16 = p["jcache"]._replace(rcnn_8=p["jcache"].rcnn_8.astype(jnp.bfloat16))
    jsc.save_support_cache(jpath, jbf16)
    loaded = load_support_cache(jpath, device="cpu")
    assert loaded.rcnn_8.dtype == torch.bfloat16
    for a, b in zip(loaded, jbf16):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_query_path_batch1(slice_pair):
    p = slice_pair
    img = p["g"].standard_normal((96, 128, 3)).astype(np.float32)
    hw = (96.0, 120.0)  # true resized size; canvas = ceil32 -> (96, 128)
    ref = jinf.build_inference_fn(p["jcfg"])(p["params"], p["jcache"], jnp.asarray(img), jnp.asarray(hw))
    fn = tinf.build_inference_fn(p["cfg"], p["sd"], device="cpu")
    det = fn(p["cache"], torch.from_numpy(img).permute(2, 0, 1), hw)
    assert det.boxes.shape == (100, 4) and det.classes.dtype == torch.int32
    _assert_detections_match(_np(det), _np(ref))
    packed = tinf.pack_detections(det)
    assert packed.shape == (100, 7) and torch.isfinite(packed).all()
    back = tinf.unpack_detections_np(packed)
    np.testing.assert_array_equal(back["valid"], det.valid.numpy())


def test_batched_uint8_path(slice_pair):
    p = slice_pair
    # pixels near the mean: normalized values O(1), as the weights expect
    # (full-range noise drives the random weights to degenerate, clipped boxes)
    mean = np.asarray(p["cfg"].input.pixel_mean, np.float32)
    u8 = np.clip(np.rint(mean + 2.0 * p["g"].standard_normal((2, 96, 128, 3))), 0, 255).astype(np.uint8)
    hw = np.asarray([[96.0, 120.0], [80.0, 100.0]], np.float32)
    ref = jinf.build_batched_inference_fn(p["jcfg"])(p["params"], p["jcache"], jnp.asarray(u8), jnp.asarray(hw))
    fn = tinf.build_batched_inference_fn(p["cfg"], p["sd"], device="cpu")
    det = fn(p["cache"], torch.from_numpy(u8).permute(0, 3, 1, 2), torch.from_numpy(hw))
    assert det.boxes.shape == (2, 100, 4)
    for i in range(2):
        _assert_detections_match({k: v[i] for k, v in _np(det).items()},
                                 {k: v[i] for k, v in _np(ref).items()})
