"""The one-stage CenterNet path of the port against the JAX package, on the
CPU, over P3-P7 (``fpn.top_levels=2``, strides 8-128, canvases a multiple
of 128): the class-aware head, ``decode_multiclass`` on the same head
outputs, ``build_onestage_inference_fn`` and its pinned counterpart
``build_pinned_onestage_inference_fn`` against the jitted JAX builder at
one and three classes, the FPN's P6/P7, and the refusal of a canvas the
coarsest stride does not divide.

Weights: the port's seeded ``init_onestage_params`` carried to the JAX
side by ``to_jax_params``; the JAX init's own tree (shapes by
``jax.eval_shape``) loads strictly into the port. Tolerances: head outputs
within 1e-4 of each map's largest |value|; the decode on identical head
outputs: classes and validity exact, boxes within 1e-5 of the largest
coordinate, scores 1e-6; the builders by phase 5's criteria (>= 85% of
the detections greedy-matched at IoU >= 0.95 within their class, both
top 10 matched, |dscore| <= 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.models.fpn import FPN as JaxFPN
from faster_orefsdet_tpu.pipelines import onestage as jos
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector
from faster_orefsdet_tpu_torch.models.fpn import FPN
from faster_orefsdet_tpu_torch.ops import nms_cuda
from faster_orefsdet_tpu_torch.ops.heatmap import level_grid_shapes
from faster_orefsdet_tpu_torch.pipelines import onestage
from faster_orefsdet_tpu_torch.pipelines.preprocess import canvas_for, ceil_to, resize_shortest_edge_size
from faster_orefsdet_tpu_torch.utils.params import from_jax_params, init_onestage_params, to_jax_params
from test_composed_parity_full import greedy_match
from test_torch_dla import assert_close_of_largest, nhwc
from test_torch_zoo import jax_shapes
import torch_budget  # noqa: F401 (the suite's torch thread budget)

P7_LEVELS, P7_STRIDES = ("p3", "p4", "p5", "p6", "p7"), (8, 16, 32, 64, 128)
CANVAS, IMAGE_HW = (256, 384), (256.0, 360.0)
HEAD_TOL, BOX_TOL, SCORE_TOL = 1e-4, 1e-5, 1e-6
MATCH_IOU, MATCH_FRACTION, MATCH_DSCORE = 0.95, 0.85, 1e-3


def p3_p7(cfg, num_classes):
    """finetune_vovnet as a one-stage detector over P3-P7."""
    return cfg.replace(
        fpn=dataclasses.replace(cfg.fpn, top_levels=2),
        centernet=dataclasses.replace(cfg.centernet, in_features=P7_LEVELS, fpn_strides=P7_STRIDES,
                                      only_proposal=False, num_classes=num_classes),
        input=dataclasses.replace(cfg.input, size_divisibility=128),
    )


def assert_match_by_class(got, ref):
    """Phase 5's criteria on one image's numpy detections, a box matching
    only a box of its own class."""
    gv, rv = got["valid"], ref["valid"]
    assert gv.sum() == rv.sum() > 0, (gv.sum(), rv.sum())
    shift = lambda d, v: d["boxes"][v] + 1e4 * d["classes"][v][:, None]  # noqa: E731
    gs, rs = got["scores"][gv], ref["scores"][rv]
    pairs, dscore, used_g, used_r = greedy_match(shift(got, gv), gs, shift(ref, rv), rs, MATCH_IOU)
    assert len(pairs) >= MATCH_FRACTION * rv.sum(), f"{len(pairs)}/{rv.sum()} matched"
    assert dscore.max() <= MATCH_DSCORE
    assert set(np.argsort(-gs, kind="mergesort")[:10].tolist()) <= used_g
    assert set(np.argsort(-rs, kind="mergesort")[:10].tolist()) <= used_r


def _np(det):
    return {k: np.asarray(getattr(det, k)) for k in ("boxes", "scores", "classes", "valid")}


@pytest.fixture(scope="module", params=[1, 3], ids=["1class", "3classes"])
def pair(request):
    n = request.param
    jcfg, cfg = p3_p7(jax_get_config("finetune_vovnet"), n), p3_p7(get_config("finetune_vovnet"), n)
    sd = init_onestage_params(cfg, seed=n)
    params = to_jax_params(sd)
    model = jos.OneStageCenterNet(jcfg)
    img = np.random.default_rng(10 + n).standard_normal((*CANVAS, 3)).astype(np.float32)
    hw = jnp.asarray(IMAGE_HW)

    @jax.jit
    def run(p, image):
        clss, agn, regs = model.apply({"params": p}, image[None])
        det = jos.decode_multiclass([c[0] for c in clss], [a[0] for a in agn], [r[0] for r in regs], jcfg,
                                    CANVAS, hw)
        return clss, agn, regs, det

    jclss, jagn, jregs, jdet = run(params, jnp.asarray(img))
    port = onestage.make_onestage(cfg, sd, device="cpu")
    x = torch.from_numpy(img).permute(2, 0, 1)
    with torch.no_grad():
        clss, agn, regs = port(x[None])
    return dict(n=n, jcfg=jcfg, cfg=cfg, sd=sd, img=img, x=x, model=model, jhead=(jclss, jagn, jregs),
                jdet=jdet, head=(clss, agn, regs))


def test_head_outputs_match_jax(pair):
    for name, got, ref in zip(("cls", "agn_hm", "bbox_reg"), pair["head"], pair["jhead"]):
        assert len(got) == len(ref) == 5
        for level, g, r in zip(P7_LEVELS, got, ref):
            r = np.asarray(r)
            assert nhwc(g).shape == r.shape, (name, level)
            assert_close_of_largest(nhwc(g), r, HEAD_TOL, f"{name} {level}")
    assert pair["head"][0][0].shape[1] == pair["n"]


def test_decode_on_jax_head_outputs(pair):
    """The port's decode on the JAX head's own outputs selects what the JAX
    decode selects."""
    to_t = lambda maps: [torch.from_numpy(np.array(m)).permute(0, 3, 1, 2) for m in maps]  # noqa: E731
    clss, agn, regs = (to_t(m) for m in pair["jhead"])
    det = onestage.decode_multiclass(clss, agn, regs, pair["cfg"], CANVAS, torch.tensor([IMAGE_HW]))
    got, ref = _np(det), _np(pair["jdet"])
    got = {k: v[0] for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    scale = float(np.abs(ref["boxes"]).max())
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=BOX_TOL * scale)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=SCORE_TOL)
    assert ref["valid"].sum() > 0 and ref["classes"][ref["valid"]].max() < pair["n"]


@pytest.fixture(scope="module")
def jax_builder(pair):
    """The image through the JAX package's jitted one-stage builder."""
    model, jfn = jos.build_onestage_inference_fn(pair["jcfg"])
    return _np(jfn(to_jax_params(pair["sd"]), jnp.asarray(pair["img"]), jnp.asarray(IMAGE_HW)))


def test_builder_matches_jax_builder(pair, jax_builder):
    ref = jax_builder
    fn = onestage.build_onestage_inference_fn(pair["cfg"], pair["sd"], device="cpu")
    before = nms_cuda.counter.launches
    got = _np(fn(pair["x"], IMAGE_HW))
    assert nms_cuda.counter.launches == before  # the plain twin on the CPU
    assert got["boxes"].shape == (pair["cfg"].centernet.post_nms_topk_test, 4)
    assert got["classes"].dtype == np.int32
    assert_match_by_class(got, ref)
    # in a batch of two each image decodes as alone (the convs of a batch
    # round differently, by a few ulps)
    batch = _np(fn(torch.stack([pair["x"], pair["x"].flip(-1)]), torch.tensor([IMAGE_HW] * 2)))
    assert_match_by_class({k: v[0] for k, v in batch.items()}, got)


def test_pinned_builder_matches_jax_builder(pair, jax_builder):
    """build_pinned_onestage_inference_fn (on the CPU the eager path) against
    the JAX package's jitted builder, one image and a batch of one."""
    fn = onestage.build_pinned_onestage_inference_fn(pair["cfg"], pair["sd"], device="cpu")
    got = _np(fn(pair["x"], IMAGE_HW))
    assert got["boxes"].shape == (pair["cfg"].centernet.post_nms_topk_test, 4)
    assert_match_by_class(got, jax_builder)
    batch = _np(fn(pair["x"][None], torch.tensor([IMAGE_HW])))
    assert_match_by_class({k: v[0] for k, v in batch.items()}, jax_builder)


def test_jax_tree_loads_strictly():
    """The JAX init's tree of the one-stage model (P6/P7 and the class
    tower included) is the port's state_dict, key for key and shape for
    shape."""
    jcfg, cfg = p3_p7(jax_get_config("finetune_vovnet"), 3), p3_p7(get_config("finetune_vovnet"), 3)
    sd = from_jax_params(jax_shapes(jos.OneStageCenterNet(jcfg), (1, *CANVAS, 3)))
    model = onestage.OneStageCenterNet(cfg)
    model.load_state_dict(sd, strict=True)
    assert {k for k in sd if "top_p" in k or "cls_" in k} == {
        "fpn.top_p6.weight", "fpn.top_p6.bias", "fpn.top_p7.weight", "fpn.top_p7.bias",
        "head.cls_tower0.weight", "head.cls_tower0.bias", "head.cls_tower0_gn.scale", "head.cls_tower0_gn.bias",
        "head.cls_logits.weight", "head.cls_logits.bias"}


@pytest.mark.parametrize("top_levels", [1, 2])
def test_fpn_top_levels_match_jax(top_levels):
    g = np.random.default_rng(top_levels)
    feats = {f"stage{i}": g.standard_normal((1, 64 // 2 ** (i - 3), 96 // 2 ** (i - 3), c)).astype(np.float32)
             for i, c in zip((3, 4, 5), (32, 48, 64))}
    jfpn = JaxFPN(out_channels=32, top_levels=top_levels)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    params = jax.jit(jfpn.init)(jax.random.PRNGKey(top_levels), jfeats)["params"]
    ref = jax.jit(jfpn.apply)({"params": params}, jfeats)
    fpn = FPN([32, 48, 64], out_channels=32, top_levels=top_levels)
    fpn.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = fpn({k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()})
    assert sorted(got) == sorted(ref) == [f"p{i}" for i in range(3, 6 + top_levels)]
    for k in ref:
        assert_close_of_largest(nhwc(got[k]), np.asarray(ref[k]), HEAD_TOL, k)


def test_detector_builds_top_levels_in_bf16():
    """CenterNet2Detector builds P6/P7 where fpn.top_levels asks (no longer
    refused); the top convs keep f32 weights under the compute dtype's
    cast and give f32 maps, as the JAX package's top convs do."""
    cfg = get_config("serving_vovnet")
    cfg = cfg.replace(fpn=dataclasses.replace(cfg.fpn, top_levels=2))
    model = CenterNet2Detector(cfg).cast_compute_weights().eval()
    assert model.fpn.top_p7.weight.dtype == torch.float32 and model.fpn.output5.weight.dtype == torch.bfloat16
    with torch.no_grad():
        feats = model.features(torch.zeros(1, 3, 128, 256))
    assert feats["p5"].dtype == torch.bfloat16 and feats["p7"].dtype == torch.float32
    assert tuple(feats["p7"].shape[-2:]) == (1, 2)


def test_canvas_not_a_multiple_of_the_coarsest_stride_is_refused():
    """At 160x224 the stride-2 P6/P7 convs round up while the grids floor:
    the JAX package fails on mismatched shapes, the port refuses the canvas
    before any work, naming input.size_divisibility."""
    jcfg, cfg = p3_p7(jax_get_config("finetune_vovnet"), 1), p3_p7(get_config("finetune_vovnet"), 1)
    img = np.zeros((160, 224, 3), np.float32)
    model, jfn = jos.build_onestage_inference_fn(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 160, 224, 3)))["params"]
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(jfn, shapes, jnp.asarray(img), jnp.asarray([160.0, 224.0]))
    fn = onestage.build_onestage_inference_fn(cfg, init_onestage_params(cfg, seed=0), device="cpu")
    with pytest.raises(ValueError, match="size_divisibility=128"):
        fn(torch.zeros(3, 160, 224), (160.0, 224.0))


def test_p7_canvas_of_a_vga_frame():
    """A 600x800 frame at short side 320 (320x427) serves on 384x512 under
    size_divisibility=128, by the host's canvas rule and the raw-frame
    builder's alike, and every level's grid is its map's shape."""
    cfg = p3_p7(get_config("finetune_vovnet"), 1)
    rh, rw = resize_shortest_edge_size(600, 800, cfg.input.min_size_test, cfg.input.max_size_test)
    d = cfg.input.size_divisibility
    assert (rh, rw) == (320, 427)
    assert canvas_for(rh, rw, divisibility=d) == (ceil_to(rh, d), ceil_to(rw, d)) == (384, 512)
    model = onestage.OneStageCenterNet(cfg).eval()
    with torch.no_grad():
        clss, _, _ = model(torch.zeros(1, 3, 384, 512))
    assert [tuple(c.shape[-2:]) for c in clss] == level_grid_shapes((384, 512), P7_STRIDES)
