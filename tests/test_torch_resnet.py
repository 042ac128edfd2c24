"""The ResNet-50 and MobileNetV3 families in the port against the JAX
package, on the CPU: ResNetC4 (res3-res5) and Res5Stage, MobileNetV3Small,
the torchvision ResNet converter (its keys, and its weights run with the
stride on the 3x3 conv), and the two CenterNet2 detectors built on them:
`finetune_R_50_C4_1x` (a batch-1 query path, then `loss_fn`'s losses and
gradients with injected ROIs) and `mnv3_fpn` (batch-1 serving).

Weights: the JAX package's own init (FrozenBN affines drawn near 1 / 0 so
that they act), carried across by the port's `from_jax_params`. Sizes:
queries 96x128, 2 shots of 64x64, the small budgets of
tests/test_torch_train_step.py. The R-50 query path and `loss_fn`'s
value_and_grad are one jit of the JAX side.

Tolerances: module outputs within 1e-4 of each map's largest |value|;
detections greedy-matched (>= 85% at IoU >= 0.95, top 10 matched, |dscore|
<= 2e-4); losses rtol 1e-4; gradients within 1e-3 of each tensor's largest
|grad|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.models import mobilenet as jmnv3
from faster_orefsdet_tpu.models import resnet as jresnet
from faster_orefsdet_tpu.pipelines import inference as jinf
from faster_orefsdet_tpu.pipelines import support_cache as jsc
from faster_orefsdet_tpu.pipelines.train_step import TrainBatch as JaxBatch
from faster_orefsdet_tpu.pipelines.train_step import loss_fn as jax_loss_fn
from faster_orefsdet_tpu.utils.params import init_params as jax_init_params
from faster_orefsdet_tpu.utils.torch_convert import convert_torchvision_resnet as jax_convert_resnet
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector
from faster_orefsdet_tpu_torch.models.mobilenet import MobileNetV3Small
from faster_orefsdet_tpu_torch.models.resnet import RESNET_DEPTH_SPECS, Res5Stage, ResNetC4
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache
from faster_orefsdet_tpu_torch.pipelines.train_step import loss_fn, make_train_model
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from faster_orefsdet_tpu_torch.utils.torch_convert import convert_torchvision_resnet
from test_torch_dla import assert_close_of_largest, nhwc
from test_torch_slice import _assert_detections_match, _np
from test_torch_train_step import make_inputs, port_batch, small
import torch_budget  # noqa: F401 (the suite's torch thread budget)

OUT_TOL = 1e-4
LOSS_RTOL, GRAD_TOL = 1e-4, 1e-3
RES = ("res3", "res4", "res5")


def perturb_norms(tree, seed):
    """The tree with every FrozenBN affine (`norm/scale`, `norm/bias`) drawn
    near 1 and 0: the init's identity would not show a misplaced norm."""
    g = np.random.default_rng(seed)

    def walk(node, name):
        if not isinstance(node, dict):
            arr = np.asarray(node)
            if name == "norm/scale":
                return (1.0 + 0.1 * g.standard_normal(arr.shape)).astype(np.float32)
            if name == "norm/bias":
                return (0.1 * g.standard_normal(arr.shape)).astype(np.float32)
            return arr
        return {k: walk(v, f"{name.rsplit('/', 1)[-1]}/{k}") for k, v in node.items()}

    return walk(jax.tree.map(np.asarray, tree), "")


def jax_module(module, x, seed, jit=False):
    """The module's init (norms perturbed) and output; jit=True compiles
    both (quicker than op by op for MobileNetV3's many small ops)."""
    init, apply = (jax.jit(module.init), jax.jit(module.apply)) if jit else (module.init, module.apply)
    params = perturb_norms(init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)
    return params, apply({"params": params}, jnp.asarray(x))


def port_module(module, params):
    module.load_state_dict(from_jax_params(params), strict=True)
    return module.eval()


def images(seed, shape=(1, 64, 96, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_resnet_c4_matches_jax(stride_in_1x1):
    x = images(0)
    params, ref = jax_module(jresnet.ResNetC4(depth=50, out_features=RES, stride_in_1x1=stride_in_1x1), x, 1)
    model = port_module(ResNetC4(50, RES, stride_in_1x1=stride_in_1x1), params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(ref) == set(RES)
    for k in RES:
        assert got[k].shape[1] == ResNetC4.out_channels()[k]
        assert_close_of_largest(nhwc(got[k]), np.asarray(ref[k]), OUT_TOL, k)


def test_res5_stage_matches_jax():
    x = images(2, (2, 14, 14, 1024))
    params, ref = jax_module(jresnet.Res5Stage(), x, 3)
    model = port_module(Res5Stage(), params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 2048, 7, 7)
    assert_close_of_largest(nhwc(got), np.asarray(ref), OUT_TOL, "res5")


def test_mobilenet_v3_small_matches_jax():
    x = images(4)
    feats = ("res2", "res3", "res4", "res5")
    params, ref = jax_module(jmnv3.MobileNetV3Small(out_features=feats), x, 5, jit=True)
    model = port_module(MobileNetV3Small(feats), params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in feats:
        assert got[k].shape[1] == MobileNetV3Small.out_channels()[k]
        assert_close_of_largest(nhwc(got[k]), np.asarray(ref[k]), OUT_TOL, k)


def torchvision_resnet_state_dict(seed, depth=50):
    """A random state_dict in torchvision's ResNet layout (fc included)."""
    g = np.random.default_rng(seed)
    sd = {}

    def conv(key, o, i, k):
        sd[key + ".weight"] = (g.standard_normal((o, i, k, k)) / np.sqrt(i * k * k)).astype(np.float32)

    def bn(key, c):
        sd[key + ".weight"] = (1 + 0.1 * g.standard_normal(c)).astype(np.float32)
        sd[key + ".bias"] = (0.1 * g.standard_normal(c)).astype(np.float32)
        sd[key + ".running_mean"] = (0.1 * g.standard_normal(c)).astype(np.float32)
        sd[key + ".running_var"] = g.uniform(0.5, 1.5, c).astype(np.float32)
        sd[key + ".num_batches_tracked"] = np.asarray(7, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for si, (bc, oc) in enumerate([(64, 256), (128, 512), (256, 1024), (512, 2048)]):
        for b in range(RESNET_DEPTH_SPECS[depth][si]):
            p = f"layer{si + 1}.{b}"
            conv(f"{p}.conv1", bc, in_ch if b == 0 else oc, 1)
            conv(f"{p}.conv2", bc, bc, 3)
            conv(f"{p}.conv3", oc, bc, 1)
            for i in (1, 2, 3):
                bn(f"{p}.bn{i}", bc if i < 3 else oc)
            if b == 0:
                conv(f"{p}.downsample.0", oc, in_ch, 1)
                bn(f"{p}.downsample.1", oc)
        in_ch = oc
    sd["fc.weight"] = g.standard_normal((1000, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def test_convert_torchvision_resnet_matches_jax():
    """Key for key equal to the JAX package's converter; the weights load
    strictly into the port's ResNetC4 with stride_in_1x1=False and run as
    the JAX ResNetC4 runs its own converted tree."""
    sd = torchvision_resnet_state_dict(6)
    jtree = jax_convert_resnet(sd)
    ref = from_jax_params(jtree)
    got = convert_torchvision_resnet({"model": {k: torch.from_numpy(v) for k, v in sd.items()}})
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
    feats = ("res2", *RES)
    model = ResNetC4(50, feats, stride_in_1x1=False)
    model.load_state_dict(got, strict=True)
    x = images(7)
    jref = jresnet.ResNetC4(depth=50, out_features=feats, stride_in_1x1=False).apply({"params": jtree}, jnp.asarray(x))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in feats:
        assert_close_of_largest(nhwc(out[k]), np.asarray(jref[k]), OUT_TOL, k)
    Res5Stage(stride_in_1x1=False).load_state_dict({k: v for k, v in got.items() if k.startswith("res5.")},
                                                   strict=True)


def serving_small(cfg):
    """The small budgets of tests/test_r50_config.py on top of `small`."""
    cfg = small(cfg)
    return cfg.replace(centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=64, post_nms_topk_test=16),
                       roi=dataclasses.replace(cfg.roi, detections_per_image=8))


def cache_arrays(cfg, seed):
    g = np.random.default_rng(seed)
    c, p1, p2 = cfg.fpn.out_channels, cfg.roi.pooler_resolution, cfg.roi.pooler_resolution2
    return [(0.5 * g.standard_normal((*s, c))).astype(np.float32) for s in ((32, 32), (16, 16), (8, 8), (p1, p1),
                                                                           (p2, p2))]


def query_image(seed):
    return np.random.default_rng(seed).standard_normal((96, 128, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def r50():
    """finetune_R_50_C4_1x at the small sizes: one jit of the JAX side runs
    the batch-1 query path and value_and_grad of loss_fn (dropout off,
    injected ROIs); the port runs the same on the CPU."""
    jcfg, cfg = serving_small(jax_get_config("finetune_R_50_C4_1x")), serving_small(get_config("finetune_R_50_C4_1x"))
    model = jinf.make_detector(jcfg)
    params = perturb_norms(jax.jit(lambda key: jax_init_params(model, jcfg, key))(jax.random.PRNGKey(0)), 8)
    arrays = cache_arrays(cfg, 9)
    img, hw = query_image(10), np.asarray([96.0, 120.0], np.float32)
    x = make_inputs()
    jbatch = JaxBatch(jnp.asarray(x["images"]), jnp.asarray(x["hw"]), jnp.asarray(x["gt"]),
                      jnp.zeros(x["gt"].shape[:2], jnp.int32), jnp.asarray(x["valid"]), jnp.asarray(x["sup"]),
                      jnp.asarray(x["sup_boxes"]))
    rois = (jnp.asarray(x["rois"]), jnp.asarray(x["roi_valid"]))

    def run(params):
        det = jinf.query_path_single(model, params, jsc.SupportCache(*map(jnp.asarray, arrays)), jnp.asarray(img),
                                     jnp.asarray(hw), jcfg)
        (total, losses), grads = jax.value_and_grad(
            lambda p: jax_loss_fn(p, jbatch, model, jcfg, jax.random.PRNGKey(0), deterministic=True,
                                  injected_rois=rois), has_aux=True)(params)
        return det, total, losses, grads

    det, total, losses, grads = jax.tree.map(np.asarray, jax.jit(run)(params))
    sd = from_jax_params(params)
    port = make_train_model(cfg, sd, device="cpu")
    ptotal, plosses = loss_fn(port, port_batch(x), deterministic=True,
                              injected_rois=(torch.from_numpy(x["rois"]), torch.from_numpy(x["roi_valid"])))
    ptotal.backward()
    pdet = tinf.query_path_single(tinf.make_detector(cfg, sd, device="cpu"), SupportCache(*map(torch.from_numpy, arrays)),
                                  torch.from_numpy(img).permute(2, 0, 1), torch.from_numpy(hw))
    return dict(det=det, jtotal=float(total), jlosses={k: float(v) for k, v in losses.items()},
                jgrads=from_jax_params(grads), pdet=pdet, total=float(ptotal.detach()),
                losses={k: float(v.detach()) for k, v in plosses.items()}, model=port)


def test_r50_builds_in_the_port():
    cfg = get_config("finetune_R_50_C4_1x")
    model = CenterNet2Detector(cfg)
    assert isinstance(model.backbone, ResNetC4) and model.backbone.stages == ["res2", "res3", "res4", "res5"]
    assert cfg.roi.pooler_resolution == cfg.roi.pooler_resolution2 == 4 and cfg.fs.support_shot == 9


def test_r50_query_path_matches_jax(r50):
    _assert_detections_match(_np(r50["pdet"]), {k: np.asarray(getattr(r50["det"], k)) for k in ("boxes", "scores", "valid")})


def test_r50_losses_match_jax(r50):
    assert set(r50["losses"]) == set(r50["jlosses"])
    for k, ref in r50["jlosses"].items():
        assert np.isfinite(ref) and ref != 0.0, k
        np.testing.assert_allclose(r50["losses"][k], ref, rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(r50["total"], r50["jtotal"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("part", ["backbone", "fpn", "vip", "cgm_conv3", "head", "roi"])
def test_r50_gradients_match_jax(r50, part):
    """Every trainable parameter's gradient; the stem is frozen by name in
    both packages (FREEZE_AT itself is applied by neither)."""
    checked = 0
    for name, param in r50["model"].named_parameters():
        if not name.startswith(part):
            continue
        if not param.requires_grad:
            assert name.startswith("backbone.stem."), name
            continue
        ref = r50["jgrads"][name]
        scale = float(ref.abs().max())
        err = float((param.grad - ref).abs().max())
        assert err <= GRAD_TOL * scale, f"{name}: max err {err:.3e}, largest |grad| {scale:.3e}"
        checked += 1
    assert checked > 0


def test_mnv3_fpn_serving_matches_jax():
    """mnv3_fpn batch 1 through build_inference_fn against the JAX
    package's jitted builder."""
    jcfg = serving_small(jax_get_config("finetune_vovnet")).replace(backbone_name="mnv3_fpn")
    cfg = serving_small(get_config("finetune_vovnet")).replace(backbone_name="mnv3_fpn")
    model = jinf.make_detector(jcfg)
    params = perturb_norms(jax.jit(lambda key: jax_init_params(model, jcfg, key))(jax.random.PRNGKey(1)), 11)
    arrays = cache_arrays(cfg, 12)
    img, hw = query_image(13), (96.0, 128.0)
    ref = jinf.build_inference_fn(jcfg)(params, jsc.SupportCache(*map(jnp.asarray, arrays)), jnp.asarray(img),
                                        jnp.asarray(hw))
    fn = tinf.build_inference_fn(cfg, from_jax_params(params), device="cpu")
    det = fn(SupportCache(*map(torch.from_numpy, arrays)), torch.from_numpy(img).permute(2, 0, 1), hw)
    _assert_detections_match(_np(det), {k: np.asarray(getattr(ref, k)) for k in ("boxes", "scores", "valid")})
