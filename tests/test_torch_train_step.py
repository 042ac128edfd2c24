"""The port's fine-tuning step against the JAX package's, on the CPU: the
losses and every trainable parameter's gradient of `loss_fn` with dropout
off and an injected ROI set (the JAX package's parity hooks), the frozen
set, the correlate split (fused CGM for serving, a differentiable
composition for training) and the CGM wrapper's refusal of gradients.

Measured worst on this file's inputs: losses 3.4e-7 relative; gradients
2.4e-6 of their tensor's largest |grad| (tolerances 1e-4 and 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.pipelines.inference import make_detector as jax_make_detector
from faster_orefsdet_tpu.pipelines.train_step import TrainBatch as JaxBatch
from faster_orefsdet_tpu.pipelines.train_step import loss_fn as jax_loss_fn
from faster_orefsdet_tpu.solver import param_labels as jax_param_labels
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector, support_kernels
from faster_orefsdet_tpu_torch.ops import cgm_cuda
from faster_orefsdet_tpu_torch.pipelines.train_step import (
    TrainBatch,
    build_train_state,
    build_train_step,
    loss_fn,
    make_train_model,
)
from faster_orefsdet_tpu_torch.solver import param_labels
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_torch_parity import make_torch_state_dict
import torch_budget  # noqa: F401 (the suite's torch thread budget)

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # of each tensor's largest |grad|
CANVAS = (96, 128)


def small(cfg):
    """The JAX package's train-step test sizes: 2 shots, 8 gt slots, 32 ROIs."""
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=200, post_nms_topk_train=64),
        roi=dataclasses.replace(cfg.roi, batch_size_per_image=32),
        fs=dataclasses.replace(cfg.fs, support_shot=2),
        static=dataclasses.replace(cfg.static, max_gt_per_image=8),
    )


def make_inputs(seed=7, b=2, n=8, s=2):
    """A batch of b images (numpy, NHWC as the JAX package takes it) and an
    injected ROI set: on-gt, jittered and background boxes, a few invalid."""
    g = np.random.default_rng(seed)
    images = g.standard_normal((b, *CANVAS, 3)).astype(np.float32)
    sup = g.standard_normal((b, s, 64, 64, 3)).astype(np.float32)
    sup_boxes = np.tile(np.asarray([[4.0, 4.0, 60.0, 60.0], [8.0, 6.0, 50.0, 58.0]], np.float32), (b, 1, 1))
    gt = np.zeros((b, n, 4), np.float32)
    valid = np.zeros((b, n), bool)
    # boxes in the p3-only and p3+p4 size ranges (half diagonals 31 and 64)
    gt[:, 0] = [8.0, 8, 56, 48]
    gt[:, 1] = [20, 10, 120, 90]
    gt[1, 2] = [60, 40, 90, 70]
    valid[:, :2] = True
    valid[1, 2] = True
    jit = g.uniform(-6, 6, (b, 6, 4)).astype(np.float32)
    xy = g.uniform(0, 80, (b, 12, 2)).astype(np.float32)
    wh = g.uniform(10, 40, (b, 12, 2)).astype(np.float32)
    rois = np.concatenate([gt[:, :2], np.repeat(gt[:, :2], 3, axis=1) + jit, np.concatenate([xy, xy + wh], 2)], 1)
    rois[..., 2] = np.maximum(rois[..., 2], rois[..., 0] + 4)
    rois[..., 3] = np.maximum(rois[..., 3], rois[..., 1] + 4)
    roi_valid = np.ones(rois.shape[:2], bool)
    roi_valid[:, -2:] = False
    hw = np.asarray([[96.0, 120.0], [80.0, 128.0]], np.float32)[:b]
    return dict(images=images, hw=hw, gt=gt, valid=valid, sup=sup, sup_boxes=sup_boxes, rois=rois,
                roi_valid=roi_valid)


def port_batch(x):
    return TrainBatch(
        torch.from_numpy(x["images"]).permute(0, 3, 1, 2), torch.from_numpy(x["hw"]),
        torch.from_numpy(x["gt"]), torch.zeros(x["gt"].shape[:2], dtype=torch.int32),
        torch.from_numpy(x["valid"]), torch.from_numpy(x["sup"]).permute(0, 1, 4, 2, 3),
        torch.from_numpy(x["sup_boxes"]),
    )


@pytest.fixture(scope="module")
def parity():
    """One JAX value_and_grad (one compile) and the port's loss and backward
    on the same weights and inputs."""
    jcfg, cfg = small(jax_get_config("finetune_vovnet")), small(get_config("finetune_vovnet"))
    params = convert_torch_checkpoint(make_torch_state_dict(seed=5))
    x = make_inputs()
    jbatch = JaxBatch(jnp.asarray(x["images"]), jnp.asarray(x["hw"]), jnp.asarray(x["gt"]),
                      jnp.zeros(x["gt"].shape[:2], jnp.int32), jnp.asarray(x["valid"]), jnp.asarray(x["sup"]),
                      jnp.asarray(x["sup_boxes"]))
    model = jax_make_detector(jcfg)
    rois = (jnp.asarray(x["rois"]), jnp.asarray(x["roi_valid"]))
    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, model, jcfg, jax.random.PRNGKey(0), deterministic=True,
                              injected_rois=rois),
        has_aux=True))(params)

    port = make_train_model(cfg, from_jax_params(jax.tree.map(np.asarray, params)), device="cpu")
    total, losses = loss_fn(port, port_batch(x), deterministic=True,
                            injected_rois=(torch.from_numpy(x["rois"]), torch.from_numpy(x["roi_valid"])))
    total.backward()
    return dict(jtotal=float(jtotal), jlosses={k: float(v) for k, v in jlosses.items()},
                jgrads=from_jax_params(jax.tree.map(np.asarray, jgrads)), total=float(total.detach()),
                losses={k: float(v.detach()) for k, v in losses.items()}, model=port, params=params, cfg=cfg)


def test_losses_match_jax(parity):
    p = parity
    assert set(p["losses"]) == set(p["jlosses"]) == {
        "loss_centernet_loc", "loss_centernet_agn_pos", "loss_centernet_agn_neg", "loss_cls_stage0",
        "loss_box_reg_stage0"}
    for k, ref in p["jlosses"].items():
        assert np.isfinite(ref) and ref != 0.0, k
        np.testing.assert_allclose(p["losses"][k], ref, rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(p["total"], p["jtotal"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("part", ["backbone", "fpn", "vip", "cgm_conv3", "head", "roi"])
def test_gradients_match_jax(parity, part):
    """Every trainable parameter's gradient within GRAD_TOL of its tensor's
    largest |grad| (grouped by module so that a failure names its place)."""
    p = parity
    checked = 0
    for name, param in p["model"].named_parameters():
        if not name.startswith(part) or not param.requires_grad:
            continue
        ref = p["jgrads"][name]
        assert param.grad is not None, name
        scale = float(ref.abs().max())
        err = float((param.grad - ref).abs().max())
        assert err <= GRAD_TOL * scale, f"{name}: max err {err:.3e}, largest |grad| {scale:.3e}"
        checked += 1
    assert checked > 0


def test_frozen_set_matches_jax_labels(parity):
    """The port's labels equal the JAX solver's on every leaf; the frozen
    ones never require grad and get no gradient."""
    p = parity
    jlabels = {k: str(v) for k, v in from_jax_params_labels(jax_param_labels(p["params"])).items()}
    labels = param_labels(p["model"])
    assert labels == jlabels
    for name, param in p["model"].named_parameters():
        frozen = labels[name] == "frozen"
        assert param.requires_grad != frozen, name
        assert (param.grad is None) == frozen, name


def from_jax_params_labels(tree):
    """from_jax_params' key renaming, on a tree of labels."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                out[key[: -len("kernel")] + "weight" if key.endswith(".kernel") else key] = v

    walk(tree, "")
    return out


def test_step_freezes_and_trains():
    """A step with dropout and ROI sampling on: finite metrics, the frozen
    parameters and buffers unchanged, most trainable tensors moved."""
    cfg = small(get_config("finetune_vovnet"))
    sd = from_jax_params(jax.tree.map(np.asarray, convert_torch_checkpoint(make_torch_state_dict(seed=1))))
    state = build_train_state(cfg, sd, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = build_train_step(cfg)(state, port_batch(make_inputs(seed=3)))
    assert state.step == 1
    assert all(v.dim() == 0 and torch.isfinite(v) for v in metrics.values())
    labels = param_labels(state.model)
    moved = 0
    for k, v in state.model.state_dict().items():
        if labels[k] == "frozen":
            assert torch.equal(v, before[k]), k
        else:
            moved += int(not torch.equal(v, before[k]))
    assert moved > 40


def test_uint8_batch_is_normalized_like_jax():
    """prepare_batch on a raw uint8 batch equals the JAX package's."""
    from faster_orefsdet_tpu.pipelines.train_step import prepare_batch as jax_prepare
    from faster_orefsdet_tpu_torch.pipelines.train_step import prepare_batch

    cfg = get_config("finetune_vovnet")
    g = np.random.default_rng(0)
    img = g.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    sup = g.integers(0, 256, (2, 2, 256, 256, 3), dtype=np.uint8)
    hw = np.asarray([[60.0, 90.0], [64.0, 70.0]], np.float32)
    z = np.zeros((2, 1, 4), np.float32)
    ref = jax_prepare(JaxBatch(jnp.asarray(img), jnp.asarray(hw), jnp.asarray(z), jnp.zeros((2, 1), jnp.int32),
                               jnp.ones((2, 1), bool), jnp.asarray(sup), jnp.zeros((2, 2, 4))), jax_get_config())
    got = prepare_batch(TrainBatch(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(hw),
                                   torch.from_numpy(z), torch.zeros(2, 1, dtype=torch.int32),
                                   torch.ones(2, 1, dtype=torch.bool),
                                   torch.from_numpy(sup).permute(0, 1, 4, 2, 3), torch.zeros(2, 2, 4)), cfg)
    np.testing.assert_array_equal(got.images.permute(0, 2, 3, 1).numpy(), np.asarray(ref.images))
    np.testing.assert_array_equal(got.support_images.permute(0, 1, 3, 4, 2).numpy(), np.asarray(ref.support_images))


# ------------------------------------------------------------ the CGM split

def _correlate_inputs(g, b=2, c=128):
    q = {lvl: torch.from_numpy(g.standard_normal((b, c, h, w), dtype=np.float32))
         for lvl, (h, w) in (("p3", (12, 16)), ("p4", (6, 8)), ("p5", (3, 4)))}
    maps = {lvl: torch.from_numpy(g.standard_normal((b, s, s, c), dtype=np.float32))
            for lvl, s in (("p3", 32), ("p4", 16), ("p5", 8))}
    return q, maps


def test_fused_cgm_refuses_gradients():
    t = [torch.zeros(1, 4, 5, 128), torch.zeros(128), torch.zeros(3, 128), torch.zeros(3, 128),
         torch.zeros(128, 256), torch.zeros(128)]
    t[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cgm_cuda.cgm_correlate_fused(*t)
    with torch.no_grad():  # the same inputs without grad mode run
        assert cgm_cuda.cgm_correlate_fused(*t).shape == (1, 4, 5, 128)


def test_correlate_composition_is_differentiable_and_equals_fused():
    """Without use_pallas_cgm, correlate is the differentiable composition:
    gradients reach cgm_conv3 and the taps, and per-image taps give what the
    fused plain path gives image by image (within 1e-5)."""
    g = np.random.default_rng(0)
    model = CenterNet2Detector(get_config("finetune_vovnet"))
    assert not model.cfg.use_pallas_cgm
    q, maps = _correlate_inputs(g)
    maps = {k: v.requires_grad_(True) for k, v in maps.items()}
    kernels = {k: support_kernels(v) for k, v in maps.items()}  # per image: [B, C], [B, 3, C]
    out = model.correlate(q, kernels)
    sum(v.square().sum() for v in out.values()).backward()
    assert model.cgm_conv3.weight.grad.abs().max() > 0
    assert all(v.grad is not None and v.grad.abs().max() > 0 for v in maps.values())

    fused_model = CenterNet2Detector(get_config("serving_vovnet").replace(compute_dtype="float32"))
    fused_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        for i in range(2):
            ref = fused_model.correlate({k: v[i:i + 1] for k, v in q.items()},
                                        {k: support_kernels(v[i].detach()) for k, v in maps.items()})
            for lvl in ref:
                np.testing.assert_allclose(out[lvl][i:i + 1].detach().numpy(), ref[lvl].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=lvl)


def test_serving_correlate_still_fused(monkeypatch):
    """Every serving preset goes through cgm_correlate_fused (the CGM kernel
    on the card) once per level; fine-tuning never does. A preset of a
    backbone family the port does not build yet is refused."""
    from faster_orefsdet_tpu_torch.config import PRESETS
    from faster_orefsdet_tpu_torch.models import detector

    calls = []
    monkeypatch.setattr(detector, "cgm_correlate_fused", lambda *a, **k: calls.append(1) or a[0])
    for name in PRESETS:
        cfg = get_config(name)
        if cfg.backbone_name not in detector.BACKBONES:
            with pytest.raises(ValueError, match="the port has"):
                CenterNet2Detector(cfg)
            continue
        q, maps = _correlate_inputs(np.random.default_rng(1), b=1, c=cfg.fpn.out_channels)
        kernels = {k: support_kernels(v[0]) for k, v in maps.items()}
        calls.clear()
        with torch.no_grad():
            CenterNet2Detector(cfg).correlate(q, kernels)
        assert len(calls) == (3 if name.startswith("serving") else 0), name
