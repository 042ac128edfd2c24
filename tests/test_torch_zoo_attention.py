"""The deformable conv, the DLA-Up decoder and the attention zoo of the port
against the JAX package, on the CPU.

- ``deform_conv2d`` against the JAX function and against the numpy
  transcription of the CUDA sampling formula in tests/test_deform_conv.py
  (with a mask, without, at stride 2): within 1e-5 of the largest |value|;
  with zero offsets it is ``F.conv2d`` within 1e-5.
- ``bilinear_upsample_2x`` (F.interpolate) against ``jax.image.resize``,
  borders included: 1e-6 of the largest.
- ``DLASeg`` at 64x64 with random non-zero offset and mask weights: 1e-4 of
  the largest.
- ``CoTAttention`` in eval mode and one train-mode step (its output 1e-4 of
  the largest, the running statistics rtol 1e-5), ``CBAMBlock`` (49x49
  spatial conv): 1e-4 of the largest.

Weights: the JAX init (jitted; FrozenBN affines near 1 and 0, BatchNorm's
running statistics drawn) carried across by ``from_jax_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from faster_orefsdet_tpu.models import dlaup as jdlaup
from faster_orefsdet_tpu.ops import attention as jattention
from faster_orefsdet_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from faster_orefsdet_tpu_torch.models.dlaup import DLASeg, bilinear_upsample_2x
from faster_orefsdet_tpu_torch.ops.attention import CBAMBlock, CoTAttention
from faster_orefsdet_tpu_torch.ops.deform_conv import deform_conv2d
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_deform_conv import _ref_dcn
from test_torch_dla import STAT_RTOL, assert_close_of_largest, nhwc
from test_torch_resnet import perturb_norms
import torch_budget  # noqa: F401 (the suite's torch thread budget)

DCN_TOL, UP_TOL, OUT_TOL = 1e-5, 1e-6, 1e-4


def dcn_inputs(seed, b, h, w, c, co, stride, with_mask):
    g = np.random.default_rng(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = g.standard_normal((b, h, w, c)).astype(np.float32)
    offsets = (g.standard_normal((b, ho, wo, 18)) * 1.5).astype(np.float32)
    weights = (g.standard_normal((3, 3, c, co)) * 0.2).astype(np.float32)
    mask = g.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32) if with_mask else None
    return x, offsets, weights, mask


def port_dcn(x, offsets, weights, mask, stride=1):
    t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    out = deform_conv2d(t(x), t(offsets), torch.from_numpy(weights).permute(3, 2, 0, 1),
                        None if mask is None else t(mask), stride=stride)
    return nhwc(out)


@pytest.mark.parametrize("stride,with_mask", [(1, True), (1, False), (2, True)],
                         ids=["mask", "no_mask", "stride2"])
def test_deform_conv_matches_jax_and_numpy(stride, with_mask):
    x, offsets, weights, mask = dcn_inputs(stride + 2 * with_mask, 2, 7, 9, 4, 5, stride, with_mask)
    got = port_dcn(x, offsets, weights, mask, stride)
    ref = np.stack([np.asarray(jax_deform_conv2d(jnp.asarray(x[i]), jnp.asarray(offsets[i]), jnp.asarray(weights),
                                                 None if mask is None else jnp.asarray(mask[i]), stride=stride))
                    for i in range(2)])
    assert_close_of_largest(got, ref, DCN_TOL, "vs JAX")
    oracle = np.stack([_ref_dcn(x[i], offsets[i], weights, None if mask is None else mask[i], stride=stride)
                       for i in range(2)])
    assert_close_of_largest(got, oracle, DCN_TOL, "vs the numpy transcription")


def test_deform_conv_zero_offsets_is_conv():
    x, offsets, weights, _ = dcn_inputs(5, 2, 8, 10, 3, 6, 1, False)
    got = port_dcn(x, np.zeros_like(offsets), weights, None)
    ref = nhwc(F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(weights).permute(3, 2, 0, 1),
                        padding=1))
    assert_close_of_largest(got, ref, DCN_TOL, "zero offsets")


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (8, 8)])
def test_bilinear_upsample_matches_jax_resize(hw):
    x = np.random.default_rng(hw[0]).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jdlaup.bilinear_upsample_2x(jnp.asarray(x)))
    got = nhwc(bilinear_upsample_2x(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == ref.shape
    assert_close_of_largest(got, ref, UP_TOL, f"upsample {hw}")


def randomize_offsets(tree, seed):
    """The DCN blocks' offset/mask convs drawn at random (they start at
    zero), so that the samples leave the grid and the masks differ."""
    g = np.random.default_rng(seed)

    def walk(node, name):
        if not isinstance(node, dict):
            arr = np.asarray(node)
            if name == "offset/kernel":
                return (g.standard_normal(arr.shape) * 0.5 / np.sqrt(np.prod(arr.shape[:3]))).astype(np.float32)
            if name == "offset/bias":
                return (g.standard_normal(arr.shape) * 0.5).astype(np.float32)
            return arr
        return {k: walk(v, f"{name.rsplit('/', 1)[-1]}/{k}") for k, v in node.items()}

    return walk(tree, "")


def test_dlaseg_matches_jax():
    x = np.random.default_rng(6).standard_normal((1, 64, 64, 3)).astype(np.float32)
    module = jdlaup.DLASeg(num_layers=34)
    params = jax.jit(module.init)(jax.random.PRNGKey(6), jnp.asarray(x))["params"]
    params = randomize_offsets(perturb_norms(params, 6), 6)
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x))["dla2"])
    model = DLASeg(34)
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))["dla2"]
    assert tuple(got.shape) == (1, 64, 16, 16)
    assert_close_of_largest(nhwc(got), ref, OUT_TOL, "dla2")


def random_stats(stats, seed):
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (g.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else 0.1 * g.standard_normal(a.shape)).astype(np.float32), stats)


@pytest.fixture(scope="module")
def cot():
    x = np.random.default_rng(8).standard_normal((2, 6, 7, 32)).astype(np.float32)
    module = jattention.CoTAttention(32)
    variables = jax.jit(module.init)(jax.random.PRNGKey(8), jnp.asarray(x))
    params = perturb_norms(variables["params"], 8)
    stats = random_stats(variables["batch_stats"], 8)
    model = CoTAttention(32)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    return x, module, params, stats, model


def test_cot_eval_matches_jax(cot):
    x, module, params, stats, model = cot
    ref = np.asarray(jax.jit(module.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close_of_largest(nhwc(got), ref, OUT_TOL, "CoT eval")


def test_cot_train_step_matches_jax(cot):
    x, module, params, stats, model = cot
    apply = jax.jit(lambda v, t: module.apply(v, t, train=True, mutable=["batch_stats"]))
    ref, new = apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = CoTAttention(32)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    assert_close_of_largest(nhwc(got), np.asarray(ref), OUT_TOL, "CoT train")
    sd = model.state_dict()
    for bn, leaves in new["batch_stats"].items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(sd[f"{bn}.{leaf}"].numpy(), np.asarray(value), rtol=STAT_RTOL,
                                       atol=STAT_RTOL * float(np.abs(value).max()), err_msg=f"{bn}.{leaf}")


def test_cbam_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 12, 16, 32)).astype(np.float32)
    module = jattention.CBAMBlock(32)
    params = jax.jit(module.init)(jax.random.PRNGKey(9), jnp.asarray(x))["params"]
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    model = CBAMBlock(32)
    model.load_state_dict(from_jax_params(params), strict=True)
    assert tuple(model.sa.conv.weight.shape) == (1, 2, 49, 49)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close_of_largest(nhwc(got), ref, OUT_TOL, "CBAM")
