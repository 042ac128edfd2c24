"""The backbone zoo of the port against the JAX package, on the CPU: the
seven VoVNet specs (each spec's state_dict keys and shapes equal to the JAX
tree's; V-39-eSE, with its identity blocks, and V-19-dw-eSE, with its
depthwise blocks and reduction 1x1s, run), Res2Net (depth 18's block counts run, depth 50 by keys) and
RegNet X and Y (a shallow depth run; X-400MF and Y-400MF by keys, which
holds the group-width rounding).

Weights: the JAX init (jitted; FrozenBN affines drawn near 1 and 0 so that
they act) carried across by ``from_jax_params``; inputs 64x64, seeded.
Tolerance: each output within 1e-4 of its map's largest |value|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.models import regnet as jregnet
from faster_orefsdet_tpu.models import res2net as jres2net
from faster_orefsdet_tpu.models import vovnet as jvovnet
from faster_orefsdet_tpu_torch.models.layers import QuantConv
from faster_orefsdet_tpu_torch.models.regnet import RegNet, block_widths, generate_regnet_parameters
from faster_orefsdet_tpu_torch.models.res2net import Res2Net
from faster_orefsdet_tpu_torch.models.vovnet import VOVNET_STAGE_SPECS, DWConvNorm, VoVNet
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_torch_dla import assert_close_of_largest, nhwc
from test_torch_resnet import images, jax_module, port_module
import torch_budget  # noqa: F401 (the suite's torch thread budget)

OUT_TOL = 1e-4
STAGES = ("stage2", "stage3", "stage4", "stage5")
REGNET_Y_400MF = dict(w_a=27.89, w_0=48, w_m=2.09, depth=16, group_width=8, se_ratio=0.25)


def jax_shapes(module, shape=(1, 64, 64, 3)):
    """The JAX module's params as zero arrays of their shapes (no compile)."""
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape))["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)


def run_both(jmod, port, seed, x):
    params, ref = jax_module(jmod, x, seed, jit=True)
    model = port_module(port, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got, ref


def test_vovnet_has_every_spec_of_the_jax_package():
    assert VOVNET_STAGE_SPECS == jvovnet.VOVNET_STAGE_SPECS


@pytest.mark.parametrize("spec", sorted(VOVNET_STAGE_SPECS))
def test_vovnet_spec_keys_match_jax(spec):
    """Every spec's JAX tree loads strictly, shape for shape."""
    sd = from_jax_params(jax_shapes(jvovnet.VoVNet(conv_body=spec, out_features=STAGES)))
    VoVNet(spec, STAGES).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("spec", ["V-39-eSE", "V-19-dw-eSE"])
def test_vovnet_spec_matches_jax(spec):
    got, ref = run_both(jvovnet.VoVNet(conv_body=spec, out_features=("stem",) + STAGES),
                        VoVNet(spec, ("stem",) + STAGES), 7, images(3, (1, 64, 64, 3)))
    for k in ("stem",) + STAGES:
        assert got[k].shape[1] == VoVNet.out_channels(spec)[k]
        assert_close_of_largest(nhwc(got[k]), np.asarray(ref[k]), OUT_TOL, f"{spec} {k}")


def test_depthwise_blocks_stay_float_under_int8():
    """Under quant the dense convs (the reduction 1x1s included) are int8,
    the depthwise blocks stay in the compute dtype, as in the JAX package."""
    model = VoVNet("V-19-dw-eSE", STAGES, quant=True)
    assert isinstance(model.stem1.conv, QuantConv) and isinstance(model.stage2_block0.reduction.conv, QuantConv)
    dws = [m for m in model.modules() if isinstance(m, DWConvNorm)]
    assert len(dws) == 2 + 4 * 3
    assert not any(isinstance(c, QuantConv) for m in dws for c in m.children())
    with pytest.raises(ValueError, match="dense VoVNet specs only"):
        VoVNet("V-19-dw-eSE", STAGES, resident=True)


def test_res2net_matches_jax():
    feats = ("res2", "res3", "res4", "res5")
    got, ref = run_both(jres2net.Res2Net(depth=18, out_features=feats), Res2Net(18, feats), 11,
                        images(4, (1, 64, 64, 3)))
    for k in feats:
        assert_close_of_largest(nhwc(got[k]), np.asarray(ref[k]), OUT_TOL, f"res2net {k}")
    assert tuple(got["res5"].shape) == (1, 2048, 2, 2)


def test_res2net50_keys_match_jax():
    feats = ("res3", "res4", "res5")
    Res2Net(50, feats).load_state_dict(from_jax_params(jax_shapes(jres2net.Res2Net(out_features=feats))),
                                       strict=True)


@pytest.mark.parametrize("kw", [dict(depth=6), dict(REGNET_Y_400MF, depth=6)], ids=["X", "Y"])
def test_regnet_matches_jax(kw):
    feats = ("s1", "s2", "s3", "s4")
    got, ref = run_both(jregnet.RegNet(out_features=feats, **kw), RegNet(out_features=feats, **kw), 13,
                        images(5, (1, 64, 64, 3)))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert_close_of_largest(nhwc(got[k]), np.asarray(ref[k]), OUT_TOL, f"regnet {k}")


@pytest.mark.parametrize("kw", [{}, REGNET_Y_400MF], ids=["X-400MF", "Y-400MF"])
def test_regnet_400mf_keys_match_jax(kw):
    """The full-depth trees load strictly: every grouped 3x3's width and
    group count (the group width capped at and rounded into the bottleneck
    width) and every SE width agree with the JAX package's."""
    full = {"w_a": 24.48, "w_0": 24, "w_m": 2.54, "depth": 22, "group_width": 16, **kw}
    design = (full["w_a"], full["w_0"], full["w_m"], full["depth"])
    ws, ds = generate_regnet_parameters(*design)
    assert (ws, ds) == jregnet.generate_regnet_parameters(*design)
    feats = ("s1", "s2", "s3", "s4")
    RegNet(out_features=feats, **kw).load_state_dict(
        from_jax_params(jax_shapes(jregnet.RegNet(out_features=feats, **kw))), strict=True)
    for w in ws:
        w_b, groups = block_widths(w, full["group_width"])
        assert w_b % groups == 0 and w_b // groups == min(full["group_width"], w)
