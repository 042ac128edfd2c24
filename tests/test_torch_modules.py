"""Module-level parity of the port against the JAX package's
CenterNet2Detector methods, with the same weights (from_jax_params) and the
same seeded inputs, in f32 on the CPU. NCHW <-> NHWC permutes happen here.
rtol = atol = 1e-4: the deep conv chain sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.models.detector import support_kernels as jax_support_kernels
from faster_orefsdet_tpu.ops.roi_align import multilevel_roi_align as jax_mlra
from faster_orefsdet_tpu.pipelines.inference import make_detector as jax_make_detector
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models.detector import support_kernels
from faster_orefsdet_tpu_torch.ops.roi_align import assign_levels, multilevel_roi_align
from faster_orefsdet_tpu_torch.pipelines.inference import make_detector
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_torch_parity import make_torch_state_dict
import torch_budget  # noqa: F401 (the suite's torch thread budget)

TOL = dict(rtol=1e-4, atol=1e-4)
LEVELS = ("p3", "p4", "p5")


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("finetune_vovnet")
    params = convert_torch_checkpoint(make_torch_state_dict(seed=2))
    jmodel = jax_make_detector(jcfg)
    port = make_detector(get_config("finetune_vovnet"), from_jax_params(jax.tree.map(np.asarray, params)),
                         device="cpu")
    return jmodel, {"params": params}, port


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_features(pair):
    jmodel, v, port = pair
    x = np.random.default_rng(0).standard_normal((2, 64, 96, 3)).astype(np.float32)
    ref = jmodel.apply(v, jnp.asarray(x), method=jmodel.features)
    with torch.no_grad():
        got = port.features(_nchw(x))
    for level in LEVELS:
        np.testing.assert_allclose(_nhwc(got[level]), np.asarray(ref[level]), **TOL, err_msg=level)


def test_refine_support_and_kernels(pair):
    jmodel, v, port = pair
    g = np.random.default_rng(1)
    # p3 maps smaller than the 32x32 pool exercise the upsampling bins
    sup = {lvl: g.standard_normal((2, h, h + 2, 128)).astype(np.float32)
           for lvl, h in (("p3", 30), ("p4", 16), ("p5", 9))}
    ref = jmodel.apply(v, {k: jnp.asarray(a) for k, a in sup.items()}, method=jmodel.refine_support)
    with torch.no_grad():
        got = port.refine_support({k: _nchw(a) for k, a in sup.items()})
    for level in LEVELS:
        np.testing.assert_allclose(got[level].numpy(), np.asarray(ref[level]), **TOL, err_msg=level)
        mean_map = np.asarray(ref[level]).mean(0)
        for a, b in zip(support_kernels(torch.from_numpy(mean_map)), jax_support_kernels(jnp.asarray(mean_map))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_proposal_head(pair):
    jmodel, v, port = pair
    g = np.random.default_rng(2)
    feats = {lvl: g.standard_normal((2, 16 // s, 24 // s, 128)).astype(np.float32)
             for lvl, s in zip(LEVELS, (1, 2, 4))}
    hms, regs = jmodel.apply(v, {k: jnp.asarray(a) for k, a in feats.items()}, method=jmodel.proposal_head)
    with torch.no_grad():
        t_hms, t_regs = port.proposal_head({k: _nchw(a) for k, a in feats.items()})
    for i in range(3):
        np.testing.assert_allclose(_nhwc(t_hms[i]), np.asarray(hms[i]), **TOL)
        np.testing.assert_allclose(_nhwc(t_regs[i]), np.asarray(regs[i]), **TOL)


def _roi_inputs(seed):
    g = np.random.default_rng(seed)
    feats = [g.standard_normal((24 // s, 32 // s, 128)).astype(np.float32) for s in (1, 2, 4)]
    boxes = np.asarray([
        [8.0, 8.0, 120.0, 100.0], [30.0, 20.0, 90.0, 80.0], [2.0, 3.0, 9.0, 7.5],
        [-10.0, -5.0, 250.0, 200.0], [60.5, 10.25, 61.0, 150.0],
        [0.0, 0.0, 600.0, 10.0],  # routed to p3 with 10 samples per bin: capped at S_MAX=8
        [0.0, 0.0, 500.0, 460.0],  # routed to p5
    ], np.float32)
    return feats, boxes


@pytest.mark.parametrize("size", [8, 4])
def test_multilevel_roi_align(size):
    feats, boxes = _roi_inputs(3)
    ref = np.asarray(jax_mlra([jnp.asarray(f) for f in feats], jnp.asarray(boxes), [8, 16, 32], size, 0))
    got = multilevel_roi_align([_nchw(f[None]) for f in feats], torch.from_numpy(boxes)[None],
                               [8, 16, 32], size, 0)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # every level gets at least one box, so the routing is exercised
    assert set(assign_levels(torch.from_numpy(boxes), 3, 5).tolist()) == {3, 4, 5}


def test_roi_stage(pair):
    jmodel, v, port = pair
    feats, boxes = _roi_inputs(4)
    g = np.random.default_rng(5)
    s8 = g.standard_normal((8, 8, 128)).astype(np.float32)
    s4 = g.standard_normal((4, 4, 128)).astype(np.float32)
    ref = jmodel.apply(v, [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(s8),
                       jnp.asarray(s4), 0, method=jmodel.roi_stage)
    with torch.no_grad():
        got = port.roi_stage([_nchw(f[None]) for f in feats], torch.from_numpy(boxes)[None],
                             torch.from_numpy(s8), torch.from_numpy(s4), 0)
    np.testing.assert_allclose(got.scores[0].numpy(), np.asarray(ref.scores), **TOL)
    np.testing.assert_allclose(got.deltas[0].numpy(), np.asarray(ref.deltas), **TOL)
