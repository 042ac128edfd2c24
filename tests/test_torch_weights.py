"""The weight bridge: the JAX package's published parameter tree carried into
the port's state_dict by utils.params.from_jax_params."""

import math

import jax
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector
from faster_orefsdet_tpu_torch.utils.params import from_jax_params, init_params
from test_torch_parity import make_torch_state_dict
import torch_budget  # noqa: F401 (the suite's torch thread budget)


@pytest.fixture(scope="module")
def jax_tree():
    params = convert_torch_checkpoint(make_torch_state_dict(seed=5))
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_strict_load_assigns_every_tensor(jax_tree):
    sd = from_jax_params(jax_tree)
    model = CenterNet2Detector(get_config("finetune_vovnet"))
    ref = model.state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert tuple(sd[k].shape) == tuple(ref[k].shape), k
        assert sd[k].dtype == torch.float32, k
    # every tensor of the port starts as NaN; the strict load must overwrite all
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.fill_(math.nan)
    model.load_state_dict(sd, strict=True)
    for k, t in model.state_dict().items():
        assert torch.isfinite(t).all(), f"{k} left at its init value"
    assert len(sd) == len(_flat(jax_tree))


def test_layout_transforms(jax_tree):
    sd = from_jax_params(jax_tree)
    k = jax_tree["backbone"]["stem1"]["conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["backbone.stem1.conv.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = jax_tree["roi"]["stage0_fc1"]["kernel"]  # [I, O], HWC-ordered rows
    np.testing.assert_array_equal(sd["roi.stage0_fc1.weight"].numpy(), d.T)
    np.testing.assert_array_equal(sd["backbone.stem1.norm.scale"].numpy(),
                                  jax_tree["backbone"]["stem1"]["norm"]["scale"])
    np.testing.assert_array_equal(sd["head.bbox_tower0_gn.scale"].numpy(),
                                  jax_tree["head"]["bbox_tower0_gn"]["scale"])


def test_init_params_loads_and_is_seeded():
    cfg = get_config("serving_vovnet")
    a, b = init_params(cfg, seed=1), init_params(cfg, seed=1)
    CenterNet2Detector(cfg).load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = init_params(cfg, seed=2)
    assert not torch.equal(a["cgm_conv3.weight"], c["cgm_conv3.weight"])
