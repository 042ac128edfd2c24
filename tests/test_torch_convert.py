"""The port's converter of the reference's checkpoints against the JAX
package's: the same tensors as ``from_jax_params`` of the JAX converter's
output, key for key and bit for bit (``torch.equal``)."""

import math

import jax
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.utils import torch_convert as jconvert
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector
from faster_orefsdet_tpu_torch.utils import torch_convert
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_dla_converter import build_state_dict as build_dla_state_dict
from test_torch_parity import make_torch_state_dict
import torch_budget  # noqa: F401 (the suite's torch thread budget)


def _np_tree(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


def _assert_same(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("seed,wrapped", [(0, False), (5, False), (0, True)])
def test_convert_torch_checkpoint_matches_jax(seed, wrapped):
    sd = make_torch_state_dict(seed)
    ckpt = {"model": sd, "iteration": 7} if wrapped else sd
    ref = from_jax_params(_np_tree(jconvert.convert_torch_checkpoint(ckpt)))
    _assert_same(torch_convert.convert_torch_checkpoint(ckpt), ref)


def test_load_torch_pth_round_trip(tmp_path):
    sd = make_torch_state_dict(3)
    path = tmp_path / "model_final.pth"
    torch.save({"model": sd}, path)
    loaded = torch_convert.load_torch_pth(str(path))
    assert loaded["model"].keys() == sd.keys() and all(torch.equal(loaded["model"][k], sd[k]) for k in sd)
    _assert_same(torch_convert.convert_torch_checkpoint(loaded), torch_convert.convert_torch_checkpoint(sd))


@pytest.mark.parametrize("norm", ["BN", "FrozenBN"])
def test_convert_dla_bifpn_matches_jax(norm):
    sd = build_dla_state_dict()
    params, stats = jconvert.convert_dla_bifpn_backbone(sd, norm=norm, bifpn_repeats=2)
    assert (stats is None) == (norm == "FrozenBN")
    ref = from_jax_params(_np_tree(params), _np_tree(stats))
    got = torch_convert.convert_dla_bifpn_backbone(sd, norm=norm, bifpn_repeats=2)
    _assert_same(got, ref)
    # torch tensors in, as torch.load gives them: the same result
    _assert_same(torch_convert.convert_dla_bifpn_backbone({k: torch.from_numpy(v) for k, v in sd.items()},
                                                          norm=norm, bifpn_repeats=2), ref)


def test_strict_load_assigns_every_tensor():
    sd = torch_convert.convert_torch_checkpoint(make_torch_state_dict(5))
    model = CenterNet2Detector(get_config("finetune_vovnet"))
    assert sd.keys() == model.state_dict().keys()
    # every tensor of the port starts as NaN; the strict load must overwrite all
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.fill_(math.nan)
    model.load_state_dict(sd, strict=True)
    for k, t in model.state_dict().items():
        assert torch.isfinite(t).all(), f"{k} left at its init value"


def test_dla_backbone_loads_into_the_detector():
    """The converted DLA-34 + BiFPN entries are every backbone and BiFPN
    tensor of a finetune_dla detector (2 BiFPN repeats, as the test dict)."""
    cfg = get_config("finetune_dla")
    cfg = cfg.replace(fpn=cfg.fpn.__class__(**{**cfg.fpn.__dict__, "bifpn_repeats": 2}))
    model = CenterNet2Detector(cfg)
    own = {k for k in model.state_dict() if k.startswith(("backbone.", "fpn."))}
    got = torch_convert.convert_dla_bifpn_backbone(build_dla_state_dict(), bifpn_repeats=2)
    assert got.keys() == own
    full = model.state_dict()
    full.update(got)
    model.load_state_dict(full, strict=True)
