"""Drift guard: the port names exactly the JAX package's presets, each
config equals the JAX package's field for field, and the port's BaselineConfig (the
AttentionRPN baseline's) equals the JAX package's, field for field."""

import dataclasses

import pytest

from faster_orefsdet_tpu.config import _NAMED_CONFIGS as JAX_NAMED_CONFIGS
from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu_torch.config import PRESETS, get_config


def test_presets_are_jax_presets():
    assert set(PRESETS) == set(JAX_NAMED_CONFIGS)


# over the JAX package's names, so that a preset the port lacks fails here
@pytest.mark.parametrize("name", sorted(JAX_NAMED_CONFIGS))
def test_preset_matches_jax_config(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))


@pytest.mark.parametrize("name,shot", [("finetune_vovnet_5shot", 5), ("finetune_vovnet_15shot", 15)])
def test_kshot_presets(name, shot):
    from faster_orefsdet_tpu_torch.config import finetune_vovnet_kshot

    cfg = get_config(name)
    assert cfg.fs.support_shot == shot
    assert dataclasses.asdict(cfg) == dataclasses.asdict(finetune_vovnet_kshot(shot))
    assert dataclasses.asdict(cfg.replace(fs=get_config("finetune_vovnet").fs)) == \
        dataclasses.asdict(get_config("finetune_vovnet"))


OVERRIDES = [
    ["fs.support_shot=5"],
    ["solver.base_lr=0.01", "solver.max_iter=20", "solver.steps=(10, 15)"],
    ["solver.clip_gradients=false", "input.random_flip=0", "solver.nesterov=True"],
    ["input.min_size_train=[64, 96]", "roi.cascade_ious=(0.5, 0.6)", "seed=3"],
    ["solver.weight_decay=0", "output_dir=/tmp/run", "vovnet.norm=FrozenBN"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=[" ".join(o) for o in OVERRIDES])
def test_apply_overrides_matches_jax(overrides):
    from faster_orefsdet_tpu.config import apply_overrides as jax_apply
    from faster_orefsdet_tpu_torch.config import apply_overrides

    got = dataclasses.asdict(apply_overrides(get_config("finetune_vovnet"), overrides))
    assert got == dataclasses.asdict(jax_apply(jax_get_config("finetune_vovnet"), overrides))


@pytest.mark.parametrize("bad,err", [("fs.no_such=1", KeyError), ("solver.nesterov=maybe", ValueError),
                                     ("input.random_flip=2", ValueError)])
def test_apply_overrides_refuses_like_jax(bad, err):
    from faster_orefsdet_tpu.config import apply_overrides as jax_apply
    from faster_orefsdet_tpu_torch.config import apply_overrides

    with pytest.raises(err):
        apply_overrides(get_config(), [bad])
    with pytest.raises(err):
        jax_apply(jax_get_config(), [bad])


def test_default_config_matches_jax():
    from faster_orefsdet_tpu.config import Config as JaxConfig
    from faster_orefsdet_tpu_torch.config import Config

    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())


def test_baseline_config_matches_jax():
    from faster_orefsdet_tpu.pipelines.attention_rpn import BaselineConfig as JaxBaselineConfig
    from faster_orefsdet_tpu_torch.pipelines.attention_rpn import BaselineConfig

    fields = [(f.name, f.type) for f in dataclasses.fields(BaselineConfig)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(JaxBaselineConfig)]
    assert dataclasses.asdict(BaselineConfig()) == dataclasses.asdict(JaxBaselineConfig())
    over = dict(rpn_pre_nms_topk_test=128, test_nms_thresh=0.3, support_shot=2)
    assert dataclasses.asdict(BaselineConfig(**over)) == dataclasses.asdict(JaxBaselineConfig(**over))
