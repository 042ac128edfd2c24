"""Drift guard: the port's config copy equals the JAX package's config for
every preset the port names."""

import dataclasses

import pytest

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu_torch.config import PRESETS, get_config


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax_config(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))


def test_default_config_matches_jax():
    from faster_orefsdet_tpu.config import Config as JaxConfig
    from faster_orefsdet_tpu_torch.config import Config

    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())
