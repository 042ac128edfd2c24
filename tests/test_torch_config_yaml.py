"""The port's yaml configs against the JAX package's, on every file of
configs/fsod: the port's own YAML reader equals yaml.safe_load, each
CenterNet2Detector yaml resolves to the JAX package's Config (as dataclass
dicts), the dead configurations raise DeadReferenceConfigError in both,
`load_yaml` reads the AttentionRPN baseline's yaml as the JAX package's
BaselineConfig (and `load_yaml_config` refuses it, as the JAX package's
does), and an unknown key is an error."""

import dataclasses
from pathlib import Path

import pytest
import yaml

from faster_orefsdet_tpu import config_yaml as jax_config_yaml
from faster_orefsdet_tpu_torch import config_yaml
from faster_orefsdet_tpu_torch.config import get_config

import torch_budget  # noqa: F401 (the suite's torch thread budget)

CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "fsod"
FILES = sorted(p.name for p in CONFIGS.glob("*.yaml"))
LIVE = ["finetune_vovnet.yaml", "finetune_dla.yaml", "finetune_R_50_C4_1x.yaml"]
DEAD = ["finetune_dla2.yaml", "finetune_R_50_F.yaml"]


def test_every_file_is_covered():
    assert set(FILES) == set(LIVE) | set(DEAD) | {"Base-FSOD-C4.yaml"}


@pytest.mark.parametrize("name", FILES)
def test_reader_equals_safe_load(name):
    text = (CONFIGS / name).read_text()
    assert config_yaml.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  c: [1, 'x', \"y\"]  # note\n  d: -3\n  e: 1e5\n  f: .5\n  g: ~\nh:\n",
    "x: 'it''s'\ny: \"a\\\"b #c\"\nz: yes\nw: [[0, 64], [48, 1000000]]\nv: 1_000\nu: (1, 2)\nt: 0.00001\ns: 1.\n",
    "# top\n\nA:\n  B:\n    C: True\n  D: off\nE: [\"p3\", 'p4']\n",
], ids=["scalars", "quoting", "nesting"])
def test_reader_equals_safe_load_on_the_subset(text):
    assert config_yaml.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: {b: 1}\n", "a: &x 1\n", "a:\n\tb: 1\n", "a: 1\na: 2\n"],
                         ids=["block_list", "flow_map", "anchor", "tab", "duplicate"])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        config_yaml.safe_load(text)


@pytest.mark.parametrize("name", LIVE)
def test_yaml_resolves_like_jax(name):
    got = config_yaml.load_yaml_config(str(CONFIGS / name))
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config_yaml.load_yaml_config(str(CONFIGS / name)))


@pytest.mark.parametrize("name,preset", [("finetune_vovnet.yaml", "finetune_vovnet"),
                                         ("finetune_dla.yaml", "finetune_dla"),
                                         ("finetune_R_50_C4_1x.yaml", "finetune_R_50_C4_1x")])
def test_yaml_equals_its_preset(name, preset):
    got = config_yaml.load_yaml_config(str(CONFIGS / name))
    # the yamls leave the dataset names and output dirs as the presets do
    assert dataclasses.asdict(got) == dataclasses.asdict(get_config(preset))


@pytest.mark.parametrize("name", DEAD)
def test_dead_configs_refused_like_jax(name):
    with pytest.raises(config_yaml.DeadReferenceConfigError):
        config_yaml.load_yaml_config(str(CONFIGS / name))
    with pytest.raises(jax_config_yaml.DeadReferenceConfigError):
        jax_config_yaml.load_yaml_config(str(CONFIGS / name))


def test_baseline_is_not_ported():
    """load_yaml_config takes CenterNet2Detector yamls only: the baseline's
    is refused there in both packages (load_yaml reads it, below)."""
    with pytest.raises(ValueError, match="not a CenterNet2Detector yaml"):
        config_yaml.load_yaml_config(str(CONFIGS / "Base-FSOD-C4.yaml"))
    with pytest.raises(ValueError, match="not a CenterNet2Detector yaml"):
        jax_config_yaml.load_yaml_config(str(CONFIGS / "Base-FSOD-C4.yaml"))


def test_load_yaml_reads_the_baseline_like_jax():
    from faster_orefsdet_tpu_torch.pipelines.attention_rpn import BaselineConfig

    got = config_yaml.load_yaml(str(CONFIGS / "Base-FSOD-C4.yaml"))
    assert isinstance(got, BaselineConfig)
    ref = jax_config_yaml.load_yaml(str(CONFIGS / "Base-FSOD-C4.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.rpn_pre_nms_topk_test, got.roi_batch_size, got.support_shot) == (1000, 128, 10)


@pytest.mark.parametrize("name,preset", [("finetune_R_50_C4_1x.yaml", "finetune_R_50_C4_1x"),
                                         ("finetune_vovnet.yaml", "finetune_vovnet")])
def test_load_yaml_gives_the_named_config(name, preset):
    got = config_yaml.load_yaml(str(CONFIGS / name))
    assert dataclasses.asdict(got) == dataclasses.asdict(get_config(preset))
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config_yaml.load_yaml(str(CONFIGS / name)))


def test_unknown_baseline_key_is_an_error(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text((CONFIGS / "Base-FSOD-C4.yaml").read_text() + "TEST:\n  NOPE: 1\n")
    with pytest.raises(KeyError, match="TEST.NOPE"):
        config_yaml.load_yaml(str(bad))
    with pytest.raises(KeyError, match="TEST.NOPE"):
        jax_config_yaml.load_yaml(str(bad))


def test_unknown_key_is_an_error(tmp_path):
    (tmp_path / "Base-FSOD-C4.yaml").write_text((CONFIGS / "Base-FSOD-C4.yaml").read_text())
    bad = tmp_path / "bad.yaml"
    bad.write_text((CONFIGS / "finetune_dla.yaml").read_text() + "SOLVER2:\n  NOPE: 1\n")
    with pytest.raises(KeyError, match="SOLVER2.NOPE"):
        config_yaml.load_yaml_config(str(bad))
    with pytest.raises(KeyError, match="SOLVER2.NOPE"):
        jax_config_yaml.load_yaml_config(str(bad))


def test_child_keys_win_over_base(tmp_path):
    (tmp_path / "base.yaml").write_text("SOLVER:\n  BASE_LR: 0.5\n  MAX_ITER: 7\nSEED: 3\n")
    (tmp_path / "child.yaml").write_text('_BASE_: "base.yaml"\nSOLVER:\n  MAX_ITER: 9\n')
    cfg = config_yaml.load_yaml_config(str(tmp_path / "child.yaml"))
    assert (cfg.solver.base_lr, cfg.solver.max_iter, cfg.seed) == (0.5, 9, 3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config_yaml.load_yaml_config(str(tmp_path / "child.yaml")))
