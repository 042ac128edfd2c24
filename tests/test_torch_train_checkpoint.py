"""Checkpoints, parameter files and the train command line of the port, on
the CPU: a resumed run equals an uninterrupted one, the JAX package's
``model_final.npz`` loads into the port (and the port's into JAX), and
``python -m faster_orefsdet_tpu_torch.cli.train`` trains, checkpoints,
resumes, evaluates and starts from a JAX parameter file."""

import dataclasses
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from faster_orefsdet_tpu.utils.checkpoint import save_params_npz as jax_save_npz
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.cli import train as cli
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.data.synthetic import make_synthetic_setup
from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_state, build_train_step
from faster_orefsdet_tpu_torch.utils import checkpoint
from faster_orefsdet_tpu_torch.utils.params import from_jax_params, init_params
from test_torch_parity import make_torch_state_dict
from test_torch_train_step import make_inputs, port_batch, small
import torch_budget  # noqa: F401 (the suite's torch thread budget)


def test_resume_equals_uninterrupted(tmp_path):
    """2 steps, save, resume into a fresh state, 1 step == 3 steps, with
    dropout and ROI sampling on (the generator's state is restored)."""
    cfg = small(get_config("finetune_vovnet"))
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, warmup_iters=1, base_lr=0.01))
    params = init_params(cfg, seed=0)
    batches = [port_batch(make_inputs(seed=s)) for s in (1, 2, 3)]
    step = build_train_step(cfg)

    full = build_train_state(cfg, params, device="cpu")
    for b in batches:
        step(full, b)

    part = build_train_state(cfg, params, device="cpu")
    for b in batches[:2]:
        step(part, b)
    checkpoint.save_checkpoint(str(tmp_path), part)
    resumed = checkpoint.resume_or_load(str(tmp_path), build_train_state(cfg, params, device="cpu", seed=99))
    assert resumed.step == 2
    step(resumed, batches[2])
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())


def test_resume_restores_in_place(tmp_path):
    """A checkpoint restored into a state that has taken steps (as between
    the replays of a captured step): the weights, the momentum buffers and
    the generator keep their tensors and take the checkpoint's values; the
    next step equals the one taken after the save."""
    cfg = small(get_config("finetune_vovnet"))
    state = build_train_state(cfg, init_params(cfg, seed=0), device="cpu")
    step, batches = build_train_step(cfg), [port_batch(make_inputs(seed=s)) for s in (1, 2)]
    step(state, batches[0])
    checkpoint.save_checkpoint(str(tmp_path), state)
    after_save = {k: float(v) for k, v in step(state, batches[1]).items()}
    opt = state.optimizer
    held = [*state.model.state_dict().values(), *(opt.state[p]["momentum_buffer"] for g in opt.param_groups
                                                   for p in g["params"])]
    checkpoint.resume_or_load(str(tmp_path), state)
    now = [*state.model.state_dict().values(), *(opt.state[p]["momentum_buffer"] for g in opt.param_groups
                                                  for p in g["params"])]
    assert len(now) == len(held) and all(a.data_ptr() == b.data_ptr() for a, b in zip(held, now))
    assert state.step == 1
    assert {k: float(v) for k, v in step(state, batches[1]).items()} == after_save


def test_keeps_the_last_five(tmp_path):
    cfg = small(get_config("finetune_vovnet"))
    state = build_train_state(cfg, device="cpu")
    for s in range(1, 8):
        state.step = s
        checkpoint.save_checkpoint(str(tmp_path), state)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"step_{s:08d}.pt" for s in range(3, 8)]
    assert checkpoint.latest_step(str(tmp_path)) == 7
    fresh = build_train_state(cfg, device="cpu")
    assert checkpoint.resume_or_load(str(tmp_path / "none"), fresh) is fresh and fresh.step == 0


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    """A model_final.npz written by the JAX package, and its params tree (the
    published layout, from the checkpoint converter)."""
    params = convert_torch_checkpoint(make_torch_state_dict(seed=4))
    path = str(tmp_path_factory.mktemp("jax") / "model_final.npz")
    jax_save_npz(path, params)
    return path, params


def test_params_npz_crosses_both_ways(jax_npz, tmp_path):
    path, params = jax_npz
    sd = checkpoint.load_params_npz(path)
    ref = from_jax_params(jax.tree.map(np.asarray, params))
    assert sd.keys() == ref.keys()
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    mine = str(tmp_path / "port.npz")
    checkpoint.save_params_npz(mine, sd)
    back = jax_load_npz(mine, params)  # the JAX loader with its own template
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


TINY = [
    "fs.support_shot=2", "fs.support_crop_size=64", "roi.batch_size_per_image=32",
    "static.max_gt_per_image=8", "centernet.pre_nms_topk_train=200", "centernet.post_nms_topk_train=64",
    "input.min_size_train=(64,)", "input.max_size_train=128", "input.min_size_test=64",
    "input.max_size_test=128", "solver.checkpoint_period=1",
]


def test_train_cli(jax_npz, tmp_path, capsys):
    npz, _ = jax_npz
    root = tmp_path / "data"
    make_synthetic_setup(4, seed=0, crop_size=64, image_hw=(96, 128), blob_size=(20.0, 40.0), root=str(root),
                         writer=cv2.imwrite)
    out = tmp_path / "run"
    data = ["--train-json", str(root / "instances.json"), "--train-images", str(root / "images"),
            "--support-index", str(root / "support_index.json"), "--output-dir", str(out), "--device", "cpu"]
    cli.main(data + ["--max-iter", "2", "--init-npz", npz] + TINY)
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["iteration"] == 2 and rows[-1]["time_per_iter"] > 0
    assert all(np.isfinite(rows[-1][k]) for k in ("total_loss", "loss_centernet_loc", "loss_cls_stage0"))
    assert checkpoint.latest_step(str(out / "checkpoints")) == 2
    final = checkpoint.load_params_npz(str(out / "model_final.npz"))
    # trained from the JAX file: the frozen stem is the file's, the head moved
    start = checkpoint.load_params_npz(npz)
    assert torch.equal(final["backbone.stem1.conv.weight"], start["backbone.stem1.conv.weight"])
    assert not torch.equal(final["roi.stage0_cls.weight"], start["roi.stage0_cls.weight"])

    cli.main(data + ["--max-iter", "3", "--resume", "--eval-period", "3", "--test-json", str(root / "instances.json"),
                     "--test-images", str(root / "images"), "--eval-batch", "2"] + TINY)
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["iteration"] == 3 and np.isfinite(rows[-1]["eval/AP"])
    assert checkpoint.latest_step(str(out / "checkpoints")) == 3

    results = cli.main(["--eval-only", "--test-json", str(root / "instances.json"), "--test-images",
                        str(root / "images"), "--support-index", str(root / "support_index.json"), "--init-npz",
                        str(out / "model_final.npz"), "--device", "cpu", "--eval-batch", "1",
                        "--output-dir", str(out)] + TINY)
    assert np.isfinite(results["AP"]) and "training done" in capsys.readouterr().out
