"""K steps per call (pipelines/train_step.build_train_step_scan) on the CPU:
K steps equal K single build_train_step calls exactly, for both training
configurations; the train command line at --steps-per-dispatch K follows
the JAX package's chunk rules (evaluation and checkpoints at the first
chunk end that crosses their period, the tail chunk, one flush per logging
window and at the end); and --config-file configs/fsod/finetune_dla.yaml
trains and writes batch_stats.npz. On the card the K-step function replays
a CUDA graph of the step; chip_smoke.py holds that against eager steps."""

import dataclasses
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu_torch.cli import train as cli
from faster_orefsdet_tpu_torch.config import apply_overrides, get_config
from faster_orefsdet_tpu_torch.data.synthetic import make_synthetic_setup
from faster_orefsdet_tpu_torch.pipelines.train_step import (
    build_train_state, build_train_step, build_train_step_scan, run_scan_chunk,
)
from faster_orefsdet_tpu_torch.utils import checkpoint
from faster_orefsdet_tpu_torch.utils.params import init_params, is_batch_stat
from test_torch_train_checkpoint import TINY
from test_torch_train_step import make_inputs, port_batch, small
import torch_budget  # noqa: F401 (the suite's torch thread budget)

CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "fsod"


@pytest.mark.parametrize("name", ["finetune_vovnet", "finetune_dla"])
def test_k_steps_equal_single_steps(name):
    """3 steps in one call == 3 single steps from the same state, batches
    and generator, with dropout and ROI sampling on: every loss, weight,
    running statistic, momentum buffer and the generator's state."""
    cfg = small(get_config(name))
    if name == "finetune_dla":
        cfg = cfg.replace(fpn=dataclasses.replace(cfg.fpn, bifpn_repeats=1))
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, warmup_iters=2, base_lr=0.01))
    params = init_params(cfg, seed=0)
    batches = [port_batch(make_inputs(seed=s)) for s in (1, 2, 3)]

    single = build_train_state(cfg, params, device="cpu")
    step = build_train_step(cfg)
    ref = [step(single, b) for b in batches]

    chunked = build_train_state(cfg, params, device="cpu")
    got = run_scan_chunk(build_train_step_scan(cfg), chunked, iter(batches), 3)
    assert chunked.step == single.step == 3
    assert set(got) == set(ref[0]) and all(v.shape == (3,) for v in got.values())
    for k in got:
        assert torch.equal(got[k], torch.stack([r[k] for r in ref])), k
    sd_ref, sd_got = single.model.state_dict(), chunked.model.state_dict()
    assert sd_ref.keys() == sd_got.keys()
    assert all(torch.equal(sd_ref[k], sd_got[k]) for k in sd_ref)
    assert (name == "finetune_dla") == any(is_batch_stat(k) for k in sd_ref)
    bufs = [[s.optimizer.state[p]["momentum_buffer"] for g in s.optimizer.param_groups for p in g["params"]]
            for s in (single, chunked)]
    assert len(bufs[0]) > 0 and all(torch.equal(a, b) for a, b in zip(*bufs))
    assert torch.equal(single.generator.get_state(), chunked.generator.get_state())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_synthetic_setup(4, seed=0, crop_size=64, image_hw=(96, 128), blob_size=(20.0, 40.0), root=str(root),
                         writer=cv2.imwrite)
    return ["--train-json", str(root / "instances.json"), "--train-images", str(root / "images"),
            "--support-index", str(root / "support_index.json"), "--device", "cpu"]


def rows(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_cli_chunk_cadence(data, tmp_path):
    """25 steps at K = 4: chunks end at 4, 8, ..., 24 and the tail chunk of
    one step at 25. By the JAX package's rules: a row when 20 steps are
    pending (at 20) and at the end (25, holding 5 steps); checkpoints every
    10 at the first chunk end past each multiple (12, 20) and at the end;
    evaluation every 12 likewise (12, 24) and at the end, its scalars
    joining the next row without adding steps."""
    out = tmp_path / "run"
    test = ["--test-json", data[1], "--test-images", data[3]]
    cli.main(data + ["--output-dir", str(out), "--max-iter", "25", "--steps-per-dispatch", "4",
                     "--eval-period", "12", *test, "--eval-batch", "2"] + TINY + ["solver.checkpoint_period=10"])
    got = rows(out)
    assert [r["iteration"] for r in got] == [20, 25]
    assert all(np.isfinite(r["total_loss"]) and r["time_per_iter"] > 0 for r in got)
    assert "eval/AP" in got[0] and "eval/AP" in got[1]  # evals at 12 (row 20), 24 and 25 (row 25)
    ckpts = sorted(int(p.name[5:13]) for p in (out / "checkpoints").iterdir())
    assert ckpts == [12, 20, 25]
    state = checkpoint.resume_or_load(str(out / "checkpoints"),
                                      build_train_state(apply_overrides(get_config(), TINY), device="cpu"))
    assert state.step == 25


def test_cli_config_file_trains_dla(data, tmp_path, capsys):
    """--config-file finetune_dla.yaml at tiny sizes, 2 steps in one chunk:
    model_final.npz and batch_stats.npz written; the running statistics
    moved, and --init-npz reads both files back."""
    out = tmp_path / "dla"
    tiny = TINY + ["fpn.bifpn_repeats=1"]
    cli.main(data + ["--config-file", str(CONFIGS / "finetune_dla.yaml"), "--output-dir", str(out),
                     "--max-iter", "2", "--steps-per-dispatch", "2"] + tiny)
    assert (out / "model_final.npz").exists() and (out / "batch_stats.npz").exists()
    (row,) = rows(out)
    assert row["iteration"] == 2 and np.isfinite(row["total_loss"])
    sd = checkpoint.load_params_npz(str(out / "model_final.npz"), batch_stats=True)
    stats = {k: v for k, v in sd.items() if is_batch_stat(k)}
    assert len(stats) == 2 * 39 and all(torch.isfinite(v).all() for v in stats.values())
    assert not torch.equal(stats["backbone.base.bn.var"], torch.ones_like(stats["backbone.base.bn.var"]))
    ckpt = torch.load(str(out / "checkpoints" / "step_00000002.pt"), weights_only=True)
    assert all(torch.equal(ckpt["model"][k], v) for k, v in stats.items())

    results = cli.main(["--eval-only", "--config-file", str(CONFIGS / "finetune_dla.yaml"),
                        "--support-index", data[5], "--test-json", data[1], "--test-images", data[3],
                        "--init-npz", str(out / "model_final.npz"), "--device", "cpu", "--eval-batch", "1",
                        "--output-dir", str(out)] + tiny)
    assert np.isfinite(results["AP"]) and "training done" in capsys.readouterr().out
