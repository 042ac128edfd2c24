"""The port's EventLogger against the JAX package's, on the CPU: the same
metrics.jsonl rows for the same scalars (time_per_iter aside, a wall
time); with tensorboard=True both write an event file under tb/ with every
scalar but the iteration; where tensorboard cannot be imported both print
the same message and keep metrics.jsonl only. torch.utils.tensorboard
pulls in TensorFlow here, so the module imports it once."""

import json
import os
import sys

import pytest

from faster_orefsdet_tpu.utils.events import EventLogger as JaxEventLogger
from faster_orefsdet_tpu_torch.utils.events import EventLogger

import torch_budget  # noqa: F401 (the suite's torch thread budget)

STEPS = [(1, {"loss_cls": 0.5, "total_loss": 1.5}, 1), (2, {"loss_cls": 0.25, "total_loss": 1.0}, 4),
         (3, {"ap": 12.5}, 0)]


def _log(logger):
    for step, scalars, count in STEPS:
        logger.log(step, scalars, count)
    logger.flush(3)
    logger.log(4, {"loss_cls": 0.125, "total_loss": 0.75}, 2)
    logger.flush(4)


def _rows(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time_per_iter"} for line in f]


def _tb_scalars(tb_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(tb_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


@pytest.fixture(scope="module")
def tensorboard():
    import torch.utils.tensorboard

    return torch.utils.tensorboard


@pytest.mark.parametrize("tb", [False, True], ids=["jsonl", "tensorboard"])
def test_event_logger_matches_jax(tmp_path, tb, tensorboard):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jlog = JaxEventLogger(jdir, tensorboard=tb, printer=lambda *a: None)
    _log(jlog)
    _log(EventLogger(tdir, tensorboard=tb))  # the port's flush() also flushes the event file
    if tb:
        jlog._tb.flush()  # the JAX logger leaves that to the writer's 120 s timer
    assert _rows(os.path.join(tdir, "metrics.jsonl")) == _rows(os.path.join(jdir, "metrics.jsonl"))
    assert os.path.isdir(os.path.join(tdir, "tb")) == tb
    if tb:
        got, ref = _tb_scalars(os.path.join(tdir, "tb")), _tb_scalars(os.path.join(jdir, "tb"))
        assert sorted(got) == sorted(ref) == ["ap", "loss_cls", "time_per_iter", "total_loss"]
        for tag in ("ap", "loss_cls", "total_loss"):
            assert got[tag] == pytest.approx(ref[tag]), tag
        assert [s for s, _ in got["loss_cls"]] == [3, 4]


def test_event_logger_falls_back_to_jsonl(tmp_path, monkeypatch, capsys, tensorboard):
    """With the import made to fail, both print the JAX package's message
    and write metrics.jsonl only."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    said = []
    JaxEventLogger(str(tmp_path / "jax"), tensorboard=True, printer=said.append)
    logger = EventLogger(str(tmp_path / "port"), tensorboard=True)
    out = capsys.readouterr().out.strip()
    assert out == said[0] and out.startswith("tensorboard unavailable (") and out.endswith("); jsonl only")
    _log(logger)
    assert sorted(os.listdir(tmp_path / "port")) == ["metrics.jsonl"]
    assert len(_rows(tmp_path / "port" / "metrics.jsonl")) == 2
