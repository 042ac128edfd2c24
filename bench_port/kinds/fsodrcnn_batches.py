"""Traffic kind `fsodrcnn_batches`: the closed loop of ``closed_batches``
(one client; each request `batch` distinct frames of a seeded pool of `pool`
belt frames of `hw`, with `blobs` ore blobs each; the next request sent when
the last one's detections are on the host; the first `trace_requests`
traced) in front of the AttentionRPN baseline, FsodRCNN over ResNet-50 C4.

The program is ``faster_orefsdet_tpu_torch``'s pinned raw-frame function
``pipelines.attention_rpn.build_pinned_baseline_serving_fn`` over a one-class
cache from ``build_baseline_cache``, configured from the configuration's
yaml (``config_yaml.load_yaml``) with its `overrides`, and served at the
yaml's test size, in float32 with TF32 off (the configuration's `precision`
and `precision_note`). It is given the seed's weights (``fsod_weights``), shots
and frames, nothing else. The plain reference is ``reference/fsod_rcnn.py``.

End to end: `images_per_s`, every frame completed in the window over the
window's time. Facts for the readers: the requests, K2's least time per
traced request (the yardstick's count on the reference's record of the same
frames: the proposals' NMS and the detections'), the model's FLOPs per
image (``counts/fsod_flops.py``) and the float32 peak outside the tensor
cores.
"""

import dataclasses
import statistics
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from bench_port.harness import compare, frames as F, serving
from bench_port.harness.fsod_weights import seeded_state_dict
from bench_port.harness.interface import Checked, Report
from bench_port.kinds import closed_batches
from faster_orefsdet_tpu_torch.pipelines.attention_rpn import (
    build_baseline_cache, build_pinned_baseline_serving_fn,
)

ROOT = Path(__file__).resolve().parents[2]

window, warm_up, free = closed_batches.window, closed_batches.warm_up, serving.free


def program_config(config: dict):
    """(BaselineConfig, InputConfig) as the port builds them from the
    configuration's yaml and `overrides`, checked against the file's `model`
    and `input` (so the reference and the program run one configuration)."""
    from faster_orefsdet_tpu_torch import config_yaml
    from faster_orefsdet_tpu_torch.config import InputConfig

    serve = config["serve"]
    path = str(ROOT / serve["yaml"])
    cfg = dataclasses.replace(config_yaml.load_yaml(path), **serve["overrides"])
    test = config_yaml.load_merged_yaml(path)["INPUT"]
    icfg = InputConfig(min_size_test=int(test["MIN_SIZE_TEST"]), max_size_test=int(test["MAX_SIZE_TEST"]))
    for what, have, want in (("model", cfg, config["model"]), ("input", icfg, config["input"])):
        as_json = serving.json_normal(dataclasses.asdict(have))
        if as_json != want:
            diff = sorted(k for k in as_json if as_json[k] != want.get(k))
            raise ValueError(f"the program's {what} from {serve['yaml']} differs from the file's at {diff}")
    return cfg, icfg


class Served:
    """The baseline's program, its inputs and its weights, from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from faster_orefsdet_tpu_torch.models.attention_rpn import FsodRCNN

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        cfg, icfg = program_config(config)
        # float32 convolutions, TF32 off (matrix products are float32 by PyTorch's default);
        # the graph captures the kernels chosen under it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.hw = tuple(traffic["frame_hw"])
        with torch.device("meta"):
            template = FsodRCNN(depth=cfg.depth).state_dict()
        self.state = seeded_state_dict(template, seed, self.device)
        serve, inp = config["serve"], config["input"]
        self.shots, self.shot_boxes = F.support_shots(seed, serve["shots"], serve["shot_crop"], serve["shot_canvas"],
                                                      inp["pixel_mean"], inp["pixel_std"], self.device)
        pool = F.belt_frames(seed, traffic["pool"], self.hw, tuple(traffic["blobs"]), self.device)
        self.pool = pool.cpu().pin_memory() if self.device.type == "cuda" else pool
        cache = build_baseline_cache(cfg, self.state, self.shots, self.shot_boxes, device=self.device)
        self.fn, self.canvas_hw = build_pinned_baseline_serving_fn(cfg, self.state, cache, self.hw, icfg,
                                                                   device=self.device)

    request = serving.Served.request  # frames in, packed detections on the host, under the harness's ranges


def setup(cell, seed: int, device, overrides=()) -> Served:
    if overrides:
        raise ValueError("fsodrcnn_batches takes no program overrides: its control is the reference")
    return Served(cell.config, cell.traffic, seed, device)


def reference(cell, served: Served, device):
    """The float32 reference with the seed's weights and shots, TF32 off."""
    from bench_port.reference.fsod_rcnn import Reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return Reference(cell.config, served.state, served.shots, served.shot_boxes, device)


def check(cell, served: Served, win, rng: np.random.Generator, device) -> Checked:
    """A seeded sample of the window's answers, one for each input served,
    against the reference over the same frames, one request's batch a block."""
    picked = serving.sample(win, rng)
    ref = reference(cell, served, device)
    per = cell.traffic["batch"]
    want = serving.answers_of(ref, served.pool, device, per)
    got = ((key * per + i, p[i, :, :4], p[i, :, 4], p[i, :, 6] > 0.5)
           for key, p in picked.items() for i in range(p.shape[0]))
    return Checked(compare.numbers(serving.shares(got, want)), ref)


def reference_control(cell, seed: int, device, dtype) -> Dict[str, float]:
    """The reference under autocast to `dtype` in the program's place, every
    pool frame, against the float32 reference."""
    from bench_port.reference.fsod_rcnn import Reference

    served = setup(cell, seed, device)
    free(served)
    per = cell.traffic["batch"]
    want = serving.answers_of(reference(cell, served, device), served.pool, device, per)
    with torch.autocast(torch.device(device).type, dtype=dtype):
        ctl = Reference(cell.config, served.state, served.shots, served.shot_boxes, device)
        got = serving.answers_of(ctl, served.pool, device, per)
    return compare.numbers(serving.shares(((f, got[0][f], got[1][f], got[2][f]) for f in range(len(got[0]))), want))


def report(cell, served: Served, win, checked, trace) -> Report:
    images = sum(r.images for r in win.requests)
    facts = {"requests": win.requests}
    if trace is not None:
        from bench_port.counts import fsod_flops, k2, peaks

        record = checked.reference.record
        per_block = [k2.call_seconds(*rpn) + k2.call_seconds(*final)
                     for rpn, final in zip(record["k2_rpn"], record["k2_final"])]
        facts["k2_s"] = float(np.mean([per_block[r.key] for r in win.requests if r.traced]))
        block = served.pool[:cell.traffic["batch"]].to(served.device)
        facts["flops_per_image"] = fsod_flops.per_image(checked.reference, block)
        facts["peak_flops"] = peaks.F32_FLOPS  # float32 with TF32 off runs outside the tensor cores
    info = {"requests": len(win.requests), "images": images, "canvas": list(served.canvas_hw),
            "request_ms_median": statistics.median((r.done - r.send) * 1e3 for r in win.requests)}
    info.update({k: facts[k] for k in ("k2_s", "flops_per_image") if k in facts})
    return Report({"images_per_s": images / win.seconds}, images, 0, facts, info)
