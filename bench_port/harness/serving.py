"""What the raw-frame serving kinds (``kinds/closed_batches.py``,
``kinds/camera_stream.py``) share: set-up of the program under test, one
request, and the check of what a window served against the reference.

The program is ``faster_orefsdet_tpu_torch``'s pinned raw-frame serving
function (``pipelines.inference.build_pinned_serving_fn``) over a support
cache built by ``pipelines.support_cache.build_support_cache``. It is given
the seed's weights, shots and frames, nothing else; every request hands it
uint8 frames in pinned host memory and reads its packed detections back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from . import compare, frames as F, weights
from .interface import Checked, Window

REF_BLOCK = 8  # frames the reference takes at once
WARMUP_CALLS = 3  # after the first, which captures the graph


def program_config(config: dict):
    """The program's Config as the configuration's file states it, checked
    against the file's `model` (so the reference and the program run one
    configuration)."""
    from faster_orefsdet_tpu_torch.config import apply_overrides, get_config

    cfg = apply_overrides(get_config(config["serve"]["preset"]), config["serve"].get("overrides", []))
    as_json = json_normal(dataclasses.asdict(cfg))
    if as_json != config["model"]:
        diff = sorted(k for k in as_json if as_json[k] != config["model"].get(k))
        raise ValueError(f"the program's {config['serve']['preset']} differs from the file's model at {diff}")
    return cfg


def json_normal(x):
    if isinstance(x, dict):
        return {k: json_normal(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_normal(v) for v in x]
    return x


class Served:
    """One configuration's program, its inputs and its weights, from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, overrides=()):
        from faster_orefsdet_tpu_torch.config import apply_overrides
        from faster_orefsdet_tpu_torch.pipelines.inference import build_pinned_serving_fn
        from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache

        from ..reference import model as M

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        cfg = apply_overrides(program_config(config), list(overrides))
        self.model = config["model"]
        self.hw = tuple(traffic["frame_hw"])
        with torch.device("meta"):
            template = M.Detector(self.model).state_dict()
        self.state = weights.seeded_state_dict(template, seed, self.model["centernet"]["prior_prob"], self.device)
        serve = config["serve"]
        inp = self.model["input"]
        self.shots, self.shot_boxes = F.support_shots(seed, serve["shots"], serve["shot_crop"], serve["shot_canvas"],
                                                      inp["pixel_mean"], inp["pixel_std"], self.device)
        pool = F.belt_frames(seed, traffic["pool"], self.hw, tuple(traffic["blobs"]), self.device)
        self.pool = pool.cpu().pin_memory() if self.device.type == "cuda" else pool
        cache = build_support_cache(cfg, self.state, self.shots, self.shot_boxes, device=self.device)
        self.fn, _ = build_pinned_serving_fn(cfg, self.state, cache, self.hw, device=self.device)

    def request(self, frames: torch.Tensor) -> np.ndarray:
        from faster_orefsdet_tpu_torch.pipelines.inference import pack_detections

        with record_function("bench.call"):
            det = self.fn(frames)
        with record_function("bench.readback"):
            return pack_detections(det).cpu().numpy()


def setup(cell, seed: int, device, overrides=()) -> Served:
    return Served(cell.config, cell.traffic, seed, device, overrides)


def warm_up(served: Served, frames: torch.Tensor) -> None:
    """Capture and replay the one input shape of `frames`."""
    for _ in range(1 + WARMUP_CALLS):
        served.request(frames)


def free(served: Served) -> None:
    """Drop the program's state (graphs, cache, weights on the card)."""
    served.fn = None
    if served.device.type == "cuda":
        torch.cuda.synchronize(served.device)
        torch.cuda.empty_cache()


def reference(cell, served: Served, device):
    """The float32 reference of the cell's configuration with the seed's
    weights and shots, TF32 off."""
    from ..reference.serving import Reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return Reference(cell.config["model"], served.state, served.shots, served.shot_boxes, device)


def answers_of(ref, pool: torch.Tensor, device, block: int = REF_BLOCK
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`ref` over the whole pool in blocks of `block` frames: (boxes, scores,
    valid) per frame, numpy. The reference records each block's work."""
    boxes, scores, valid = [], [], []
    for i in range(0, pool.shape[0], block):
        b, s, v = ref(pool[i:i + block].to(device))
        boxes.append(b.float().cpu().numpy())
        scores.append(s.float().cpu().numpy())
        valid.append(v.cpu().numpy())
    return np.concatenate(boxes), np.concatenate(scores), np.concatenate(valid)


def shares(got: Iterable[Tuple[int, np.ndarray, np.ndarray, np.ndarray]], want) -> List[float]:
    """Each frame's unmatched share: `got` yields (pool frame, boxes, scores,
    valid); `want` is the reference's (boxes, scores, valid) per pool frame."""
    rb, rs, rv = want
    return [compare.unmatched_share(b, s, v, rb[f], rs[f], rv[f]) for f, b, s, v in got]


def sample(win: Window, rng: np.random.Generator) -> Dict[int, np.ndarray]:
    """One served answer for each input the window served, its occurrence
    drawn from the seed: {key: packed [B, D, 7]}."""
    by_key: Dict[int, List[int]] = {}
    for i, r in enumerate(win.requests):
        by_key.setdefault(r.key, []).append(i)
    return {k: win.outputs[idx[int(rng.integers(len(idx)))]] for k, idx in sorted(by_key.items())}


def check(cell, served: Served, win: Window, rng: np.random.Generator, device) -> Checked:
    """A seeded sample of the window's answers, one for each input served,
    against the reference over the same frames."""
    picked = sample(win, rng)
    ref = reference(cell, served, device)
    per = cell.traffic.get("batch", 1)
    want = answers_of(ref, served.pool, device, per if per > 1 else REF_BLOCK)
    got = ((key * per + i, p[i, :, :4], p[i, :, 4], p[i, :, 6] > 0.5)
           for key, p in picked.items() for i in range(p.shape[0]))
    return Checked(compare.numbers(shares(got, want)), ref)


def reference_control(cell, seed: int, device, dtype) -> Dict[str, float]:
    """The reference under autocast to `dtype` in the program's place, every
    pool frame, against the float32 reference."""
    from ..reference.serving import Reference

    served = setup(cell, seed, device)
    free(served)
    want = answers_of(reference(cell, served, device), served.pool, device)
    with torch.autocast(torch.device(device).type, dtype=dtype):
        ctl = Reference(cell.config["model"], served.state, served.shots, served.shot_boxes, device)
        got = answers_of(ctl, served.pool, device)
    return compare.numbers(shares(((f, got[0][f], got[1][f], got[2][f]) for f in range(len(got[0]))), want))


def model_flops(cell, served: Served, ref, device) -> Tuple[float, float]:
    """(the reference's model FLOPs per image at the cell's shapes, the dense
    peak of the configuration's stated precision)."""
    from ..counts import flops, peaks

    block = served.pool[:cell.traffic.get("batch", REF_BLOCK)].to(device)
    return flops.per_image(ref, block), peaks.BY_PRECISION[cell.config["precision"]]
