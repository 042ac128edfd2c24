"""Traffic kind `onestage_batches`: the closed loop of ``closed_batches``
(one client; each request `batch` distinct frames of a seeded pool of `pool`
belt frames of `hw`, with `blobs` ore blobs each; the next request sent when
the last one's detections are on the host; the first `trace_requests`
traced) in front of a one-stage CenterNet, CenterNet-S4 over DLA-34-DCN.

The program is ``faster_orefsdet_tpu_torch``'s pinned raw-frame function
``pipelines.onestage.build_pinned_onestage_serving_fn``, configured by the
configuration's preset and overrides (checked against its `model`), in
float32 with TF32 convolutions (its `precision_note`). It is given the
seed's weights (``onestage_weights``) and frames, nothing else. The plain
reference is ``reference/onestage_dla.py``.

`correct` compares each sampled frame's detections with the reference's as
``compare.unmatched_share`` does, every box moved first by its class id
times CLASS_MARGIN along both axes, so that a detection pairs only with one
of its own class.

End to end: `images_per_s`, every frame completed in the window over the
window's time. Facts for the readers: the requests, K2's least time per
traced request (the yardstick's count on the reference's NMS inputs for the
same frames), the deformable blocks' least time a request
(``counts/dcn.py`` on the reference's record of their shapes), the model's
FLOPs per image (``counts/onestage_flops.py``) and the dense peak of the
stated precision (TF32's).
"""

import statistics
from typing import Dict, Tuple

import numpy as np
import torch

from bench_port.harness import compare, frames as F, serving
from bench_port.harness.interface import Checked, Report
from bench_port.harness.onestage_weights import seeded_state_dict
from bench_port.kinds import closed_batches

CLASS_MARGIN = 1e4  # pixels between two classes' boxes: more than any canvas

window, free = closed_batches.window, serving.free


class Served:
    """The one-stage program, its inputs and its weights, from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from faster_orefsdet_tpu_torch.pipelines.onestage import build_pinned_onestage_serving_fn

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        cfg = serving.program_config(config)
        # TF32 convolutions, matrix products in float32 (PyTorch's defaults); the graph
        # captures the kernels chosen under them
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = config["model"]
        self.hw = tuple(traffic["frame_hw"])
        self.state = seeded_state_dict(self.model, seed, self.device)
        pool = F.belt_frames(seed, traffic["pool"], self.hw, tuple(traffic["blobs"]), self.device)
        self.pool = pool.cpu().pin_memory() if self.device.type == "cuda" else pool
        self.fn, self.canvas_hw = build_pinned_onestage_serving_fn(cfg, self.state, self.hw, device=self.device)
        self.deform = {}

    request = serving.Served.request  # frames in, packed detections on the host, under the harness's ranges


def setup(cell, seed: int, device, overrides=()) -> Served:
    if overrides:
        raise ValueError("onestage_batches takes no program overrides: its control is the reference")
    return Served(cell.config, cell.traffic, seed, device)


def warm_up(served: Served) -> None:
    """The one input shape, captured and replayed; the program's deformable
    convs counted over the bodies the capture ran (its warm-ups and the
    graph and its timed twin), where the program counts them."""
    from faster_orefsdet_tpu_torch.ops import deform_conv
    from faster_orefsdet_tpu_torch.pipelines import graphs

    counter = getattr(deform_conv, "counter", None)
    before = (counter.calls, counter.samples) if counter is not None else None
    closed_batches.warm_up(served)
    if before is not None and served.device.type == "cuda":
        bodies = graphs.WARMUP_CALLS + graphs.CAPTURES
        served.deform = {"deform_conv_calls_a_body": (counter.calls - before[0]) / bodies,
                         "deform_conv_samples_a_body": (counter.samples - before[1]) / bodies}


def reference(cell, served: Served, device):
    """The float32 reference with the seed's weights, TF32 off."""
    from bench_port.reference.onestage_dla import Reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return Reference(cell.config["model"], served.state, device)


def class_apart(boxes: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Boxes [..., 4] moved by their class id [...] times CLASS_MARGIN."""
    return np.asarray(boxes, np.float64) + CLASS_MARGIN * np.asarray(classes, np.float64)[..., None]


def answers_of(ref, pool: torch.Tensor, device, block: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`ref` over the whole pool in blocks of `block` frames: (boxes moved
    apart by class, scores, valid) per frame, numpy."""
    boxes, scores, valid = [], [], []
    for i in range(0, pool.shape[0], block):
        b, s, c, v = ref(pool[i:i + block].to(device))
        boxes.append(class_apart(b.float().cpu().numpy(), c.cpu().numpy()))
        scores.append(s.float().cpu().numpy())
        valid.append(v.cpu().numpy())
    return np.concatenate(boxes), np.concatenate(scores), np.concatenate(valid)


def check(cell, served: Served, win, rng: np.random.Generator, device) -> Checked:
    """A seeded sample of the window's answers, one for each input served,
    against the reference over the same frames, one request's batch a block."""
    picked = serving.sample(win, rng)
    ref = reference(cell, served, device)
    per = cell.traffic["batch"]
    want = answers_of(ref, served.pool, device, per)
    got = ((key * per + i, class_apart(p[i, :, :4], p[i, :, 5]), p[i, :, 4], p[i, :, 6] > 0.5)
           for key, p in picked.items() for i in range(p.shape[0]))
    return Checked(compare.numbers(serving.shares(got, want)), ref)


def reference_control(cell, seed: int, device, dtype) -> Dict[str, float]:
    """The reference under autocast to `dtype` in the program's place, every
    pool frame, against the float32 reference."""
    from bench_port.reference.onestage_dla import Reference

    served = setup(cell, seed, device)
    free(served)
    per = cell.traffic["batch"]
    want = answers_of(reference(cell, served, device), served.pool, device, per)
    with torch.autocast(torch.device(device).type, dtype=dtype):
        got = answers_of(Reference(cell.config["model"], served.state, device), served.pool, device, per)
    return compare.numbers(serving.shares(((f, got[0][f], got[1][f], got[2][f]) for f in range(len(got[0]))), want))


def report(cell, served: Served, win, checked, trace) -> Report:
    images = sum(r.images for r in win.requests)
    facts = {"requests": win.requests}
    if trace is not None:
        from bench_port.counts import dcn, k2, onestage_flops, peaks

        record = checked.reference.record
        per_block = [k2.call_seconds(*nms) for nms in record["k2"]]
        facts["k2_s"] = float(np.mean([per_block[r.key] for r in win.requests if r.traced]))
        facts["peak_flops"] = peaks.BY_PRECISION[cell.config["precision"]]
        facts["dcn_s"] = sum(dcn.call_seconds(*shape, facts["peak_flops"]) for shape in record["dcn"][0])
        block = served.pool[:cell.traffic["batch"]].to(served.device)
        facts["flops_per_image"] = onestage_flops.per_image(checked.reference, block)
    info = {"requests": len(win.requests), "images": images, "canvas": list(served.canvas_hw),
            "request_ms_median": statistics.median((r.done - r.send) * 1e3 for r in win.requests), **served.deform}
    info.update({k: facts[k] for k in ("k2_s", "dcn_s", "flops_per_image") if k in facts})
    return Report({"images_per_s": images / win.seconds}, images, 0, facts, info)
