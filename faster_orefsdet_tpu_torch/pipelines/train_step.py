"""Episodic fine-tuning step: the loss and one SGD update (counterpart of
``faster_orefsdet_tpu/pipelines/train_step.py``).

Per query image: encode its way x shot support crops, SM-refine and
shot-mean them into CGM taps (one set per image), correlate the query
pyramid through the differentiable composition, run the CenterNet losses
and the proposal decode (the NMS kernel on the card, no gradient), sample
128 ROIs and run the DSA cascade stage losses. Everything is batched over
the images where the JAX package vmaps; losses are the mean over images.

Batch layout (fixed shapes, NCHW as the rest of the port):
  images          [B, 3, Hc, Wc]      raw uint8 (normalized here) or normalized
  image_hw        [B, 2]              true resized sizes
  gt_boxes        [B, N, 4]; gt_classes [B, N]; gt_valid [B, N]
  support_images  [B, S, 3, hs, ws]   raw uint8 or normalized
  support_boxes   [B, S, 4]

Randomness (the SM blocks' dropout, the ROI sampling keys) comes from one
torch.Generator on the model's device, held in the train state. A step
returns its metrics as device tensors, so it never waits for the device.
Trainable norms (DLA's BatchNorm) run in batch-statistics mode in both
feature passes, the query's first, and update their running statistics in
place, as the JAX package's loss_fn with batch_stats does.

``build_train_step_scan`` runs K steps per call: on the card, each step is
one replay of a CUDA graph of the whole step (forward, backward, clip,
SGD), the same arithmetic as ``build_train_step``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..config import Config
from ..models.cascade_roi import ROI_STRIDES, label_proposals, stage_losses, subsample_proposals
from ..models.centernet import _level_valid_mask, centernet_losses, decode_proposals
from ..models.detector import CenterNet2Detector, support_kernels
from ..ops.heatmap import more_pos_inds, render_targets
from ..ops.roi_align_cuda import multilevel_roi_pool
from ..ops import _native
from ..solver import build_optimizer, build_schedule, optimizer_step, set_lr, sgd_update
from ..structures.boxes import apply_deltas
from ..structures.instances import GroundTruth
from ..utils.device import resolve_device
from .inference import normalize_uint8
from .preprocess import pixel_stats


class TrainBatch(NamedTuple):
    images: torch.Tensor
    image_hw: torch.Tensor
    gt_boxes: torch.Tensor
    gt_classes: torch.Tensor
    gt_valid: torch.Tensor
    support_images: torch.Tensor
    support_boxes: torch.Tensor

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(t.to(device, non_blocking=True) for t in self))


def prepare_batch(batch: TrainBatch, cfg: Config) -> TrainBatch:
    """Normalize raw uint8 batches on their device. The query padding beyond
    image_hw and the support padding beyond the crop size are set back to 0
    (normalize-then-pad, as the reference). Float batches pass unchanged."""
    if batch.images.dtype != torch.uint8:
        return batch
    images = normalize_uint8(batch.images, batch.image_hw, cfg)
    mean, std = pixel_stats(tuple(cfg.input.pixel_mean), tuple(cfg.input.pixel_std),
                            device=batch.support_images.device)
    sup = (batch.support_images.float() - mean) / std
    cs = cfg.fs.support_crop_size  # the support's valid region is static (mapper)
    sup[..., cs:, :] = 0.0
    sup[..., :, cs:] = 0.0
    return batch._replace(images=images, support_images=sup)


class Replica(NamedTuple):
    """This process's share of a data-parallel step (``parallel.train_dp``),
    the counterpart of the JAX package's axis_name: rank `rank` of `world`,
    and the generator of this rank's own dropout draws."""

    rank: int
    world: int
    dropout: torch.Generator


def loss_fn(
    model: CenterNet2Detector,
    batch: TrainBatch,
    generator: Optional[torch.Generator] = None,
    *,
    deterministic: bool = False,
    injected_rois: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dp: Optional[Replica] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {loss name: scalar}) of one batch under model.cfg.

    generator draws the SM-block dropout and the ROI sampling keys.
    deterministic=True turns the dropout off; injected_rois=(boxes [B, R, 4],
    valid [B, R]) replaces the proposal decode and the random ROI sampling
    by a fixed set, labelled by the stage-0 matcher like a sampled one (the
    hooks of the JAX package's loss_fn, for parity).

    dp: `batch` is rank dp.rank's rows of a global batch of dp.world times
    as many. The positive count that normalizes the heatmap losses is then
    summed over the ranks (an all-reduce in the process group); the ROI
    sampling keys are drawn from `generator` (replicated) at the global
    batch's shape and the rank keeps its rows, so that N ranks draw what one
    rank draws over the global batch; the dropout draws from dp.dropout."""
    cfg = model.cfg
    cn, roi = cfg.centernet, cfg.roi
    batch = prepare_batch(batch, cfg)
    b, s = batch.support_images.shape[:2]
    canvas_hw = (batch.images.shape[-2], batch.images.shape[-1])
    strides = tuple(cn.fpn_strides)
    shot = min(cfg.fs.support_shot, s)

    with record_function("features"):
        qfeats = model.features(batch.images, train=True)
        sfeats = model.features(batch.support_images.reshape(b * s, *batch.support_images.shape[2:]), train=True)

    # support ROI pools for the DSA head: the shot-mean over the positive way
    # only (the mapper orders the positive way first)
    sup_levels = [sfeats[level] for level in ("p3", "p4", "p5")]

    def pool(size):
        pooled = multilevel_roi_pool(
            sup_levels, batch.support_boxes.reshape(b * s, 1, 4), ROI_STRIDES, size,
            roi.pooler_sampling_ratio, roi.canonical_box_size, roi.canonical_level,
        )[:, 0]
        return pooled.reshape(b, s, *pooled.shape[1:])[:, :shot].mean(dim=1)

    sup8_mean, sup4_mean = pool(roi.pooler_resolution), pool(roi.pooler_resolution2)

    with record_function("refine_support"):
        refined = model.refine_support(sfeats, None if deterministic else (dp.dropout if dp else generator))
        kernels = {level: support_kernels(v.reshape(b, s, *v.shape[1:])[:, :shot].mean(dim=1))
                   for level, v in refined.items()}
    with record_function("correlate"):
        pos_feats = model.correlate(qfeats, kernels)
    with record_function("proposal_head"):
        agn_hms, bbox_regs = model.proposal_head(pos_feats)

    with record_function("targets"):
        targets = render_targets(batch.gt_boxes, batch.gt_valid, canvas_hw, strides, cn.sizes_of_interest,
                                 hm_min_overlap=cn.hm_min_overlap, min_radius=cn.min_radius)
        if cn.more_pos:  # MORE_POS mining replaces the center positives
            reg_flat = torch.cat([r.detach().permute(0, 2, 3, 1).reshape(b, -1, 4) for r in bbox_regs], dim=1)
            inds, mask = more_pos_inds(batch.gt_boxes, batch.gt_valid, reg_flat, canvas_hw, strides,
                                       cn.sizes_of_interest, more_pos_topk=cn.more_pos_topk,
                                       more_pos_thresh=cn.more_pos_thresh, loc_loss_type=cn.loc_loss_type)
            targets = targets._replace(pos_inds=inds, pos_mask=mask)
        canvas_valid = _level_valid_mask(canvas_hw, strides, batch.image_hw)
        total_pos, world = targets.pos_mask.sum(), dp.world if dp else 1
        if world > 1:  # the reference's reduce_sum of num_pos over the data-parallel group
            dist.all_reduce(total_pos)
        num_pos_avg = (total_pos / world / b).clamp(min=1.0)
    losses = {k: v.mean() for k, v in centernet_losses(agn_hms, bbox_regs, targets, cn, canvas_valid,
                                                       num_pos_avg=num_pos_avg).items()}

    # single-class path: gt classes are 0
    gt = GroundTruth(batch.gt_boxes, torch.zeros_like(batch.gt_classes), batch.gt_valid)
    if injected_rois is None:
        with record_function("decode_proposals"), torch.no_grad():
            proposals = decode_proposals([h.detach() for h in agn_hms], [r.detach() for r in bbox_regs], cn,
                                         canvas_hw, batch.image_hw, training=True)
        with record_function("roi_sampling"):
            boxes, cls_t, box_t, slot_valid = subsample_proposals(
                generator, proposals.boxes, proposals.valid, gt, roi,
                rows=(dp.rank * b, dp.world * b) if dp else None)
    else:
        boxes, slot_valid = injected_rois
        cls_t, box_t = label_proposals(boxes, slot_valid, gt, roi.cascade_ious[0], roi.num_classes)

    feat_list = [qfeats[level] for level in ("p3", "p4", "p5")]
    with record_function("roi_stage"):
        for stage in range(len(roi.cascade_ious)):
            out = model.roi_stage(feat_list, boxes, sup8_mean, sup4_mean, stage)
            losses.update({k: v.mean() for k, v in stage_losses(out, boxes, cls_t, box_t, slot_valid, roi,
                                                                 stage).items()})
            if stage + 1 < len(roi.cascade_ious):  # re-match at the next stage's IoU
                boxes = apply_deltas(out.deltas, boxes, roi.cascade_bbox_reg_weights[stage]).detach()
                cls_t, box_t = label_proposals(boxes, slot_valid, gt, roi.cascade_ious[stage + 1], roi.num_classes)
    return sum(losses.values()), losses


def _check_trainable(cfg: Config) -> None:
    """Quantized presets are serving-only: a rounded conv has no gradient."""
    if cfg.quantize != "none":
        raise ValueError(
            f"quantize={cfg.quantize!r} is a serving-only preset (no straight-through estimator in "
            "the quantized convs: gradients would be zero). Train with quantize=none."
        )


@dataclass
class TrainState:
    """The model (f32 master weights, frozen set marked), its optimizer, the
    count of optimizer steps taken, and the generator of the step's draws
    (on the model's device)."""

    model: CenterNet2Detector
    optimizer: torch.optim.SGD
    step: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_train_model(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None, *,
                     device="cuda") -> CenterNet2Detector:
    """The detector of `cfg` on `device` (the card unless the caller asks
    for the CPU) in training mode: f32 weights, `params` (a state_dict)
    loaded strictly when given, the frozen set requires_grad=False."""
    _check_trainable(cfg)
    dev = resolve_device(device)
    model = CenterNet2Detector(cfg)
    if params is not None:
        model.load_state_dict(params, strict=True)
    return model.to(dev).freeze().train()


def build_train_state(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None, *,
                      device="cuda", seed: Optional[int] = None) -> TrainState:
    """A fresh train state: the training model, its optimizer, step 0, and a
    generator seeded with `seed` (default cfg.seed + 1)."""
    model = make_train_model(cfg, params, device=device)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(cfg.seed + 1 if seed is None else seed)
    return TrainState(model, build_optimizer(cfg.solver, model), 0, generator)


def build_train_step(cfg: Config, deterministic: bool = False
                     ) -> Callable[[TrainState, TrainBatch], Dict[str, torch.Tensor]]:
    """(state, batch) -> metrics: one update of `state` in place (loss,
    backward, clip, scheduled SGD step) on the state's device. The metrics
    are 0-dim device tensors: total_loss and each loss. deterministic=True
    turns the SM-block dropout off."""
    _check_trainable(cfg)
    schedule = build_schedule(cfg.solver)

    def train_step(state: TrainState, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        total, losses = loss_fn(state.model, batch.to(state.device), state.generator, deterministic=deterministic)
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            optimizer_step(state.optimizer, cfg.solver, schedule, state.step)
        state.step += 1
        return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    return train_step


WARMUP_STEPS = 2  # eager steps of each batch shape before its capture


class StepBody:
    """One train step in the two parts that a CUDA graph of it splits it
    into: `prepare`, the host's work before the step (each group's
    scheduled LR, written to its device tensor), and `run`, the device's
    work (``build_train_step``'s loss, backward, clip and SGD update), which
    waits for nothing on the host and copies nothing from it, so that a
    graph can hold it. `run` draws from `generators(state)`, which a graph
    registers. ``TrainStepK`` drops the gradients before `run`, so that its
    backward allocates them."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.schedule = build_schedule(cfg.solver)

    def generators(self, state: TrainState) -> List[torch.Generator]:
        return [state.generator]

    def prepare(self, state: TrainState) -> None:
        set_lr(state.optimizer, self.schedule(state.step))

    def run(self, state: TrainState, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        total, losses = loss_fn(state.model, batch, state.generator)
        total.backward()
        sgd_update(state.optimizer, self.cfg.solver)
        return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}


class _StepGraph:
    """One captured train step: the graph, its static batch, its output (the
    metrics stacked), the kernel launches captured into it and its replays."""

    def __init__(self, graph, batch: TrainBatch, out: torch.Tensor, launches: Dict[str, int]):
        self.graph, self.batch, self.out, self.launches = graph, batch, out, launches
        self.replays = 0


class TrainStepK:
    """step_k(state, batches) -> {metric: [len(batches)] tensor}: one train
    step of `body` (default ``StepBody``) per batch on `state`, in order
    (see ``build_train_step_scan``)."""

    def __init__(self, cfg: Config, body: Optional[StepBody] = None):
        _check_trainable(cfg)
        self.body = body or StepBody(cfg)
        self.graphs: Dict[tuple, _StepGraph] = {}
        self._eager_steps: Dict[tuple, int] = {}
        self._eager_launches = dict.fromkeys(_native.LAUNCH_COUNTERS, 0)
        self._state: Optional[TrainState] = None
        self._stream = None
        self.names: Optional[List[str]] = None  # the metrics, in the order `step` stacks them

    def __call__(self, state: TrainState, batches: Sequence[TrainBatch]) -> Dict[str, torch.Tensor]:
        out = torch.stack([self.step(state, b) for b in batches])
        return {k: out[:, i] for i, k in enumerate(self.names)}

    def step(self, state: TrainState, batch: TrainBatch) -> torch.Tensor:
        """One step on `batch`; its metrics stacked in the order of `names`."""
        batch = batch.to(state.device)
        if state.device.type != "cuda":
            return self._eager(state, batch)
        if self._state is None:
            self._state, self._stream = state, torch.cuda.Stream(state.device)
        elif state is not self._state:
            raise ValueError("this step function's graphs belong to another train state: build one per state")
        key = tuple((tuple(t.shape), t.stride(), t.dtype) for t in batch)
        with torch.cuda.device(state.device):
            g = self.graphs.get(key)
            if g is None and self._eager_steps.get(key, 0) >= WARMUP_STEPS:
                g = self.graphs[key] = self._capture(state, batch)
            if g is None:
                return self._warmup(state, batch, key)
            for static, t in zip(g.batch, batch):
                static.copy_(t, non_blocking=True)
            self.body.prepare(state)
            g.graph.replay()
            g.replays += 1
            state.step += 1
            return g.out.clone()  # the next replay overwrites g.out

    def _eager(self, state: TrainState, batch: TrainBatch) -> torch.Tensor:
        """One eager step of the body (the CPU's steps and the card's
        warm-ups), its kernel launches added to the eager count."""
        self.body.prepare(state)
        state.optimizer.zero_grad(set_to_none=True)
        before = _native.launch_counts()
        metrics = self.body.run(state, batch)
        for name, n in _native.launches_since(before).items():
            self._eager_launches[name] += n
        state.step += 1
        self.names = list(metrics)
        return torch.stack(list(metrics.values()))

    def _warmup(self, state: TrainState, batch: TrainBatch, key: tuple) -> torch.Tensor:
        """A real eager step on the capture's stream (lazy state is made
        there: momentum buffers, LR tensors, a communicator's first use)."""
        cur = torch.cuda.current_stream(state.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self._eager(state, batch)
        cur.wait_stream(self._stream)
        for t in batch:  # made on the caller's stream, read on the capture's
            t.record_stream(self._stream)
        out.record_stream(cur)
        self._eager_steps[key] = self._eager_steps.get(key, 0) + 1
        return out

    def _capture(self, state: TrainState, batch: TrainBatch) -> _StepGraph:
        """Capture the body's `run` on the static batch. The gradients are
        dropped first, so that the backward in the capture allocates them
        from the graph's pool; the body's generators are registered, so that
        each replay draws at their seed and offset of the moment. A capture
        that fails raises."""
        static = TrainBatch(*(torch.empty_like(t) for t in batch))
        for s, t in zip(static, batch):
            s.copy_(t)
        self._stream.wait_stream(torch.cuda.current_stream(state.device))
        state.optimizer.zero_grad(set_to_none=True)
        before = _native.launch_counts()
        graph = torch.cuda.CUDAGraph()
        for gen in self.body.generators(state):
            graph.register_generator_state(gen)
        # thread_local: the loader's thread may copy to the card meanwhile,
        # and a process group's watchdog thread queries its events
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
            out = torch.stack(list(self.body.run(state, static).values()))
        launches = _native.launches_since(before)
        return _StepGraph(graph, static, out, launches)

    def kernel_launches(self) -> Dict[str, int]:
        """The kernel launches of every step taken: the eager warm-up steps'
        and, for each graph, its captured launches times its replays (the
        wrappers' counters advance when a call is captured, not when a graph
        replays)."""
        return {k: self._eager_launches[k] + sum(g.launches[k] * g.replays for g in self.graphs.values())
                for k in self._eager_launches}


def build_train_step_scan(cfg: Config) -> TrainStepK:
    """step_k(state, batches) -> {metric: [k] device tensor}: k train steps
    on `state`, one per batch, the same updates as k ``build_train_step``
    calls from the same state, batches and generator.

    On the card the first WARMUP_STEPS steps of each batch shape run eagerly
    (real steps of the run, on the capture's stream), then the whole step
    (loss, backward, clip, SGD update) is captured once into a CUDA graph
    with static batch buffers, the generator registered and each group's LR
    read from a device tensor; every later step of that shape copies its
    batch in, writes the scheduled LR and replays the graph, a few host
    calls instead of some 3000 launches. The graphs hold the state's
    parameters, optimizer buffers and generator: use one step function per
    train state, and build it anew after replacing any of them
    (``utils.checkpoint.resume_or_load`` restores into them in place, so a
    resume between replays is fine). On the CPU it runs k eager steps."""
    return TrainStepK(cfg)


def run_scan_chunk(step_k: TrainStepK, state: TrainState, loader: Iterator[TrainBatch], kk: int
                   ) -> Dict[str, torch.Tensor]:
    """Pull kk batches from the loader and take kk steps: {metric: [kk]}."""
    return step_k(state, [next(loader) for _ in range(kk)])
