"""Data-parallel fine-tuning with ``torch.distributed`` (counterpart of
``faster_orefsdet_tpu/parallel/train_dp.py``).

Each rank is one process (``mesh.spawn_ranks``) holding a replica of the
train state and its rows of the global batch. The reference's collectives
(SURVEY.md §5) become all-reduces in the process group:

  - the positive count that normalizes the heatmap losses, summed over the
    ranks inside ``loss_fn`` (its `dp` argument);
  - the gradients, averaged before the clip and the SGD update (DDP's
    backward all-reduce);
  - the running BatchNorm statistics (finetune_dla), averaged, so that the
    replicas stay equal, as the JAX package averages them (no SyncBN);
  - the metrics, averaged.

The last three travel in one flat buffer, one all-reduce a step; the
statistics are final after the forward pass and the update does not read
them, so averaging them there equals averaging them after the step.

``build_dp_train_step`` takes each step eagerly. ``build_pinned_dp_train_step``
is the counterpart of the JAX package's one jitted ``shard_map`` step: on
the card each rank replays one CUDA graph a step, NCCL's all-reduces
captured in it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..config import Config
from ..pipelines.train_step import (
    Replica, StepBody, TrainBatch, TrainState, TrainStepK, _check_trainable, loss_fn,
)
from ..solver import build_schedule, optimizer_step, sgd_update
from ..utils.params import is_batch_stat
from .mesh import rank_and_world


def replicate_state(state: TrainState) -> TrainState:
    """Make every rank's state rank 0's, in place: parameters, buffers,
    momentum buffers, step count and the generator's state (broadcasts).
    Call it on every rank after building or resuming the state. Does
    nothing outside a group of more than one."""
    _, world = rank_and_world()
    if world <= 1:
        return state
    dev = state.device
    for t in state.model.state_dict().values():
        dist.broadcast(t, 0)
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    has_momentum = all(opt.state[p].get("momentum_buffer") is not None for p in params)
    meta = torch.tensor([state.step, int(has_momentum)], dtype=torch.int64, device=dev)
    dist.broadcast(meta, 0)
    state.step = int(meta[0])
    for p in params:
        if meta[1]:
            buf = opt.state[p].get("momentum_buffer")
            if buf is None:
                buf = opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
            dist.broadcast(buf, 0)
        else:
            opt.state[p].pop("momentum_buffer", None)
    # a CUDA generator's state is a CPU byte tensor; NCCL moves only CUDA tensors
    gen = state.generator.get_state().to(dev)
    dist.broadcast(gen, 0)
    state.generator.set_state(gen.cpu())
    return state


def shard_batch(batch: TrainBatch, rank: int, world: int) -> TrainBatch:
    """Rank `rank`'s rows of a global batch split evenly over `world` ranks."""
    b = batch.images.shape[0]
    if b % world:
        raise ValueError(f"shard_batch: a batch of {b} does not split over {world} ranks")
    n = b // world
    return TrainBatch(*(t[rank * n:(rank + 1) * n] for t in batch))


def all_reduce_mean(tensors: List[torch.Tensor], world: int) -> None:
    """Replace each tensor by its mean over the group's `world` ranks, in
    place, with one all-reduce of a flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _average_over_ranks(state: TrainState, metrics: Dict[str, torch.Tensor], world: int
                        ) -> Dict[str, torch.Tensor]:
    """The step's one all-reduce: the gradients, the running statistics and
    the metrics, each replaced by its mean over the ranks (the metrics as
    new 0-dim tensors)."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    stats = [t for k, t in state.model.state_dict().items() if is_batch_stat(k)]
    values = torch.stack(list(metrics.values()))
    all_reduce_mean(grads + stats + [values], world)
    return dict(zip(metrics, values.unbind()))


def dropout_seed(seed: int, rank: int, step: int) -> int:
    """The seed of rank `rank`'s dropout draws at optimizer step `step`: its
    own stream per rank (the JAX package folds the replica index into the
    dropout key), which a resumed run takes up again at its step."""
    return int(np.random.SeedSequence([seed, rank, step]).generate_state(1, np.uint64)[0])


def build_dp_train_step(cfg: Config, deterministic: bool = False
                        ) -> Callable[[TrainState, TrainBatch], Dict[str, torch.Tensor]]:
    """(state, batch) -> metrics: one data-parallel update of this rank's
    `state` in place, `batch` being its rows of the global batch
    (``shard_batch``). The loss over the rank's rows, backward, one
    all-reduce of the gradients, the running statistics and the metrics
    (their mean over the ranks), then the clip and scheduled SGD step of
    ``build_train_step``. The metrics are 0-dim device tensors, the same on
    every rank; nothing waits for the device on the host.

    Every rank must call it with the same step count and generator state
    (``replicate_state``): the ROI sampling keys come from that generator,
    at the global batch's shape. Outside a group of more than one it is
    ``build_train_step``, update for update. deterministic=True turns the
    SM-block dropout off."""
    _check_trainable(cfg)
    schedule = build_schedule(cfg.solver)
    dropout: Dict[torch.device, torch.Generator] = {}

    def train_step(state: TrainState, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        rank, world = rank_and_world()
        gen = state.generator
        if world > 1:
            gen = dropout.setdefault(state.device, torch.Generator(device=state.device))
            gen.manual_seed(dropout_seed(cfg.seed, rank, state.step))
        state.optimizer.zero_grad(set_to_none=True)
        total, losses = loss_fn(state.model, batch.to(state.device), state.generator, deterministic=deterministic,
                                dp=Replica(rank, world, gen))
        with record_function("backward"):
            total.backward()
        metrics = {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
        if world > 1:
            with record_function("all_reduce"):
                metrics = _average_over_ranks(state, metrics, world)
        with record_function("optimizer"):
            optimizer_step(state.optimizer, cfg.solver, schedule, state.step)
        state.step += 1
        return metrics

    return train_step


class _ReplicaBody(StepBody):
    """``build_dp_train_step``'s update as a ``StepBody``: the loss of the
    rank's rows with `dp` (the positive count all-reduced), backward, the
    one flat all-reduce, clip and SGD. Before each step the host writes the
    LR and re-seeds the rank's dropout generator at (cfg.seed, rank, step);
    both generators are registered with a graph of `run`."""

    def __init__(self, cfg: Config, deterministic: bool):
        super().__init__(cfg)
        self.deterministic = deterministic
        self.dropout: Optional[torch.Generator] = None  # the rank's, on its state's device

    def replica(self, state: TrainState) -> Replica:
        rank, world = rank_and_world()
        if world == 1:  # build_train_step's draws
            return Replica(rank, world, state.generator)
        if self.dropout is None:  # made once, before any capture (a capture cannot make a generator)
            self.dropout = torch.Generator(device=state.device)
        return Replica(rank, world, self.dropout)

    def generators(self, state: TrainState) -> List[torch.Generator]:
        dp = self.replica(state)
        return [state.generator] + ([dp.dropout] if dp.world > 1 else [])

    def prepare(self, state: TrainState) -> None:
        super().prepare(state)
        dp = self.replica(state)
        if dp.world > 1:
            dp.dropout.manual_seed(dropout_seed(self.cfg.seed, dp.rank, state.step))

    def run(self, state: TrainState, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        dp = self.replica(state)
        total, losses = loss_fn(state.model, batch, state.generator, deterministic=self.deterministic, dp=dp)
        total.backward()
        metrics = {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
        if dp.world > 1:
            metrics = _average_over_ranks(state, metrics, dp.world)
        sgd_update(state.optimizer, self.cfg.solver)
        return metrics


class PinnedDPTrainStep(TrainStepK):
    """step(state, batch) -> metrics: ``build_pinned_dp_train_step``'s step
    function. Its graphs, `kernel_launches()` and warm-ups are
    ``TrainStepK``'s."""

    def __call__(self, state: TrainState, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        _, world = rank_and_world()
        if state.device.type == "cuda" and world > 1 and dist.get_backend() != "nccl":
            raise ValueError(
                "build_pinned_dp_train_step: a captured step needs NCCL, and this group's backend is "
                f"{dist.get_backend()!r} (gloo copies CUDA tensors through the host, which a CUDA graph cannot "
                "hold). Use build_dp_train_step for gloo ranks on the card, or NCCL with one rank a card."
            )
        out = self.step(state, batch)
        return dict(zip(self.names, out.unbind()))


def build_pinned_dp_train_step(cfg: Config, deterministic: bool = False) -> PinnedDPTrainStep:
    """(state, batch) -> metrics: ``build_dp_train_step``'s update, the same
    from the same state, batches and generators, with every step of a
    batch shape after the first WARMUP_STEPS one CUDA graph replay on the
    card (the counterpart of the JAX package's jitted ``shard_map`` step).

    On the card, in an NCCL group: WARMUP_STEPS eager steps per batch
    shape on a side stream of the rank's card (real steps; they also create
    NCCL's communicator, which a capture cannot), then one capture of the
    whole step (the loss with its positive-count all-reduce, backward, the
    flat all-reduce of gradients, running statistics and metrics, clip and
    SGD with each group's LR read from its device tensor); each later step
    copies the batch in, writes the LR, re-seeds the rank's dropout
    generator and replays. Every rank must see the same batch shapes in the
    same order, so that all warm up and capture at the same step. At world
    1 it is the same graph without collectives (``build_train_step_scan``'s
    step). On the CPU it takes eager steps. On the card in a gloo group it
    raises: gloo copies CUDA tensors through the host. The graphs hold the
    state's tensors: one step function per train state, as
    ``build_train_step_scan``."""
    return PinnedDPTrainStep(cfg, _ReplicaBody(cfg, deterministic))
