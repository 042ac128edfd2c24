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
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..config import Config
from ..pipelines.train_step import Replica, TrainBatch, TrainState, _check_trainable, loss_fn
from ..solver import build_schedule, optimizer_step
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
                grads = [p.grad for p in state.model.parameters() if p.grad is not None]
                stats = [t for k, t in state.model.state_dict().items() if is_batch_stat(k)]
                values = torch.stack(list(metrics.values()))
                all_reduce_mean(grads + stats + [values], world)
                metrics = dict(zip(metrics, values.unbind()))
        with record_function("optimizer"):
            optimizer_step(state.optimizer, cfg.solver, schedule, state.step)
        state.step += 1
        return metrics

    return train_step
