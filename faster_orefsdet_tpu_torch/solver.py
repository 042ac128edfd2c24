"""Optimizer and LR schedule for fine-tuning (counterpart of
``faster_orefsdet_tpu/solver.py``): SGD with momentum in parameter groups,
warmup schedules, gradient clipping.

One update equals the JAX package's optax chain for each group, step for
step: clip the gradient (by value, or each tensor by its own norm), add the
decayed weights, fold into the momentum trace, scale by the scheduled LR
times the group's factor. The schedule counts optimizer steps from 0, as
optax does. Groups:

  base   every trainable parameter not below;
  head   the cascade box predictors' cls / bbox layers (head_lr_factor x LR);
  norm   the GroupNorm and trainable BatchNorm affines (weight_decay_norm);
  frozen VoVNet's stem, stage2 and stage3, and every FrozenBN affine:
         requires_grad=False, never in the optimizer.

The update is the port's own foreach arithmetic over the groups of a
``torch.optim.SGD`` (which holds the groups and the momentum buffers, and
so the checkpoint's layout): each group's LR is a 0-dim tensor on the
device, written by ``set_lr`` before the update and read by it there, so
that a CUDA graph of the update (``sgd_update``) reads each step's LR. A
trainable parameter without a gradient takes a zero one, as optax's does
(weight decay and momentum still move it).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List

import torch

from .config import SolverConfig
from .models.detector import FROZEN_PREFIXES

Schedule = Callable[[int], float]


def _warmup_factor(count: int, cfg: SolverConfig) -> float:
    """1 past warmup_iters; during warmup, "linear" interpolates
    warmup_factor -> 1 and "constant" holds warmup_factor."""
    if cfg.warmup_method == "linear":
        alpha = count / cfg.warmup_iters if cfg.warmup_iters else 1.0
        during = cfg.warmup_factor * (1 - alpha) + alpha
    elif cfg.warmup_method == "constant":
        during = cfg.warmup_factor
    else:
        raise ValueError(f"Unknown warmup method: {cfg.warmup_method}")
    return during if count < cfg.warmup_iters else 1.0


def warmup_multistep_schedule(cfg: SolverConfig) -> Schedule:
    """d2 WarmupMultiStepLR: warmup to 1, then gamma^k after k milestones."""

    def schedule(count: int) -> float:
        k = sum(count >= s for s in cfg.steps)
        return cfg.base_lr * _warmup_factor(count, cfg) * cfg.gamma ** k

    return schedule


def warmup_cosine_schedule(cfg: SolverConfig) -> Schedule:
    """d2 WarmupCosineLR: the warmup factor times a half-cosine over
    [0, max_iter] that starts at iteration 0, not at the end of warmup."""

    def schedule(count: int) -> float:
        return cfg.base_lr * _warmup_factor(count, cfg) * 0.5 * (1.0 + math.cos(math.pi * count / cfg.max_iter))

    return schedule


def build_schedule(cfg: SolverConfig) -> Schedule:
    """SOLVER.LR_SCHEDULER_NAME dispatch."""
    if cfg.lr_scheduler_name == "WarmupMultiStepLR":
        return warmup_multistep_schedule(cfg)
    if cfg.lr_scheduler_name == "WarmupCosineLR":
        return warmup_cosine_schedule(cfg)
    raise ValueError(f"Unknown LR scheduler: {cfg.lr_scheduler_name}")


def clip_gradients(params: Iterable[torch.Tensor], cfg: SolverConfig) -> None:
    """SOLVER.CLIP_GRADIENTS on the .grad of `params`, in place and without a
    host sync: "value" clamps to +-clip_value; "norm" scales each tensor by
    min(1, clip_value / (||g||_p + 1e-6)), its own norm, not a global one."""
    if not cfg.clip_gradients:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if cfg.clip_type == "value":
        torch._foreach_clamp_min_(grads, -cfg.clip_value)
        torch._foreach_clamp_max_(grads, cfg.clip_value)
    elif cfg.clip_type == "norm":
        for g in grads:
            norm = torch.linalg.vector_norm(g.float(), ord=cfg.norm_type)
            g.mul_(torch.clamp(cfg.clip_value / (norm + 1e-6), max=1.0).to(g.dtype))
    else:
        raise ValueError(f"Unknown gradient clip type: {cfg.clip_type}")


def param_label(name: str, trainable: bool = True) -> str:
    """'frozen' | 'head' | 'norm' | 'base' of a state_dict key, by the JAX
    package's rules; buffers (FrozenBN affines, BatchNorm statistics) are
    frozen."""
    if not trainable or name.startswith(FROZEN_PREFIXES) or ".norm." in name:
        return "frozen"
    if "_cls." in name or "_bbox." in name:
        return "head"
    if "_gn." in name or ".gn." in name or ".bn." in name:
        return "norm"
    return "base"


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """{state_dict key: label} of every parameter and buffer of `model`."""
    params = dict(model.named_parameters())
    return {name: param_label(name, name in params) for name in model.state_dict()}


def build_optimizer(cfg: SolverConfig, model: torch.nn.Module) -> torch.optim.SGD:
    """torch.optim.SGD over the model's trainable parameters in the groups
    base / head / norm; each group carries its `lr_factor`. Call
    ``optimizer_step`` to clip, set the scheduled LR and update."""
    groups: Dict[str, list] = {"base": [], "head": [], "norm": []}
    for name, p in model.named_parameters():
        if p.requires_grad and param_label(name) != "frozen":
            groups[param_label(name)].append(p)
    setting = {
        "base": (1.0, cfg.weight_decay),
        "head": (cfg.head_lr_factor, cfg.weight_decay),
        "norm": (1.0, cfg.weight_decay_norm),
    }
    param_groups = [{"params": ps, "name": g, "lr_factor": setting[g][0], "weight_decay": setting[g][1]}
                    for g, ps in groups.items() if ps]
    return torch.optim.SGD(param_groups, lr=cfg.base_lr, momentum=cfg.momentum, nesterov=cfg.nesterov)


def _lr_tensors(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Each group's LR as a 0-dim f32 tensor on its parameters' device."""
    lrs = getattr(optimizer, "lr_tensors", None)
    if lrs is None:
        lrs = optimizer.lr_tensors = [torch.zeros((), device=g["params"][0].device) for g in optimizer.param_groups]
    return lrs


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write lr x each group's factor into the group's LR tensor (a fill on
    the device, no wait) and into its `lr` entry."""
    for g, t in zip(optimizer.param_groups, _lr_tensors(optimizer)):
        g["lr"] = lr * g["lr_factor"]
        t.fill_(g["lr"])


@torch.no_grad()
def sgd_update(optimizer: torch.optim.Optimizer, cfg: SolverConfig) -> None:
    """Clip the gradients, then per group: add the decayed weights, fold into
    the momentum trace (zeros before the first step), step by the group's LR
    tensor. No host value is read, so a CUDA graph can hold it."""
    clip_gradients((p for g in optimizer.param_groups for p in g["params"]), cfg)
    for g, lr in zip(optimizer.param_groups, _lr_tensors(optimizer)):
        params = g["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if g["weight_decay"]:
            grads = torch._foreach_add(grads, params, alpha=g["weight_decay"])
        bufs = []
        for p in params:
            state = optimizer.state[p]
            if state.get("momentum_buffer") is None:
                state["momentum_buffer"] = torch.zeros_like(p)
            bufs.append(state["momentum_buffer"])
        torch._foreach_mul_(bufs, cfg.momentum)
        torch._foreach_add_(bufs, grads)
        step = torch._foreach_add(grads, bufs, alpha=cfg.momentum) if cfg.nesterov else bufs
        torch._foreach_sub_(params, torch._foreach_mul(step, lr))


def optimizer_step(optimizer: torch.optim.Optimizer, cfg: SolverConfig, schedule: Schedule, count: int) -> None:
    """One update at optimizer step `count` (from 0): set each group's LR to
    schedule(count) x its factor, clip the gradients, update."""
    set_lr(optimizer, schedule(count))
    sgd_update(optimizer, cfg)
