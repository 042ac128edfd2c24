"""Training checkpoints and portable parameter files (counterpart of
``faster_orefsdet_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file per saved step, holding the model's
state_dict, the optimizer's, the step count and the generator's state; the
last `max_to_keep` are kept. ``resume_or_load`` restores the newest into a
train state, or leaves the state as it is when the directory has none.

``save_params_npz`` / ``load_params_npz`` read and write the JAX package's
flat ``.npz`` of the flax params tree (keys are ``jax.tree_util.keystr``
paths such as ``['backbone']['stem1']['conv']['kernel']``, arrays in its
layouts): a model trained by either package can be fine-tuned or served by
the other. A model with trainable BatchNorm (finetune_dla) keeps its running
statistics in ``batch_stats.npz`` beside the params file, in the same
layout, as the JAX package's train command does.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..pipelines.train_step import TrainState
from .params import from_jax_params, to_jax_batch_stats, to_jax_params

_CKPT = re.compile(r"^step_(\d+)\.pt$")
_KEY = re.compile(r"\['([^']*)'\]")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def save_checkpoint(directory: str, state: TrainState, step: Optional[int] = None, max_to_keep: int = 5) -> str:
    """Write the state at `step` (default state.step) and drop all but the
    newest `max_to_keep` checkpoints. Returns the file's path."""
    step = state.step if step is None else step
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step, "generator": state.generator.get_state()}, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def resume_or_load(directory: str, state: TrainState) -> TrainState:
    """Restore the newest checkpoint of `directory` into `state` (in place,
    onto the state's device); without one the state is left as it is. The
    weights, the momentum buffers the state already has and the generator
    keep their tensors, which a captured train step reads (a buffer the
    checkpoint lacks is zeroed, as an update treats a missing one)."""
    step = latest_step(directory)
    if step is None:
        return state
    ckpt = torch.load(_path(directory, step), map_location=state.device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    opt = state.optimizer
    held = {p: opt.state[p].get("momentum_buffer") for g in opt.param_groups for p in g["params"]}
    opt.load_state_dict(ckpt["optimizer"])
    for p, buf in held.items():
        if buf is not None:
            new = opt.state[p].get("momentum_buffer")
            if new is None:
                buf.zero_()
            else:
                buf.copy_(new)
            opt.state[p]["momentum_buffer"] = buf
    state.generator.set_state(ckpt["generator"].cpu())
    state.step = int(ckpt["step"])
    return state


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: v})
    return out


BATCH_STATS_NPZ = "batch_stats.npz"


def batch_stats_path(params_path: str) -> str:
    """Where the running statistics of a params file are: beside it."""
    return os.path.join(os.path.dirname(params_path), BATCH_STATS_NPZ)


def save_params_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a state_dict as the JAX package's flat params .npz, and its
    running statistics, if it has any, as ``batch_stats.npz`` beside it."""
    np.savez(path, **_flatten(to_jax_params(state_dict)))
    stats = to_jax_batch_stats(state_dict)
    if stats is not None:
        np.savez(batch_stats_path(path), **_flatten(stats))


def load_params_npz(path: str, batch_stats: bool = False) -> Dict[str, torch.Tensor]:
    """Read the JAX package's params .npz (its ``model_final.npz``, or this
    module's) -> the port's state_dict (f32 CPU tensors). batch_stats=True
    adds the running statistics of ``batch_stats.npz`` beside it, when that
    file exists."""
    sd = from_jax_params(_read_tree(path))
    stats = batch_stats_path(path)
    if batch_stats and os.path.exists(stats):
        sd.update(from_jax_params({}, _read_tree(stats)))
    return sd


def _read_tree(path: str) -> Dict:
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = _KEY.findall(key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"{path}: key {key!r} is not a params path")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree
