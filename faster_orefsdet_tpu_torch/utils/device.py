"""Device selection for the port's entry points, and constant tensors kept
on a device."""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU. Raises when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def device_constant(fn=None, *, maxsize=None):
    """Memoise `fn(*args) -> np.ndarray` as a tensor on `device` (a keyword
    argument, default the CPU), one tensor per (args, device). A request
    then copies nothing from the host, which a CUDA graph could not capture.

    By default every tensor is kept for the life of the process: a captured
    graph reads it by address, so it must never be freed. `maxsize` keeps
    only that many, the least recently used going first; it is for values
    that vary with the data and never enter a captured graph.

    The tensor is shared by every caller and must not be modified in place.
    It is made outside inference mode, so that autograd may save it."""
    if fn is None:
        return functools.partial(device_constant, maxsize=maxsize)

    @functools.lru_cache(maxsize=maxsize)
    def cached(args, device: torch.device) -> torch.Tensor:
        with torch.inference_mode(False):
            return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)

    @functools.wraps(fn)
    def wrapper(*args, device=None) -> torch.Tensor:
        return cached(args, torch.device("cpu" if device is None else device))

    return wrapper
