"""Devices and process groups for data parallelism (counterpart of
``faster_orefsdet_tpu/parallel/mesh.py``).

The reference's only parallelism is DDP over NCCL, one process per card.
The JAX package runs one controller over a device mesh; the port follows
torch's idiom, path by path:

- training needs collectives, so it runs one process per rank with
  ``torch.distributed`` (``spawn_ranks``, ``init_distributed``): NCCL for
  CUDA tensors, gloo for CPU tensors, and gloo on CUDA tensors where ranks
  share a card (NCCL refuses two ranks on one card);
- serving and evaluation need none, so they stay in one process over a
  ``Mesh``: a replica of the model on each of its devices.

Torch has one CPU device, so a CPU mesh of N is N replicas on the host: the
counterpart of the JAX package's virtual CPU devices, for tests. A CUDA
mesh never repeats a card.
"""

from __future__ import annotations

import dataclasses
import pickle
import queue
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices that serving and evaluation shard their batch over."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_devices: int = 0, device="cuda") -> Mesh:
    """The first `num_devices` visible cards (0: every one), or with
    device="cpu" `num_devices` replicas on the host (0: one). Asking for
    more cards than are visible raises."""
    if num_devices < 0:
        raise ValueError(f"make_mesh: num_devices={num_devices} (0 means every visible card)")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * max(num_devices, 1))
    visible = torch.cuda.device_count()
    if num_devices > visible:
        raise ValueError(
            f"make_mesh: requested a {num_devices}-device mesh but only {visible} card(s) are visible. "
            "Refusing to silently truncate — run on a machine with enough cards, or pass device='cpu' "
            "for replicas on the host."
        )
    return Mesh(tuple(torch.device("cuda", i) for i in range(num_devices or visible)))


def init_distributed(rank: int, world_size: int, init_method: str, backend: Optional[str] = None,
                     device="cuda") -> None:
    """Join the process group of `world_size` ranks as `rank` (the
    reference's dist.init_process_group('NCCL')). The backend defaults to
    NCCL for a CUDA device and gloo for the CPU; pass "gloo" for ranks that
    share a card. A card with an index becomes the process's current one.
    Does nothing at world size 1."""
    if world_size <= 1:
        return
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init_method,
                            rank=rank, world_size=world_size)


def rank_and_world() -> Tuple[int, int]:
    """This process's rank and the group's size: (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str, device, backend: Optional[str],
               results, args: Sequence) -> None:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # N ranks on the host's cores, not N full thread pools
    init_distributed(rank, world_size, init_method, backend, dev)
    try:
        out = fn(rank, world_size, dev, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, pickle.dumps(out)))  # by value: tensors do not wait on this process


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), *, init_method: str, device="cuda",
                backend: Optional[str] = None, timeout: Optional[float] = None) -> List[Any]:
    """Run fn(rank, world_size, device, *args) in `world_size` new processes
    (spawned: CUDA is not fork-safe), each in the process group first, and
    return what each returned, by rank. `fn` is a module-level function;
    `device` is "cuda" (rank r on cuda:r), one card for every rank (with
    backend="gloo") or "cpu" (each rank on one thread). A rank that raises
    stops the others and its error is raised here; so is a run longer than
    `timeout` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(fn, world_size, init_method, str(device), backend, results,
                                                 tuple(args)),
                               nprocs=world_size, join=False, start_method="spawn")
    out = {}
    deadline = None if timeout is None else time.monotonic() + timeout

    def drain():  # before joining: a rank's exit waits until its result is read
        while True:
            try:
                rank, blob = results.get_nowait()
            except queue.Empty:
                return
            out[rank] = pickle.loads(blob)  # written by the ranks above

    try:
        while not procs.join(timeout=0.1):
            drain()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: {world_size} ranks still running after {timeout} s")
        while len(out) < world_size:
            rank, blob = results.get(timeout=10)
            out[rank] = pickle.loads(blob)
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [out[r] for r in range(world_size)]
