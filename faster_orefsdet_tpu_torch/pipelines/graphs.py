"""CUDA-graph replays of a request: the port's counterpart of ``jax.jit``
for the serving builders (``PinnedFn``).

A request body ``run(*inputs)`` that copies nothing from the host and never
waits for the device is captured once per input signature (the shapes and
dtypes of its inputs) into a CUDA graph with static input buffers; later
calls copy their inputs into those buffers and replay the graph. Whatever
the body reads besides its inputs (weights, support-cache taps, build-time
constants) is read by address, so it must live as long as the function:
the builders make it at build time and hold it.

Before a capture the body runs ``WARMUP_CALLS`` times on a side stream at
the exact shapes, so that everything done once per shape (the kernels'
build and shared-memory opt-in, cuDNN's algorithm choice, device constants)
happens outside the graph. The kernel wrappers' launch counters advance
when a call is captured, not when it is replayed: ``kernel_launches`` is
each graph's captured launches times its replays.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from ..ops import cgm_cuda, nms_cuda

MAX_GRAPHS = 4  # captured signatures kept by one pinned function (least recently used goes)
WARMUP_CALLS = 2


class _Graph:
    """One captured call: the graph, its static input buffers and outputs,
    the kernel launches captured into it and how often it was replayed."""

    def __init__(self, graph, inputs: Tuple[torch.Tensor, ...], out, launches: Dict[str, int]):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.launches = launches
        self.replays = 0


def _clone(out):
    """A fresh copy of a graph's output (a tensor or a tuple of tensors, a
    NamedTuple kept as its type), enqueued on the current stream."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    clones = (t.clone() for t in out)
    return out._make(clones) if hasattr(out, "_make") else type(out)(clones)


class PinnedFn:
    """fn(*inputs) -> run(*inputs), on CUDA replayed from one CUDA graph per
    input signature, on the CPU run eagerly.

    `run` takes tensors on `device` and returns a tensor or a tuple of
    tensors. Inputs may lie anywhere: they are copied into the graph's
    static buffers with ``non_blocking`` (asynchronous from pinned host
    memory or another card). Each call returns a fresh copy of the outputs,
    so results held from earlier calls stay intact. A capture that fails
    raises; nothing falls back to the eager path."""

    def __init__(self, run: Callable, device):
        self.run = run
        self.device = torch.device(device)
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()

    def __call__(self, *inputs: torch.Tensor):
        if self.device.type != "cuda":
            return self.run(*(x.to(self.device).contiguous() for x in inputs))
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        # a graph replays on the stream of the card it was captured on
        with torch.cuda.device(self.device):
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(inputs)
                if len(self.graphs) >= MAX_GRAPHS:
                    self.graphs.popitem(last=False)
                self.graphs[key] = g
            else:
                self.graphs.move_to_end(key)
                for buf, x in zip(g.inputs, inputs):
                    buf.copy_(x, non_blocking=True)
            g.graph.replay()
            g.replays += 1
            # the next replay overwrites g.out
            return _clone(g.out)

    def _capture(self, inputs) -> _Graph:
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in inputs)
        for buf, x in zip(static, inputs):
            buf.copy_(x)
        # warm up on a side stream, then capture on it: a stream of this
        # card (torch.cuda.graph's default capture stream is one process-wide
        # stream of whichever card made it first)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.run(*static)
        current.wait_stream(side)
        before = (cgm_cuda.counter.launches, nms_cuda.counter.launches)
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads may call the CUDA runtime meanwhile (the
        # async predictor's producer pins host memory, its readback workers
        # wait on events), which a global-mode capture counts as its error
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = self.run(*static)
        launches = {"cgm": cgm_cuda.counter.launches - before[0], "nms": nms_cuda.counter.launches - before[1]}
        return _Graph(graph, static, out, launches)

    def kernel_launches(self) -> Dict[str, int]:
        """The kernel launches made by replays: each graph's captured launches
        times its replays."""
        return {name: sum(g.launches[name] * g.replays for g in self.graphs.values()) for name in ("cgm", "nms")}
