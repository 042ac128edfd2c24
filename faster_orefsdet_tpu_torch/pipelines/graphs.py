"""CUDA-graph replays of a request: the port's counterpart of ``jax.jit``
for the serving builders (``PinnedFn``). Each pinned builder gives it a
closure over its model family's request body, directly (raw frames) or
through ``inference.PinnedImagesFn`` (one image or a batch).

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
happens outside the graph. The body is then captured ``CAPTURES`` times:
the graph that serves, and its timed twin, the same body with the stage
spans (``utils.profiling.GraphSpans``): stamps of the card's clock
(``ops.stamp_cuda``) at both ends of the whole body and at the end of each
``profiling.stage`` in it. The twin shares the graph's memory pool and
replays in its place while spans are on, so a call with spans off runs no
stamp. A timed replay is harvested into ``profiling.stage_samples()``
before the twin's next replay. The kernel wrappers' launch counters
(``ops._native.LAUNCH_COUNTERS``) advance when a call is captured, not when
it is replayed: ``kernel_launches`` is each signature's captured launches
times its replays. While a profiler records, a call opens the host ranges
``pinned.copy_in``, ``pinned.launch`` and ``pinned.clone``
(``pinned.capture`` around a capture). A function counts its ``calls``,
``captures`` (signatures captured) and ``evictions`` (signatures dropped by
the least-recently-used rule); each signature its ``replays``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from ..ops import _native, stamp_cuda
from ..utils import profiling

MAX_GRAPHS = 4  # captured signatures kept by one pinned function (least recently used goes)
WARMUP_CALLS = 2
CAPTURES = 2  # of each signature: the graph and its timed twin


class _Graph:
    """One captured signature: the graph and its timed twin, their static
    input buffers (shared) and outputs, the kernel launches captured into
    one of them, the twin's stage spans and how often either was replayed."""

    def __init__(self, graph, timed, inputs: Tuple[torch.Tensor, ...], out, timed_out, launches: Dict[str, int],
                 spans: profiling.GraphSpans):
        self.graph, self.timed, self.inputs, self.out, self.timed_out = graph, timed, inputs, out, timed_out
        self.launches = launches
        self.spans = spans
        self.replays = 0


def _signature(key: tuple) -> str:
    return ", ".join(f"{str(dtype).replace('torch.', '')}{list(shape)}" for shape, dtype in key)


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
        self.calls = self.captures = self.evictions = 0

    def __call__(self, *inputs: torch.Tensor):
        self.calls += 1
        if self.device.type != "cuda":
            return self.run(*(x.to(self.device).contiguous() for x in inputs))
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        host = profiling.profiler_recording()
        timed = host or profiling.spans_forced()
        # a graph replays on the stream of the card it was captured on
        with torch.cuda.device(self.device):
            g = self._graph(key, inputs, host, timed)
            with profiling.host_range("pinned.launch", host):
                (g.timed if timed else g.graph).replay()
            g.replays += 1
            if timed:
                g.spans.launched(self.calls)
            # the next replay overwrites the outputs (the two graphs share memory)
            with profiling.host_range("pinned.clone", host):
                return _clone(g.timed_out if timed else g.out)

    def _graph(self, key: tuple, inputs, host: bool, timed: bool) -> _Graph:
        """The graphs of `key` with `inputs` in their static buffers:
        captured (the least recently used dropped past MAX_GRAPHS), or found,
        the twin's last replay harvested if it has ended, and counted as
        missed if not and a `timed` replay would overwrite its stamps."""
        g = self.graphs.get(key)
        if g is None:
            with profiling.host_range("pinned.capture", host):
                g = self._capture(key, inputs)
            self.captures += 1
            if len(self.graphs) >= MAX_GRAPHS:
                _, dropped = self.graphs.popitem(last=False)
                dropped.spans.collect(overwrite=True)
                self.evictions += 1
            self.graphs[key] = g
            return g
        self.graphs.move_to_end(key)
        g.spans.collect(overwrite=timed)
        with profiling.host_range("pinned.copy_in", host):
            for buf, x in zip(g.inputs, inputs):
                buf.copy_(x, non_blocking=True)
        return g

    def _capture(self, key: tuple, inputs) -> _Graph:
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
            spans = profiling.GraphSpans(f"cuda:{torch.cuda.current_device()}", _signature(key),
                                         stamp_cuda.StampClock(self.device))
        current.wait_stream(side)
        before = _native.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads may call the CUDA runtime meanwhile (the
        # async predictor's producer pins host memory, its readback workers
        # wait on events), which a global-mode capture counts as its error
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = self.run(*static)
        launches = _native.launches_since(before)
        # the timed twin, in the graph's pool: the two replay in turn on one
        # stream and each call clones its outputs before the next replay
        timed = torch.cuda.CUDAGraph()
        with torch.cuda.graph(timed, pool=graph.pool(), stream=side, capture_error_mode="thread_local"), \
                spans.capturing():
            timed_out = self.run(*static)
        return _Graph(graph, timed, static, out, timed_out, launches, spans)

    def kernel_launches(self) -> Dict[str, int]:
        """The kernel launches made by replays: each signature's captured
        launches times its replays."""
        return {name: sum(g.launches[name] * g.replays for g in self.graphs.values())
                for name in _native.LAUNCH_COUNTERS}
