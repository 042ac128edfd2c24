"""Asynchronous predictor: host preprocessing overlapped with the card's work
(counterpart of ``faster_orefsdet_tpu/pipelines/async_predictor.py``).

A background thread preprocesses frames on the host and stages each canvas
in pinned memory; the caller's thread submits each one to a pinned
inference function (one CUDA-graph replay per frame) and keeps up to
`depth` of them in flight before it reads the oldest back. Each result's
copy to the host is enqueued right after its replay and waited on alone,
on the caller's thread or, with `readback_workers`, on a thread pool.
Results come back in input order, in frame coordinates.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from .inference import build_pinned_inference_fn
from .preprocess import frame_geometry, preprocess_host
from .support_cache import SupportCache

_POLL_S = 0.1


class AsyncPredictor:
    def __init__(self, cfg: Config, params: Mapping[str, torch.Tensor], cache: SupportCache,
                 depth: int = 3, canvas_hw: Optional[Tuple[int, int]] = None, readback_workers: int = 0,
                 *, device="cuda", act_scales: Optional[Mapping[str, float]] = None):
        """The weights, the cache and the calibrated scales (act_scales=, as
        the builders take them) are fixed into the pinned function here:
        build a new predictor to serve others. canvas_hw=None gives each
        frame its own ceil-to-divisibility canvas (one captured graph per
        canvas shape)."""
        if depth < 1:
            raise ValueError(f"depth={depth}: at least one request must be in flight")
        self.cfg = cfg
        self._pinned = build_pinned_inference_fn(cfg, params, cache, device=device, packed=True,
                                                 act_scales=act_scales)
        self.depth = depth
        self.canvas_hw = canvas_hw
        self.readback_workers = readback_workers

    def _prep(self, img: np.ndarray):
        inp = self.cfg.input
        canvas_hw = self.canvas_hw or frame_geometry(*img.shape[:2], inp).canvas_hw
        canvas, (nh, nw), scale = preprocess_host(img, inp.min_size_test, inp.max_size_test, canvas_hw,
                                                  inp.pixel_mean, inp.pixel_std)
        hw = torch.tensor([float(nh), float(nw)])
        if self._pinned.device.type == "cuda":
            # one copy that also lays the [H, W, 3]-ordered canvas out as
            # [3, H, W], so that the copy to the card is a single DMA
            staged = torch.empty(canvas.shape, dtype=canvas.dtype, pin_memory=True)
            canvas, hw = staged.copy_(canvas), hw.pin_memory()
        return canvas, hw, scale

    def _submit(self, canvas: torch.Tensor, hw: torch.Tensor, scale):
        """One replay, then its result's copy to pinned host memory and an
        event behind it, all enqueued without waiting."""
        packed = self._pinned(canvas, hw)
        if packed.device.type != "cuda":
            return packed, None, scale
        host = packed.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, scale

    @staticmethod
    def _read(host: torch.Tensor, done: Optional[torch.cuda.Event], scale) -> dict:
        if done is not None:
            done.synchronize()
        arr = host.numpy()
        valid = arr[:, 6] > 0.5
        sy, sx = scale
        return {"boxes": arr[valid, :4] * np.asarray([sx, sy, sx, sy]), "scores": arr[valid, 4]}

    def run(self, images: Iterable[np.ndarray]) -> Iterator[dict]:
        """Yields {'boxes', 'scores'} per [H, W, 3] frame (frame coordinates,
        valid detections only), in input order."""
        prep_q: Queue = Queue(maxsize=self.depth)
        stop = threading.Event()
        done_marker = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    prep_q.put(item, timeout=_POLL_S)
                    return True
                except Full:
                    continue
            return False

        def producer():
            try:
                for img in images:
                    if not put(self._prep(img)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(done_marker)

        thread = threading.Thread(target=producer, name="AsyncPredictor-producer", daemon=True)
        thread.start()
        pool = ThreadPoolExecutor(max_workers=self.readback_workers) if self.readback_workers > 0 else None

        def read(item):
            return item.result() if pool else self._read(*item)

        in_flight: deque = deque()
        try:
            while True:
                item = prep_q.get()
                if item is done_marker:
                    break
                if isinstance(item, Exception):
                    raise item
                submitted = self._submit(*item)
                in_flight.append(pool.submit(self._read, *submitted) if pool else submitted)
                if len(in_flight) >= self.depth:
                    yield read(in_flight.popleft())
            while in_flight:
                yield read(in_flight.popleft())
        finally:
            stop.set()
            while True:  # let a blocked producer see the stop
                try:
                    prep_q.get_nowait()
                except Empty:
                    break
            thread.join()
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)
