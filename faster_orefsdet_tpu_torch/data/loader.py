"""Training and eval loaders (counterpart of
``faster_orefsdet_tpu/data/loader.py``).

Train: an endless shuffled stream of episodic batches (TrainingSampler
semantics) mapped on a background thread, grouped by canvas shape
(landscape or portrait, as d2's AspectRatioGroupedDataset) and put on the
device. Eval: one pass over the records, batch 1, each image preprocessed on
the host onto a shared canvas.

Images are read by an `imread(path) -> [H, W, 3] uint8 array or None`
callable. The default is cv2's, imported only when it is called; a machine
without cv2 passes its own (a decoder, or frames held in memory).
"""

from __future__ import annotations

import queue
import threading
from typing import TYPE_CHECKING, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..pipelines.preprocess import (
    ceil_to,
    frame_geometry,
    pad_to_canvas,
    preprocess_host,
    resize_image_host,
    resize_shortest_edge_size,
)
from ..pipelines.train_step import TrainBatch
from ..utils.device import resolve_device
from .coco import ImageRecord

if TYPE_CHECKING:
    from .mapper import EpisodicMapper, MappedExample

Imread = Callable[[str], Optional[np.ndarray]]


def cv2_imread(path: str) -> Optional[np.ndarray]:
    """cv2.imread (BGR uint8), the JAX package's decoder."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading images needs cv2, which is not installed: pass imread=, a callable "
                          "from a path to an [H, W, 3] uint8 BGR array") from e
    return cv2.imread(path)


def eval_loader(records: Sequence[ImageRecord], cfg: Config, canvas_hw: Optional[Tuple[int, int]] = None,
                raw_uint8: bool = False, *, imread: Optional[Imread] = None
                ) -> Iterator[Tuple[ImageRecord, torch.Tensor, Tuple[int, int], Tuple[float, float]]]:
    """Yields (record, canvas [3, Hc, Wc] CPU tensor, (newh, neww), scale_hw)
    per readable record: f32 normalized canvases, or with raw_uint8 the
    resized uint8 canvases that the batched path normalizes on the device.
    canvas_hw=None gives each image its own ceil-to-divisibility canvas."""
    imread = imread or cv2_imread
    inp = cfg.input
    for rec in records:
        img = imread(rec.file_name)
        if img is None:
            continue
        geo = frame_geometry(*img.shape[:2], inp)
        chw = canvas_hw or geo.canvas_hw
        if raw_uint8:
            resized = resize_image_host(np.ascontiguousarray(img, np.uint8), *geo.resized_hw)
            canvas = torch.from_numpy(pad_to_canvas(resized, chw)).permute(2, 0, 1)
            yield rec, canvas, geo.resized_hw, geo.scale_hw
            continue
        canvas, hw, scale = preprocess_host(img, inp.min_size_test, inp.max_size_test, chw,
                                            inp.pixel_mean, inp.pixel_std)
        yield rec, canvas, hw, scale


DEVICE_MEMO_MAX = 256  # recurring support stacks / canvases a loader keeps on the device, each


def _device_memo(examples, key_attr: str, val_attr: str, cache: Dict, device) -> torch.Tensor:
    """The examples' arrays stacked on `device` through a bounded
    {key: device tensor} memo (the oldest entry goes first)."""
    arrs = []
    for e in examples:
        key = getattr(e, key_attr)
        arr = cache.get(key)
        if arr is None:
            if len(cache) >= DEVICE_MEMO_MAX:
                cache.pop(next(iter(cache)))
            # a copy: the mapper's arrays are read-only
            arr = torch.from_numpy(np.array(getattr(e, val_attr))).to(device)
            cache[key] = arr
        arrs.append(arr)
    return torch.stack(arrs)


def collate(examples: Sequence["MappedExample"], device="cuda", device_sup_cache: Optional[Dict] = None,
            device_img_cache: Optional[Dict] = None) -> TrainBatch:
    """Stack mapped examples into a TrainBatch on `device` (raw uint8 images,
    normalized by the train step). The optional memos keep recurring support
    stacks (keyed by support_key) and query canvases (by image_key) on the
    device, so an epoch after the first uploads neither again."""
    dev = resolve_device(device)

    def stacked(key_attr, val_attr, cache):
        if cache is not None and all(getattr(e, key_attr) is not None for e in examples):
            return _device_memo(examples, key_attr, val_attr, cache, dev)
        return torch.from_numpy(np.stack([getattr(e, val_attr) for e in examples])).to(dev)

    def host(attr, dtype):
        return torch.from_numpy(np.asarray(np.stack([getattr(e, attr) for e in examples]), dtype)).to(dev)

    images = stacked("image_key", "image", device_img_cache)
    support = stacked("support_key", "support_images", device_sup_cache)
    return TrainBatch(
        images=images.permute(0, 3, 1, 2),  # NHWC memory: a channels-last NCHW view
        image_hw=torch.tensor([list(e.image_hw) for e in examples], dtype=torch.float32).to(dev),
        gt_boxes=host("gt_boxes", np.float32),
        gt_classes=host("gt_classes", np.int32),
        gt_valid=host("gt_valid", bool),
        support_images=support.permute(0, 1, 4, 2, 3),
        support_boxes=host("support_boxes", np.float32),
    )


class TrainLoader:
    """Endless shuffled episodic batches (see ``train_loader``); ``close()``
    stops its thread."""

    def __init__(self, records: Sequence[ImageRecord], mapper: "EpisodicMapper", batch_size: int, seed: int = 0,
                 prefetch: int = 4, device="cuda"):
        self.records, self.mapper, self.batch_size = list(records), mapper, batch_size
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        dev_sup: Dict = {}
        dev_img: Dict = {}
        buckets: Dict = {}
        try:
            while not self._stop.is_set():
                for i in self.rng.permutation(len(self.records)):
                    ex = self.mapper(self.records[int(i)], self.rng)
                    key = ex.image.shape[:2]
                    buckets.setdefault(key, []).append(ex)
                    if len(buckets[key]) == self.batch_size:
                        batch = collate(buckets.pop(key), self.device, device_sup_cache=dev_sup,
                                        device_img_cache=dev_img)
                        if not self._put(batch):
                            return
        except Exception as e:  # handed to the consumer, raised by __next__
            self._put(e)

    def __iter__(self) -> "TrainLoader":
        return self

    def __next__(self) -> TrainBatch:
        item = self._queue.get()
        if isinstance(item, Exception):
            self.close()
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


def train_loader(records: Sequence[ImageRecord], mapper: "EpisodicMapper", batch_size: int, seed: int = 0,
                 prefetch: int = 4, *, device="cuda") -> TrainLoader:
    """An endless shuffled episodic stream of TrainBatch on `device` (the
    card unless the caller asks for the CPU): the records in a new random
    order each epoch, mapped on a background thread with the loader's own
    np.random.Generator (seeded with `seed`), grouped into batches of one
    canvas shape, `prefetch` batches ahead."""
    return TrainLoader(records, mapper, batch_size, seed, prefetch, device)


def train_canvas(records: Sequence[ImageRecord], cfg: Config) -> Tuple[int, int]:
    """The tight worst-case training canvas (short side, long side) over the
    records at every train scale, each rounded up to the size divisibility."""
    d = cfg.input.size_divisibility
    ms, ml = d, d
    for rec in records:
        for short in cfg.input.min_size_train:
            nh, nw = resize_shortest_edge_size(rec.height, rec.width, short, cfg.input.max_size_train)
            ms, ml = max(ms, min(nh, nw)), max(ml, max(nh, nw))
    return (ceil_to(ms, d), ceil_to(ml, d))


def eval_canvas(records: Sequence[ImageRecord], cfg: Config) -> Tuple[int, int]:
    """One canvas covering every eval image at test scale."""
    d = cfg.input.size_divisibility
    mh = mw = d
    for rec in records:
        nh, nw = resize_shortest_edge_size(rec.height, rec.width, cfg.input.min_size_test,
                                           cfg.input.max_size_test)
        mh, mw = max(mh, nh), max(mw, nw)
    return (ceil_to(mh, d), ceil_to(mw, d))
