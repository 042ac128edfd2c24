"""Episodic dataset mapper: query transforms and K-shot support sampling
(counterpart of ``faster_orefsdet_tpu/data/mapper.py``).

For each per-(image, class) query record, sample way x shot support crops
of the query's class, excluding the query image and never reusing an
annotation or an image, seeded by the query's first annotation id. The
query gets a multi-scale shortest-edge resize and a random flip, drawn from
the caller's np.random.Generator in the JAX package's order.

The mapper emits raw uint8 canvases, zero-padded; normalization runs on the
device (``pipelines/train_step.prepare_batch``). Images are read by an
`imread(path) -> [H, W, 3] uint8 BGR array` callable (cv2's by default,
imported only when called) and resized by PyTorch on the host. Decoded
images, rendered canvases and the per-record support stacks (a pure
function of the record) are cached up to `cache_bytes`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..pipelines.preprocess import ceil_to, pad_to_canvas, resize_image_host, resize_shortest_edge_size
from .coco import ImageRecord, SupportEntry
from .loader import Imread, cv2_imread


class SupportSampler:
    """Deterministic support sampling over the support index."""

    def __init__(self, entries: Sequence[SupportEntry]):
        self.entries = list(entries)
        self.by_class: Dict[int, List[SupportEntry]] = {}
        for e in self.entries:
            self.by_class.setdefault(e.category_id, []).append(e)
        for v in self.by_class.values():  # a stable order, for determinism
            v.sort(key=lambda e: e.id)

    def classes(self) -> List[int]:
        return sorted(self.by_class)

    def sample(self, query_class: int, query_image_id: int, used_ann_ids: Sequence[int], way: int, shot: int,
               seed: int) -> List[SupportEntry]:
        """way*shot entries: `shot` of the query class first (the positive
        way), then `shot` of each other sampled class. The query image and
        every used annotation and image are excluded, relaxed in turn on a
        pool too small for it."""
        rng = np.random.default_rng(seed)
        used_imgs = {query_image_id}
        used_ids = set(used_ann_ids)
        used_classes = {query_class}
        out: List[SupportEntry] = []

        def draw(cls):
            pool = [e for e in self.by_class.get(cls, []) if e.image_id not in used_imgs and e.id not in used_ids]
            if not pool:
                pool = [e for e in self.by_class.get(cls, []) if e.id not in used_ids]
            if not pool:
                pool = self.by_class[cls]
            e = pool[rng.integers(len(pool))]
            used_imgs.add(e.image_id)
            used_ids.add(e.id)
            return e

        for _ in range(shot):
            out.append(draw(query_class))
        for _ in range(way - 1):
            candidates = [c for c in self.by_class if c not in used_classes]
            if not candidates:
                break
            other = candidates[int(rng.integers(len(candidates)))]
            used_classes.add(other)
            for _ in range(shot):
                out.append(draw(other))
        return out


class _ByteBudgetCache:
    """Insertion-order (FIFO) byte-budgeted cache of numpy arrays or tuples."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._data: Dict = {}
        self._bytes = 0

    @staticmethod
    def _nbytes(value) -> int:
        if isinstance(value, np.ndarray):
            return value.nbytes
        return sum(v.nbytes for v in value if isinstance(v, np.ndarray))

    def get(self, key):
        return self._data.get(key)

    def put(self, key, value):
        if key in self._data:
            return
        n = self._nbytes(value)
        if n > self.max_bytes:
            return
        while self._bytes + n > self.max_bytes and self._data:
            old = self._data.pop(next(iter(self._data)))
            self._bytes -= self._nbytes(old)
        self._data[key] = value
        self._bytes += n


@dataclasses.dataclass
class MappedExample:
    """Fixed-shape numpy arrays of one training example."""

    image: np.ndarray  # [Hc, Wc, 3] raw uint8, zero-padded
    image_hw: Tuple[int, int]
    gt_boxes: np.ndarray  # [N, 4]
    gt_classes: np.ndarray  # [N]
    gt_valid: np.ndarray  # [N]
    support_images: np.ndarray  # [S, hs, ws, 3] raw uint8, zero-padded
    support_boxes: np.ndarray  # [S, 4]
    support_classes: np.ndarray  # [S] 0 = the positive way
    # stable identities of the support stack and the query canvas (file,
    # scale, flip): the loader keeps recurring ones on the device
    support_key: Optional[Tuple[int, int]] = None
    image_key: Optional[Tuple] = None


class EpisodicMapper:
    """record, np.random.Generator -> MappedExample, for training."""

    def __init__(self, cfg: Config, sampler: SupportSampler, canvas_hw: Optional[Tuple[int, int]] = None,
                 cache_bytes: int = 1 << 30, *, imread: Optional[Imread] = None):
        self.cfg = cfg
        self.sampler = sampler
        self.imread = imread or cv2_imread
        self._img_cache = _ByteBudgetCache(cache_bytes)
        self._sup_cache = _ByteBudgetCache(cache_bytes // 2)
        self._canvas_cache = _ByteBudgetCache(cache_bytes // 2)
        inp = cfg.input
        if canvas_hw is None:
            # the worst case of the config: short side up to max(min_size_train),
            # long side up to max_size_train (train_canvas gives a tighter one)
            d = inp.size_divisibility
            canvas_hw = (ceil_to(max(inp.min_size_train), d), ceil_to(inp.max_size_train, d))
        self.canvas_hw = canvas_hw
        cs = cfg.fs.support_crop_size
        self.support_canvas = (ceil_to(cs), ceil_to(cs))  # 240 -> 256

    def _read(self, path: str) -> np.ndarray:
        img = self._img_cache.get(path)
        if img is None:
            img = self.imread(path)
            if img is None:
                raise FileNotFoundError(f"image {path} could not be read")
            self._img_cache.put(path, img)
        return img

    def __call__(self, record: ImageRecord, rng: np.random.Generator) -> MappedExample:
        cfg = self.cfg
        img = self._read(record.file_name)
        h, w = img.shape[:2]
        short = int(rng.choice(cfg.input.min_size_train))
        newh, neww = resize_shortest_edge_size(h, w, short, cfg.input.max_size_train)

        boxes = np.asarray([a.bbox for a in record.annotations], np.float32).reshape(-1, 4)
        boxes = boxes * np.asarray([neww / w, newh / h, neww / w, newh / h], np.float32)
        flip = cfg.input.random_flip and rng.uniform() < 0.5
        if flip:
            boxes = np.stack([neww - boxes[:, 2], boxes[:, 1], neww - boxes[:, 0], boxes[:, 3]], axis=1)

        # the canvas is a pure function of (file, scale, flip)
        image_key = (record.file_name, short, flip)
        canvas = self._canvas_cache.get(image_key)
        if canvas is None:
            resized = resize_image_host(np.ascontiguousarray(img, np.uint8), newh, neww)
            if flip:
                resized = resized[:, ::-1]
            # the canvas follows the image's orientation; the loader groups batches by it
            ch, cw = self.canvas_hw
            canvas = pad_to_canvas(np.ascontiguousarray(resized), (ch, cw) if neww >= newh else (cw, ch))
            canvas.flags.writeable = False  # shared by every example of this key
            self._canvas_cache.put(image_key, canvas)

        n_max = cfg.static.max_gt_per_image
        gt_boxes = np.zeros((n_max, 4), np.float32)
        gt_valid = np.zeros((n_max,), bool)
        n = min(len(boxes), n_max)
        gt_boxes[:n] = boxes[:n]
        gt_valid[:n] = True

        # supports, seeded by the first annotation id: the stack caches exactly
        sup_key = (record.image_id, record.annotations[0].id if record.annotations else -1)
        cached = self._sup_cache.get(sup_key)
        if cached is not None:
            sup_imgs, sup_boxes, sup_classes = cached
        else:
            sup_imgs, sup_boxes, sup_classes = self._support_stack(record)
            self._sup_cache.put(sup_key, (sup_imgs, sup_boxes, sup_classes))
        return MappedExample(
            image=canvas, image_hw=(newh, neww), gt_boxes=gt_boxes, gt_classes=np.zeros((n_max,), np.int32),
            gt_valid=gt_valid, support_images=sup_imgs, support_boxes=sup_boxes, support_classes=sup_classes,
            support_key=sup_key, image_key=image_key,
        )

    def _support_stack(self, record: ImageRecord):
        cfg = self.cfg
        way, shot = cfg.fs.support_way, cfg.fs.support_shot
        anns = record.annotations
        entries = self.sampler.sample(anns[0].category_id if anns else 0, record.image_id, [a.id for a in anns],
                                      way, shot, anns[0].id if anns else record.image_id)
        s = way * shot
        cs = cfg.fs.support_crop_size
        sup_imgs = np.zeros((s, *self.support_canvas, 3), np.uint8)
        sup_boxes = np.zeros((s, 4), np.float32)
        sup_classes = np.zeros((s,), np.int32)
        for i, e in enumerate(entries[:s]):
            crop = self._read(e.file_path)
            if crop.shape[:2] != (cs, cs):
                crop = resize_image_host(np.ascontiguousarray(crop, np.uint8), cs, cs)
            sup_imgs[i, :cs, :cs] = crop
            sup_boxes[i] = e.support_box
            sup_classes[i] = 0 if i < shot else 1
        return sup_imgs, sup_boxes, sup_classes
