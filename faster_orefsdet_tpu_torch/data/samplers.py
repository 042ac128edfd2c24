"""Samplers and an augmentation of the CenterNet2 data stack (counterpart
of ``faster_orefsdet_tpu/data/samplers.py``), numpy as there: the same seed
gives the same index stream. Not used by the ore pipeline.

  ClassAwareSampler        infinite stream balancing classes by inverse
                           square-root frequency.
  MultiDatasetSampler      mixes several datasets at fixed ratios.
  efficientdet_resize_crop random scale jitter + a square crop.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .coco import ImageRecord


class ClassAwareSampler:
    """Infinite index stream; each draw picks a class (inverse-sqrt-frequency
    weighted), then a random image containing it."""

    def __init__(self, records: Sequence[ImageRecord], seed: int = 0):
        self.by_class: Dict[int, List[int]] = {}
        for i, r in enumerate(records):
            for a in r.annotations:
                pool = self.by_class.setdefault(a.category_id, [])
                if not pool or pool[-1] != i:
                    pool.append(i)
        self.classes = sorted(self.by_class)
        counts = np.asarray([len(self.by_class[c]) for c in self.classes], np.float64)
        w = 1.0 / np.sqrt(counts)
        self.probs = w / w.sum()
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        while True:
            c = self.classes[self.rng.choice(len(self.classes), p=self.probs)]
            pool = self.by_class[c]
            yield pool[self.rng.integers(len(pool))]


class MultiDatasetSampler:
    """Infinite index stream over the concatenation of several datasets,
    drawing from dataset d with probability ratios[d] / sum(ratios)."""

    def __init__(self, sizes: Sequence[int], ratios: Sequence[float], seed: int = 0):
        if len(sizes) != len(ratios):
            raise ValueError(f"{len(sizes)} dataset sizes, {len(ratios)} ratios")
        self.sizes = list(sizes)
        self.offsets = np.cumsum([0] + self.sizes[:-1])
        p = np.asarray(ratios, np.float64)
        self.probs = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        while True:
            d = self.rng.choice(len(self.sizes), p=self.probs)
            yield int(self.offsets[d] + self.rng.integers(self.sizes[d]))


def _cv2_resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)


def efficientdet_resize_crop(img: np.ndarray, boxes: np.ndarray, target_size: int, rng: np.random.Generator,
                             scale_range: Tuple[float, float] = (0.1, 2.0),
                             resize: Optional[Callable[[np.ndarray, Tuple[int, int]], np.ndarray]] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """EfficientDet-style train augmentation: a scale drawn in scale_range x
    (target / long side), a resize, then a random target x target crop
    (zero-padded where smaller); boxes follow and are clipped. Returns
    (canvas [T, T, 3], boxes). resize(img, (h, w)) is bilinear; by default
    cv2's INTER_LINEAR, imported only when called."""
    resize = resize or _cv2_resize
    h, w = img.shape[:2]
    scale = rng.uniform(*scale_range) * target_size / max(h, w)
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    resized = resize(img, (nh, nw))
    b = boxes.astype(np.float32) * scale

    off_y = rng.integers(0, max(nh - target_size, 0) + 1)
    off_x = rng.integers(0, max(nw - target_size, 0) + 1)
    crop = resized[off_y:off_y + target_size, off_x:off_x + target_size]
    canvas = np.zeros((target_size, target_size, img.shape[2]), img.dtype)
    canvas[:crop.shape[0], :crop.shape[1]] = crop

    b = b - np.asarray([off_x, off_y, off_x, off_y], np.float32)
    return canvas, np.clip(b, 0, target_size)
