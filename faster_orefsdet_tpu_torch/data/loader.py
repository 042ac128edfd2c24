"""The eval loader (counterpart of the eval half of
``faster_orefsdet_tpu/data/loader.py``): one pass over the records, batch 1,
each image preprocessed on the host onto a shared canvas.

Images are read by an `imread(path) -> [H, W, 3] uint8 array or None`
callable. The default is cv2's, imported only when it is called; a machine
without cv2 passes its own (a decoder, or frames held in memory).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..pipelines.preprocess import (
    ceil_to,
    pad_to_canvas,
    preprocess_host,
    resize_image_host,
    resize_shortest_edge_size,
)
from .coco import ImageRecord

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
        h, w = img.shape[:2]
        newh, neww = resize_shortest_edge_size(h, w, inp.min_size_test, inp.max_size_test)
        chw = canvas_hw or (ceil_to(newh, inp.size_divisibility), ceil_to(neww, inp.size_divisibility))
        if raw_uint8:
            resized = resize_image_host(np.ascontiguousarray(img, np.uint8), newh, neww)
            canvas = torch.from_numpy(pad_to_canvas(resized, chw)).permute(2, 0, 1)
            yield rec, canvas, (newh, neww), (h / newh, w / neww)
            continue
        canvas, hw, scale = preprocess_host(img, inp.min_size_test, inp.max_size_test, chw,
                                            inp.pixel_mean, inp.pixel_std)
        yield rec, canvas, hw, scale


def eval_canvas(records: Sequence[ImageRecord], cfg: Config) -> Tuple[int, int]:
    """One canvas covering every eval image at test scale."""
    d = cfg.input.size_divisibility
    mh = mw = d
    for rec in records:
        nh, nw = resize_shortest_edge_size(rec.height, rec.width, cfg.input.min_size_test,
                                           cfg.input.max_size_test)
        mh, mw = max(mh, nh), max(mw, nw)
    return (ceil_to(mh, d), ceil_to(mw, d))
