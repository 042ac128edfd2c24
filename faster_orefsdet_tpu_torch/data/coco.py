"""COCO-format dataset records, the support index, and the support crops
it points to (counterpart of ``faster_orefsdet_tpu/data/coco.py``).

Training records carry one image and the annotations of one class in it,
so that an episode can sample supports of that class.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Annotation:
    id: int
    bbox: Tuple[float, float, float, float]  # xyxy
    category_id: int
    iscrowd: int = 0


@dataclass
class ImageRecord:
    file_name: str
    image_id: int
    height: int
    width: int
    annotations: List[Annotation] = field(default_factory=list)


def _xywh_to_xyxy(b):
    x, y, w, h = b
    return (x, y, x + w, y + h)


def load_coco_json(json_path: str, image_root: str) -> List[ImageRecord]:
    """A minimal COCO instances reader: one record per image, its
    annotations' boxes as xyxy, file names joined to image_root."""
    with open(json_path) as f:
        return records_from_coco(json.load(f), image_root)


def records_from_coco(coco: Dict, image_root: str) -> List[ImageRecord]:
    """``load_coco_json`` of a COCO instances dict held in memory."""
    recs: Dict[int, ImageRecord] = {
        im["id"]: ImageRecord(
            file_name=os.path.join(image_root, im["file_name"]),
            image_id=im["id"],
            height=im["height"],
            width=im["width"],
        )
        for im in coco["images"]
    }
    for ann in coco.get("annotations", []):
        r = recs.get(ann["image_id"])
        if r is None:
            continue
        r.annotations.append(
            Annotation(
                id=ann["id"],
                bbox=_xywh_to_xyxy(ann["bbox"]),
                category_id=ann["category_id"],
                iscrowd=ann.get("iscrowd", 0),
            )
        )
    return list(recs.values())


def split_per_class(records: Sequence[ImageRecord]) -> List[ImageRecord]:
    """One training record per (image, class), dropping crowd annotations
    and the images left with none."""
    out: List[ImageRecord] = []
    for rec in records:
        anns = [a for a in rec.annotations if not a.iscrowd]
        by_cls: Dict[int, List[Annotation]] = {}
        for a in anns:
            by_cls.setdefault(a.category_id, []).append(a)
        for cls_anns in by_cls.values():
            out.append(ImageRecord(file_name=rec.file_name, image_id=rec.image_id, height=rec.height,
                                   width=rec.width, annotations=list(cls_anns)))
    return out


@dataclass
class SupportEntry:
    """One row of the support index: a support crop on disk and its box."""

    id: int
    image_id: int
    category_id: int
    file_path: str  # the 240x240 support crop
    support_box: Tuple[float, float, float, float]  # xyxy in crop coords


def save_support_index(path: str, entries: Sequence[SupportEntry]) -> None:
    with open(path, "w") as f:
        json.dump([e.__dict__ for e in entries], f)


def load_support_index(path: str) -> List[SupportEntry]:
    with open(path) as f:
        rows = json.load(f)
    return [SupportEntry(**{**r, "support_box": tuple(r["support_box"])}) for r in rows]


Imwrite = Callable[[str, np.ndarray], object]


def cv2_imwrite(path: str, img: np.ndarray) -> bool:
    """cv2.imwrite, the JAX package's writer (cv2 imported only when called)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("writing images needs cv2, which is not installed: pass imwrite=, a callable "
                          "(path, [H, W, 3] uint8 BGR array)") from e
    return cv2.imwrite(path, img)


def build_support_crops(
    records: Sequence[ImageRecord],
    out_dir: str,
    crop_size: int = 240,
    context_ratio: float = 0.15,
    max_per_class: Optional[int] = None,
    *,
    imread: Optional[Callable[[str], Optional[np.ndarray]]] = None,
    imwrite: Optional[Imwrite] = None,
    resize: Optional[Callable[[np.ndarray, int, int], np.ndarray]] = None,
) -> List[SupportEntry]:
    """One support crop per non-crowd annotation, at most `max_per_class`
    of a class (the first ones in record order): the box with
    `context_ratio` of context on each side, resized to crop_size x
    crop_size with the box mapped along, written as
    ``out_dir/support_<ann id>.jpg`` by `imwrite`. Images are read by
    `imread`; both default to cv2's (the default writer makes out_dir).
    `resize(img, h, w)` defaults to bilinear by PyTorch on the host (within
    one level of cv2's INTER_LINEAR). Returns the support index entries."""
    from ..pipelines.preprocess import resize_image_host
    from .loader import cv2_imread

    imread = imread or cv2_imread
    resize = resize or resize_image_host
    if imwrite is None:
        os.makedirs(out_dir, exist_ok=True)
        imwrite = cv2_imwrite
    entries: List[SupportEntry] = []
    per_class: Dict[int, int] = {}
    for rec in records:
        img = None
        for ann in rec.annotations:
            if ann.iscrowd or (max_per_class is not None and per_class.get(ann.category_id, 0) >= max_per_class):
                continue
            if img is None:
                img = imread(rec.file_name)
                if img is None:
                    break
            x1, y1, x2, y2 = ann.bbox
            pad_w, pad_h = (x2 - x1) * context_ratio, (y2 - y1) * context_ratio
            cx1, cy1 = max(0, int(x1 - pad_w)), max(0, int(y1 - pad_h))
            cx2 = min(rec.width, int(x2 + pad_w) + 1)
            cy2 = min(rec.height, int(y2 + pad_h) + 1)
            crop = img[cy1:cy2, cx1:cx2]
            if crop.size == 0:
                continue
            sy, sx = crop_size / crop.shape[0], crop_size / crop.shape[1]
            crop = resize(np.ascontiguousarray(crop), crop_size, crop_size)
            path = os.path.join(out_dir, f"support_{ann.id}.jpg")
            imwrite(path, crop)
            entries.append(SupportEntry(id=ann.id, image_id=rec.image_id, category_id=ann.category_id,
                                        file_path=path,
                                        support_box=((x1 - cx1) * sx, (y1 - cy1) * sy, (x2 - cx1) * sx,
                                                     (y2 - cy1) * sy)))
            per_class[ann.category_id] = per_class.get(ann.category_id, 0) + 1
    return entries
