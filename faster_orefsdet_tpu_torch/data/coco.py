"""COCO-format dataset records and the support index (counterpart of
``faster_orefsdet_tpu/data/coco.py``; writing support crops belongs to the
command-line tools and is not ported yet).

Training records carry one image and the annotations of one class in it,
so that an episode can sample supports of that class.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


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
        coco = json.load(f)
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
