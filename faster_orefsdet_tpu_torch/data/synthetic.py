"""Synthetic ore-like data, made in memory (counterpart of
``faster_orefsdet_tpu/data/synthetic.py``).

No ore dataset ships with the repository, so training, evaluation and the
card's smoke run use generated scenes: a gray, rock-textured background
(low-frequency noise, upsampled bicubically by PyTorch, plus pixel noise)
with filled, rotated elliptical "ore" blobs whose bounding boxes are the
ground truth. Drawn with numpy from a seed; no image library is needed. The
pixels are not the JAX generator's: this is a data source, not a function
under parity.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .coco import ImageRecord, Imwrite, SupportEntry, build_support_crops, records_from_coco, save_support_index


def _background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    base = rng.normal(110, 12, (h // 8, w // 8, 3)).astype(np.float32)
    x = torch.from_numpy(base).permute(2, 0, 1)[None]
    img = F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
    return img + rng.normal(0, 6, img.shape).astype(np.float32)


def generate_ore_dataset(num_images: int = 20, image_hw: Tuple[int, int] = (240, 320), max_blobs: int = 6,
                         seed: int = 0, min_blobs: int = 1, blob_size: Tuple[float, float] = (28.0, 90.0)
                         ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Scenes and their COCO instances dict: ({file name: [H, W, 3] uint8
    BGR}, coco) with one category, "ore" (id 1)."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5  # pixel centers
    images: Dict[str, np.ndarray] = {}
    coco = {"images": [], "annotations": [], "categories": [{"id": 1, "name": "ore"}]}
    for i in range(num_images):
        img = _background(rng, h, w)
        for _ in range(int(rng.integers(min_blobs, max_blobs + 1))):
            bw, bh = float(rng.uniform(*blob_size)), float(rng.uniform(*blob_size))
            cx = float(rng.uniform(bw / 2 + 2, w - bw / 2 - 2))
            cy = float(rng.uniform(bh / 2 + 2, h - bh / 2 - 2))
            shade = float(rng.uniform(35, 75))
            t = np.deg2rad(float(rng.uniform(0, 180)))
            u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
            v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
            img[(u / (bw / 2)) ** 2 + (v / (bh / 2)) ** 2 <= 1.0] = (shade, shade, shade + rng.uniform(-8, 8))
            # the rotated ellipse's bounding box, clipped to the image
            ex = np.sqrt((bw / 2 * np.cos(t)) ** 2 + (bh / 2 * np.sin(t)) ** 2)
            ey = np.sqrt((bw / 2 * np.sin(t)) ** 2 + (bh / 2 * np.cos(t)) ** 2)
            x1, y1 = max(0.0, cx - ex), max(0.0, cy - ey)
            x2, y2 = min(float(w), cx + ex), min(float(h), cy + ey)
            coco["annotations"].append({"id": len(coco["annotations"]) + 1, "image_id": i + 1, "category_id": 1,
                                        "bbox": [x1, y1, x2 - x1, y2 - y1], "area": (x2 - x1) * (y2 - y1),
                                        "iscrowd": 0})
        fn = f"{i:05d}.jpg"
        images[fn] = np.clip(img, 0, 255).astype(np.uint8)
        coco["images"].append({"id": i + 1, "file_name": fn, "height": h, "width": w})
    return images, coco


def make_synthetic_setup(num_images: int = 12, seed: int = 0, crop_size: int = 240, *, root: str = "synthetic",
                         writer: Optional[Imwrite] = None, **gen_kwargs
                         ) -> Tuple[List[ImageRecord], List[SupportEntry], Callable[[str], Optional[np.ndarray]]]:
    """A generated dataset and its support crops, held in memory: (records,
    support entries, imread), the paths under `root` and imread reading the
    arrays behind them. gen_kwargs go to ``generate_ore_dataset``. With
    `writer(path, image)` (cv2.imwrite, say) every image and crop is also
    written there, with ``instances.json`` and ``support_index.json``."""
    images, coco = generate_ore_dataset(num_images=num_images, seed=seed, **gen_kwargs)
    img_root = os.path.join(root, "images")
    store = {os.path.join(img_root, fn): img for fn, img in images.items()}

    def put(path: str, img: np.ndarray) -> None:
        store[path] = img
        if writer is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            writer(path, img)

    for path, img in list(store.items()):
        put(path, img)
    records = records_from_coco(coco, img_root)
    entries = build_support_crops(records, os.path.join(root, "support"), crop_size=crop_size, imread=store.get,
                                  imwrite=put)
    if writer is not None:
        with open(os.path.join(root, "instances.json"), "w") as f:
            json.dump(coco, f)
        save_support_index(os.path.join(root, "support_index.json"), entries)
    return records, entries, store.get
