"""Build the support crops and their index from a COCO json (counterpart of
``faster_orefsdet_tpu/cli/build_support.py``).

One crop per annotation (a square-ish context window resized to
--crop-size), written as ``<out>/support_<ann id>.jpg``, and the index
``<out>/support_index.json`` that ``data.coco.load_support_index`` reads
(the FewX support pool the reference assumes pre-generated).

Usage:
  python -m faster_orefsdet_tpu_torch.cli.build_support \\
      --json instances_train2017.json --images train2017 \\
      --out datasets/coco/support [--crop-size 240] [--max-per-class 200]

The command line reads, resizes and writes with cv2; ``build_support``
takes those three as callables, so that it also runs without cv2.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

from ..data.coco import SupportEntry, build_support_crops, load_coco_json, save_support_index


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--crop-size", type=int, default=240)
    p.add_argument("--max-per-class", type=int, default=None)
    return p.parse_args(argv)


def build_support(json_path: str, images: str, out: str, crop_size: int = 240,
                  max_per_class: Optional[int] = None, *, imread=None, imwrite=None,
                  resize=None) -> Tuple[List[SupportEntry], str]:
    """The crops of every annotation of `json_path` (images under `images`)
    into `out`, and the index beside them -> (entries, index path).
    imread / imwrite / resize as ``data.coco.build_support_crops`` takes them."""
    os.makedirs(out, exist_ok=True)
    entries = build_support_crops(load_coco_json(json_path, images), out, crop_size=crop_size,
                                  max_per_class=max_per_class, imread=imread, imwrite=imwrite, resize=resize)
    index_path = os.path.join(out, "support_index.json")
    save_support_index(index_path, entries)
    return entries, index_path


def cv2_resize(img, h: int, w: int):
    """cv2's bilinear resize (INTER_LINEAR), as the JAX package's crops."""
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    import cv2

    entries, index_path = build_support(args.json, args.images, args.out, args.crop_size, args.max_per_class,
                                        imread=cv2.imread, imwrite=cv2.imwrite, resize=cv2_resize)
    print(f"{len(entries)} support crops -> {args.out}; index at {index_path}")


if __name__ == "__main__":
    main()
