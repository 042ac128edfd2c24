"""COCO AP evaluation (numpy)."""

from .coco_eval import COCOEvaluator, coco_ap

__all__ = ["COCOEvaluator", "coco_ap"]
