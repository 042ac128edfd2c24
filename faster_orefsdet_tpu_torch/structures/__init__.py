from .boxes import apply_deltas, area, clip_boxes, ltrb_to_xyxy, pairwise_iou
from .instances import Detections, Proposals

__all__ = [
    "apply_deltas",
    "area",
    "clip_boxes",
    "ltrb_to_xyxy",
    "pairwise_iou",
    "Detections",
    "Proposals",
]
