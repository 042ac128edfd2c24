from .boxes import apply_deltas, area, clip_boxes, encode_deltas, ltrb_to_xyxy, nonempty_mask, pairwise_iou
from .instances import Detections, GroundTruth, Proposals

__all__ = [
    "apply_deltas",
    "area",
    "clip_boxes",
    "encode_deltas",
    "ltrb_to_xyxy",
    "nonempty_mask",
    "pairwise_iou",
    "Detections",
    "GroundTruth",
    "Proposals",
]
