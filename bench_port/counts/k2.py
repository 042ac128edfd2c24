"""K2, greedy NMS over fixed-K box sets (``csrc/nms.cu``): the least time of
one call on its own inputs.

Per row with n valid boxes: 13 operations per IoU of a pair of valid boxes
(n(n-1)/2 pairs) and 3 per rank comparison among them (n^2), at the f32
rate. Bytes: each of the K slots' box (16), score (4), valid flag (1) and
keep flag (1) once.
"""

from typing import Sequence

from .peaks import least_seconds


def call_seconds(k: int, valid_per_row: Sequence[int]) -> float:
    flops = sum(n * (n - 1) // 2 * 13 + n * n * 3 for n in valid_per_row)
    return least_seconds(len(valid_per_row) * k * (16 + 4 + 1 + 1), flops)
