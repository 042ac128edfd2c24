"""K1, the fused CGM correlation and its 1x1 projection (``csrc/cgm.cu``):
the least time of one call on a level's shapes.

Per output value: the 2C-term projection, 2 * 2C operations on the tensor
cores, and 15 at the f32 rate (the 1x1 chain 2, the W stencil 5, the H
stencil 5, the two sums 2, the bias 1; relus not counted). Bytes: q read
once, the output written once, the f32 taps (7C), W3 (2C x C) and bias (C).
"""

from .peaks import least_seconds


def call_seconds(b: int, h: int, w: int, c: int, q_bytes: int, out_bytes: int, n_cls: int = 1) -> float:
    n = b * h * w * c
    nbytes = n * q_bytes + n_cls * n * out_bytes + n_cls * 8 * c * 4 + 2 * c * c * 4
    return least_seconds(nbytes, n_cls * n * 15, n_cls * n * 2 * 2 * c)
