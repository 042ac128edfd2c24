"""The deformable blocks' least time, the yardstick of the decoder stage of
CenterNet-S4 over DLA-34-DCN: one block's on its own shapes, whatever
implements it.

A block is its offset conv (3x3, Cin -> 27: 18 offsets and 9 mask logits a
position, with bias) and its modulated deformable conv (3x3 taps, Cin ->
Cout, stride 1). Operations: 2 a multiply-add of the two contractions, at
the peak of the configuration's stated precision (`peak_flops`: float32
with TF32 convolutions, TF32's 495 TFLOP/s); the bilinear sampling,
the mask and the norm are not counted. Bytes, each once at 4 a float32
value: the input map, the offsets and mask, both weights and the offset
conv's bias, and the output.
"""

from .peaks import BYTES_PER_S

TAPS = 9
OFFSET_CHANNELS = 27


def call_seconds(b: int, cin: int, h: int, w: int, cout: int, ho: int, wo: int, peak_flops: float) -> float:
    positions = b * ho * wo
    flops = 2 * positions * TAPS * cin * (cout + OFFSET_CHANNELS)
    values = (b * cin * h * w + positions * OFFSET_CHANNELS + TAPS * cin * (cout + OFFSET_CHANNELS)
              + OFFSET_CHANNELS + positions * cout)
    return max(4 * values / BYTES_PER_S, flops / peak_flops)
