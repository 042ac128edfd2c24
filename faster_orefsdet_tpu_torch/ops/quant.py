"""Post-training int8 quantization (W8A8) of the serving convolutions
(counterpart of ``faster_orefsdet_tpu/ops/quant.py``).

Symmetric scales (zero-point 0): int8 weights per output channel, int8
activations, int32 accumulation, the result dequantized by the product of
the two scales. Activations take a dynamic per-example scale, or a static
one calibrated once (``pipelines/quant_calib.py``) and read from the scale
stack that ``static_act_scales`` opens around a request (each quantized
module looks its key up there, the JAX package's module path).

The int8 products are int8 GEMMs with int32 accumulation
(``torch._int_mm``; cuBLASLt on the card): a 1x1 convolution multiplies the
channels-last map as it lies, a larger one first gathers an int8 im2col.
cuBLASLt asks for more than 16 rows and for inner and output widths that
are multiples of 8; ``int8_gemm`` pads with zero rows and columns to meet
that, which leaves the product exact, on either device. Nothing falls back
to a float product.

The arithmetic order is the JAX package's, so that the int8 grids are the
same bits: ``quantize_symmetric`` divides by the scale, ``quantize_static``
multiplies by its reciprocal, the dequant multiplies by the product of the
scales formed first, and rounding is half to even on both sides. Layouts
are NCHW / OIHW: a weight's abs-max runs over dims (1, 2, 3).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import device_constant

_EPS = 1e-8

Scale = Union[float, torch.Tensor]


class _Counter:
    """int8 GEMMs run by ``int8_gemm`` (one per quantized conv or matmul)."""

    gemms = 0


counter = _Counter()


class QTensor(NamedTuple):
    """An int8-resident activation: ``q * scale`` approximates the real
    tensor. q is int8 NCHW (channels at dim 1); scale a positive Python
    float (static), a 0-dim tensor (dynamic) or a per-channel [C] tensor."""

    q: torch.Tensor
    scale: Scale

    @property
    def channels(self) -> int:
        return self.q.shape[1]

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        s = self.scale
        if isinstance(s, torch.Tensor):
            s = s.float().reshape(1, -1, 1, 1) if s.dim() else s.float()
        return (self.q.float() * s).to(dtype)


@device_constant
def _f32(value: float) -> np.ndarray:
    return np.asarray(value, np.float32)


def amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-8) in f32. The divisor is a tensor on amax's
    device: CUDA turns a division by a host scalar into a product with its
    reciprocal, which may differ in the last bit."""
    return torch.clamp_min(amax / _f32(127.0, device=amax.device), _EPS)


@device_constant
def _scale_vector(values: Tuple[float, ...]) -> np.ndarray:
    return np.asarray(values, np.float32)


def qconcat(parts: Sequence[QTensor]) -> QTensor:
    """Concatenate int8-resident tensors along the channels. The parts'
    scales become one per-channel vector (no requantization): the consuming
    conv folds it into its weights (``int8_conv_resident``). Static scales
    give a constant vector kept on the device, so a captured request reads
    it without a copy from the host."""
    q = torch.cat([p.q for p in parts], dim=1)
    if all(not isinstance(p.scale, torch.Tensor) for p in parts):
        vec = np.concatenate([np.broadcast_to(np.asarray(p.scale, np.float32).reshape(-1), (p.channels,))
                              for p in parts])
        return QTensor(q, _scale_vector(tuple(vec.tolist()), device=q.device))
    # a tensor scale lies on q's device already (it was computed from q's data)
    scales = [(p.scale.float() if isinstance(p.scale, torch.Tensor)
               else torch.as_tensor(p.scale, dtype=torch.float32, device=q.device)).reshape(-1).expand(p.channels)
              for p in parts]
    return QTensor(q, torch.cat(scales))


# the scale dicts of the requests being run: a quantized module reads its
# key in the innermost one while its forward runs
_ACT_SCALES_STACK: list = []
# the abs-max recorders of the calibrations being run (quant_calib)
_AMAX_STACK: list = []


@contextlib.contextmanager
def static_act_scales(scales: Optional[Mapping[str, float]]):
    """Run the quantized modules inside this context with the calibrated
    activation scales `scales` ({module key: positive float}, see
    ``pipelines.quant_calib.calibrate_act_scales``). None is a no-op
    (dynamic quantization)."""
    if scales is None:
        yield
        return
    _ACT_SCALES_STACK.append(dict(scales))
    try:
        yield
    finally:
        _ACT_SCALES_STACK.pop()


def current_act_scales() -> Optional[Dict[str, float]]:
    return _ACT_SCALES_STACK[-1] if _ACT_SCALES_STACK else None


def lookup_scale(key: str, what: str) -> Optional[float]:
    """The static scale of `key` when a scale dict is active, else None. A
    key missing from an active dict raises: a silent miss would quantize
    that one module dynamically (a stale calibration after a rename)."""
    scales = current_act_scales()
    if scales is None:
        return None
    s = scales.get(key)
    if s is None:
        raise ValueError(f"{what} {key!r} (calibration has {len(scales)} entries) — "
                         "re-run pipelines.quant_calib.calibrate_act_scales")
    return s


@contextlib.contextmanager
def record_act_amax():
    """Record the abs-max that each quantized module sees at its boundary
    ({key: 0-dim f32 tensor}, the running max over the calls made inside
    the context): the counterpart of flax's ``sow`` into ``act_amax``."""
    amax: Dict[str, torch.Tensor] = {}
    _AMAX_STACK.append(amax)
    try:
        yield amax
    finally:
        _AMAX_STACK.pop()


def record_amax(key: str, x: torch.Tensor) -> None:
    """Add |x|'s max to the active recorder under `key` (no-op without one)."""
    if not _AMAX_STACK:
        return
    rec = _AMAX_STACK[-1]
    m = x.float().abs().amax()
    rec[key] = m if key not in rec else torch.maximum(rec[key], m)


def quantize_symmetric(x: torch.Tensor, dims: Optional[Tuple[int, ...]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_int8, scale) with x ~ x_int8 * scale; the abs-max runs over `dims`
    (kept as size-1 dims), or over the whole tensor when dims is None."""
    xf = x.float()
    amax = xf.abs().amax() if dims is None else xf.abs().amax(dim=dims, keepdim=True)
    scale = amax_scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_static(x: torch.Tensor, scale: Union[float, torch.Tensor]) -> torch.Tensor:
    """int8 with a fixed scale: one elementwise pass."""
    return torch.clamp(torch.round(x.float() * (1.0 / scale)), -127, 127).to(torch.int8)


def requantize(y: torch.Tensor, scale: Union[float, torch.Tensor]) -> QTensor:
    """Float activations -> int8-resident with `scale` (quantize_static's grid)."""
    return QTensor(quantize_static(y, scale), scale)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def int8_gemm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b_t [N, K] int8 transposed -> [M, N] int32, exact.

    ``torch._int_mm`` on a row-major A and a column-major B (cuBLASLt's int8
    layout on the card). Zero rows bring M above 16 and zero columns bring K
    and N to multiples of 8, as cuBLASLt requires; the padding adds zeros to
    the sums and its rows and columns are dropped."""
    m, k = a.shape
    n = b_t.shape[0]
    kp, np_ = _ceil8(k), _ceil8(n)
    mp = m if m > 16 else 32
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    counter.gemms += 1
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def im2col(xq: torch.Tensor, kernel_hw: Tuple[int, int], stride: Tuple[int, int], padding: Tuple[int, int]
           ) -> torch.Tensor:
    """xq [B, C, H, W] int8 -> the int8 im2col [B * Ho * Wo, kh * kw * C],
    rows (b, ho, wo) and columns (i, j, c), gathered from F.pad and unfold
    views of the channels-last map; a 1x1 stride-1 conv's is the map as it
    lies."""
    b, c, h, w = xq.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel_hw, stride, padding
    x = xq.permute(0, 2, 3, 1)  # NHWC, a view of a channels-last map
    if kh == kw == 1 and (sh, sw) == (1, 1) and (ph, pw) == (0, 0):
        return x.reshape(b * h * w, c)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    cols = x.unfold(1, kh, sh).unfold(2, kw, sw)  # [B, Ho, Wo, C, kh, kw]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """wq [O, C, kh, kw] -> [O, kh * kw * C], columns in im2col's order."""
    return wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: Tuple[int, int], padding: Tuple[int, int]
                ) -> torch.Tensor:
    """xq [B, C, H, W] int8 (conv) wq [O, C, kh, kw] int8 -> [B, O, Ho, Wo]
    int32, channels-last in memory: the int8 im2col times the weights as an
    int8 GEMM."""
    b, _, h, w = xq.shape
    o, _, kh, kw = wq.shape
    ho = (h + 2 * padding[0] - kh) // stride[0] + 1
    wo = (w + 2 * padding[1] - kw) // stride[1] + 1
    acc = int8_gemm(im2col(xq, (kh, kw), stride, padding), weight_matrix(wq))
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0,
              out_dtype: Optional[torch.dtype] = None, act_scale: Optional[float] = None) -> torch.Tensor:
    """Convolution of float activations on the int8 path.

    x: [C, H, W] or [B, C, H, W] in any float dtype. Without `act_scale`
    each example takes its own dynamic scale (abs-max over C, H and W); with
    it (a calibrated float) the quantize is one elementwise pass. weight
    [O, C, kh, kw] float, quantized per output channel. Returns the
    dequantized result in out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    if act_scale is not None:
        xq, sx = quantize_static(x, act_scale), act_scale
    else:
        xq, sx = quantize_symmetric(x, dims=(1, 2, 3))  # [B, 1, 1, 1]
    wq, sw = quantize_symmetric(weight, dims=(1, 2, 3))  # [O, 1, 1, 1]
    acc = int8_conv2d(xq, wq, _pair(stride), _pair(padding))
    y = (acc.float() * (sx * sw.view(1, -1, 1, 1))).to(out_dtype)
    return y[0] if squeeze else y


def int8_conv_resident(x: QTensor, weight: torch.Tensor, stride=1, padding=0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 x int8 -> int32 convolution over an int8-resident input.

    The input's scale (scalar or per input channel) is folded into the float
    weights before they are quantized per output channel, so a concat of
    branches with different scales costs nothing here. Returns the int32
    accumulator [B, O, Ho, Wo] (or [O, Ho, Wo] for a 3-D q) and the
    per-output-channel dequant factor [O]."""
    s = x.scale
    s_in = s.float().reshape(1, -1, 1, 1) if isinstance(s, torch.Tensor) else float(s)
    wq, sw = quantize_symmetric(weight.float() * s_in, dims=(1, 2, 3))
    xq = x.q
    squeeze = xq.dim() == 3
    if squeeze:
        xq = xq[None]
    acc = int8_conv2d(xq, wq, _pair(stride), _pair(padding))
    return (acc[0] if squeeze else acc), sw.reshape(-1)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[..., K] @ [K, N] on the int8 path: a per-tensor scale for x, one per
    column for w."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_symmetric(x)
    wq, sw = quantize_symmetric(w, dims=(0,))  # [1, N]
    y = int8_gemm(xq.reshape(-1, xq.shape[-1]), wq.t()).reshape(*x.shape[:-1], w.shape[1])
    return (y.float() * (sx * sw)).to(out_dtype)
