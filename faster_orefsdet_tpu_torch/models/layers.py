"""Shared building blocks on NCHW maps (counterpart of
``faster_orefsdet_tpu/models/layers.py``), the int8 ``QuantConv`` and the
int8-resident ``ConvNorm`` included.

Parameters are stored f32 under the names of the JAX package's parameter
tree (``kernel`` becomes ``weight``), so ``utils.params.from_jax_params`` is
a mechanical rename. A layer given ``dtype`` runs its product in that dtype,
as a flax layer with ``dtype`` does; a layer without one runs in the
promoted dtype of its input and its (f32) weights.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 when it is f64 (an f64 run of the port is its
    own oracle where f32 rounding is amplified)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _dtype(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dt = _dtype(x, conv.weight, dtype)
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x.to(dt), conv.weight.to(dt), bias, conv.stride, conv.padding, groups=conv.groups)


def linear(x: torch.Tensor, lin: nn.Linear, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dt = _dtype(x, lin.weight, dtype)
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


class FrozenBatchNorm(nn.Module):
    """FrozenBatchNorm2d folded to a per-channel affine y = x * scale + bias,
    kept in the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype).view(1, -1, 1, 1) + self.bias.to(x.dtype).view(1, -1, 1, 1)


class GroupNorm(nn.Module):
    """GroupNorm (eps 1e-5) with affine parameters named as in flax; the
    output is f32 (flax promotes a bf16 input against f32 parameters)."""

    def __init__(self, features: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(at_least_f32(x), self.num_groups, self.scale, self.bias, eps=1e-5)


class BatchNorm(nn.Module):
    """Trainable BatchNorm with flax's semantics and names: affine `scale` /
    `bias`, running statistics `mean` / `var` (the flax ``batch_stats``
    leaves), eps 1e-5, momentum 0.9 on the running value (torch's 0.1 on
    the batch's). The output is f32 (f64 for an f64 input).

    forward(x, train=True) normalizes by the batch's statistics over N, H, W
    (biased variance) and moves the running statistics toward them, the
    variance with the biased one as flax does (torch would use the unbiased
    one, N/(N-1) larger). train=False normalizes by the running statistics.
    The update is in place on the buffers, so a CUDA graph can capture it."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = at_least_f32(x)
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=False, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return F.batch_norm(x, None, None, self.scale, self.bias, training=True, eps=self.eps)


class QuantConv(nn.Conv2d):
    """A convolution on the int8 path (``ops.quant.int8_conv``), with the
    parameters of ``nn.Conv2d`` (``weight`` [+ ``bias``]), so converted
    checkpoints load unchanged. The f32 weights are quantized per output
    channel at each call; the activations per example dynamically, or with
    the calibrated scale of this module's key (``scale_key``, its JAX module
    path, set when the detector is built) while ``ops.quant.static_act_scales``
    is active. The bias stays float, added after the dequant.

    forward(x, raw=True) returns the int32 accumulator and the dequant factor
    (``int8_conv_resident``): x is then an ``ops.quant.QTensor``, or a float
    map quantized here with a per-tensor scale (static, or dynamic over the
    whole batch). A calibration (``ops.quant.record_act_amax``) records the
    abs-max of each float input."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, features, kernel_size, stride, padding, bias=bias)
        self.out_dtype = dtype
        self.scale_key = ""

    def forward(self, x: Union[torch.Tensor, quant.QTensor], raw: bool = False):
        if not isinstance(x, quant.QTensor):
            quant.record_amax(self.scale_key, x)
            act_scale = quant.lookup_scale(self.scale_key, "int8_static: no calibrated activation scale for conv")
            if not raw:
                y = quant.int8_conv(x, self.weight, self.stride, self.padding, out_dtype=self.out_dtype or x.dtype,
                                    act_scale=act_scale)
                return y if self.bias is None else y + self.bias.to(y.dtype).view(1, -1, 1, 1)
            if act_scale is not None:
                x = quant.QTensor(quant.quantize_static(x, act_scale), act_scale)
            else:
                x = quant.QTensor(*quant.quantize_symmetric(x))
        acc, factor = quant.int8_conv_resident(x, self.weight, self.stride, self.padding)
        if raw:
            return acc, factor
        y = (acc.float() * factor.view(1, -1, 1, 1)).to(self.out_dtype or torch.float32)
        return y if self.bias is None else y + self.bias.to(y.dtype).view(1, -1, 1, 1)


class ConvNorm(nn.Module):
    """conv (no bias) + FrozenBN [+ relu]: the VoVNet conv3x3 / conv1x1 unit
    (`groups` for a grouped conv). quant=True runs the conv on the int8 path
    (the same parameters).

    resident=True (implies quant) is the int8-resident unit: it takes a float
    map or an ``ops.quant.QTensor``, and its epilogue dequantizes the int32
    accumulator, applies FrozenBN and relu in f32 and requantizes with the
    calibrated output scale of its key (a dynamic per-tensor one while no
    scale dict is active), so it returns a QTensor; emit_float=True returns
    the float map in the compute dtype instead."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 1,
                 relu: bool = True, dtype: Optional[torch.dtype] = None, quant: bool = False,
                 resident: bool = False, emit_float: bool = False, groups: int = 1):
        super().__init__()
        if groups != 1 and (quant or resident):
            raise ValueError("ConvNorm: the int8 path has no grouped conv")
        if quant or resident:
            self.conv = QuantConv(in_ch, features, kernel_size, stride, kernel_size // 2,
                                  dtype=None if resident else dtype)
        else:
            self.conv = nn.Conv2d(in_ch, features, kernel_size, stride, kernel_size // 2, bias=False, groups=groups)
        self.norm = FrozenBatchNorm(features)
        self.relu = relu
        self.dtype = dtype
        self.quant = quant or resident
        self.resident = resident
        self.emit_float = emit_float
        self.scale_key = ""

    def forward(self, x):
        if self.resident:
            return self._resident(x)
        x = self.norm(self.conv(x) if self.quant else conv2d(x, self.conv, self.dtype))
        return torch.relu(x) if self.relu else x

    def _resident(self, x):
        acc, factor = self.conv(x, raw=True)
        y = self.norm(acc.float() * factor.view(1, -1, 1, 1))
        if self.relu:
            y = torch.relu(y)
        if self.emit_float:
            return y.to(self.dtype or torch.float32)
        quant.record_amax(self.scale_key, y)
        s_out = quant.lookup_scale(self.scale_key, "int8_resident: no calibrated OUTPUT scale for")
        if s_out is None:
            s_out = quant.amax_scale(y.abs().amax())
        return quant.requantize(y, s_out)


def assign_scale_keys(root: nn.Module, prefix: str = "") -> None:
    """Give each module of `root` that reads activation scales (a
    ``scale_key`` attribute) its key: its path under `root` joined by "/"
    and prefixed, as the JAX package's ``"/".join(module.path)``."""
    for name, m in root.named_modules():
        if hasattr(m, "scale_key"):
            m.scale_key = "/".join(p for p in (prefix, *name.split(".")) if p)


class Scale(nn.Module):
    """Learned scalar multiplier."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def max_pool_ceil(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, ceil_mode=True)."""
    return F.max_pool2d(x, window, stride, ceil_mode=True)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='nearest')."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
