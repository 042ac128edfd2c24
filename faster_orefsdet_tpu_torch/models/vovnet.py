"""VoVNet backbone family (counterpart of ``faster_orefsdet_tpu/models/vovnet.py``).
V-19-slim-eSE is the live spec: stem [64, 64, 128], stage conv channels
[64, 80, 96, 112], concat channels [112, 256, 384, 512], 3 convs per OSA
module, one block per stage, eSE on. The other six specs are the dense
V-19/39/57/99-eSE (blocks after a stage's first add the identity) and the
depthwise V-19-slim-dw-eSE and V-19-dw-eSE.

quant=True runs the stem and OSA convs on the int8 path, except the
depthwise blocks, which stay in the compute dtype as the eSE gate does;
resident=True keeps the stem chain and each OSA module's conv chain and
concat in int8 (``ops.quant.QTensor``), the stage outputs float at the eSE
gates (dense specs only)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops import quant as quant_ops
from .layers import ConvNorm, FrozenBatchNorm, conv2d, hsigmoid, max_pool_ceil

# name -> (stem_chs, stage_conv_chs, stage_out_chs, layer_per_block,
#          block_per_stage, depthwise)
VOVNET_STAGE_SPECS = {
    "V-19-slim-eSE": ([64, 64, 128], [64, 80, 96, 112], [112, 256, 384, 512], 3, [1, 1, 1, 1], False),
    "V-19-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 3, [1, 1, 1, 1], False),
    "V-39-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 5, [1, 1, 2, 2], False),
    "V-57-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 5, [1, 1, 4, 3], False),
    "V-99-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 5, [1, 3, 9, 3], False),
    "V-19-slim-dw-eSE": ([64, 64, 64], [64, 80, 96, 112], [112, 256, 384, 512], 3, [1, 1, 1, 1], True),
    "V-19-dw-eSE": ([64, 64, 64], [128, 160, 192, 224], [256, 512, 768, 1024], 3, [1, 1, 1, 1], True),
}


class ESEModule(nn.Module):
    """Effective squeeze-excitation: global average pool -> 1x1 conv (bias)
    -> hsigmoid gate."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc = nn.Conv2d(features, features, 1, bias=True)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.mean(dim=(2, 3), keepdim=True)
        return x * hsigmoid(conv2d(g, self.fc, self.dtype))


class DWConvNorm(nn.Module):
    """Depthwise 3x3 (a grouped conv) + pointwise 1x1, FrozenBN on the
    pointwise only, relu. Always in the compute dtype, never int8."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dw = nn.Conv2d(in_ch, features, 3, stride, 1, groups=in_ch, bias=False)
        self.pw = nn.Conv2d(features, features, 1, bias=False)
        self.norm = FrozenBatchNorm(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(conv2d(conv2d(x, self.dw, self.dtype), self.pw, self.dtype)))


class OSAModule(nn.Module):
    """One-shot aggregation: a chain of 3x3 convs whose outputs and input
    concatenate into a 1x1 projection + eSE. The depthwise variant's chain
    is of ``DWConvNorm`` blocks, after a 1x1 ``reduction`` where the input
    width differs from the stage width.

    resident=True: the input is quantized once (the calibrated scale of this
    module's key, or a dynamic per-tensor one) unless it arrives as a
    QTensor, the chain passes QTensors, the concat is ``qconcat`` and the
    concat conv emits the float map for eSE."""

    def __init__(self, in_ch: int, stage_ch: int, concat_ch: int, layer_per_block: int,
                 identity: bool = False, depthwise: bool = False, dtype: Optional[torch.dtype] = None,
                 quant: bool = False, resident: bool = False):
        super().__init__()
        self.layer_per_block = layer_per_block
        self.identity = identity
        self.resident = resident
        chain_in = in_ch
        if depthwise and in_ch != stage_ch:
            self.reduction = ConvNorm(in_ch, stage_ch, 1, dtype=dtype, quant=quant)
            chain_in = stage_ch
        for i in range(layer_per_block):
            cin = chain_in if i == 0 else stage_ch
            self.add_module(f"layer{i}", DWConvNorm(cin, stage_ch, dtype=dtype) if depthwise else
                            ConvNorm(cin, stage_ch, 3, dtype=dtype, quant=quant, resident=resident))
        self.concat = ConvNorm(in_ch + layer_per_block * stage_ch, concat_ch, 1, dtype=dtype, quant=quant,
                               resident=resident, emit_float=resident)
        self.ese = ESEModule(concat_ch, dtype=dtype)
        if resident:
            self.scale_key = ""

    def forward(self, x):
        identity_feat = x
        if self.resident and not isinstance(x, quant_ops.QTensor):
            s_in = quant_ops.lookup_scale(self.scale_key, "int8_resident: no calibrated input scale for OSA")
            if s_in is None:
                s_in = quant_ops.amax_scale(x.float().abs().amax())
            quant_ops.record_amax(self.scale_key, x)
            x = quant_ops.requantize(x.float(), s_in)
        outputs = [x]
        if hasattr(self, "reduction"):
            x = self.reduction(x)
        for i in range(self.layer_per_block):
            x = getattr(self, f"layer{i}")(x)
            outputs.append(x)
        cat = quant_ops.qconcat(outputs) if self.resident else torch.cat(outputs, dim=1)
        x = self.ese(self.concat(cat))
        return x + identity_feat if self.identity else x


class VoVNet(nn.Module):
    """VoVNet producing {'stem', 'stage2'..'stage5'} NCHW maps (those in
    out_features). quant / resident as in the module docstring; the stem
    stays int8-resident into stage 2 unless "stem" is an output."""

    def __init__(self, conv_body: str = "V-19-slim-eSE",
                 out_features: Tuple[str, ...] = ("stage3", "stage4", "stage5"),
                 dtype: Optional[torch.dtype] = None, quant: bool = False, resident: bool = False):
        super().__init__()
        if conv_body not in VOVNET_STAGE_SPECS:
            raise ValueError(f"conv_body {conv_body!r}: the port has {sorted(VOVNET_STAGE_SPECS)}")
        stem_chs, conv_chs, out_chs, layer_per_block, blocks, depthwise = VOVNET_STAGE_SPECS[conv_body]
        if resident and depthwise:
            raise ValueError(f"quantize='int8_resident' supports the dense VoVNet specs only (got {conv_body!r})")
        self.out_features = tuple(out_features)
        self.dtype = dtype
        self.blocks = blocks
        stem_float = "stem" in self.out_features
        self.stem1 = ConvNorm(3, stem_chs[0], stride=2, dtype=dtype, quant=quant, resident=resident)
        if depthwise:
            self.stem2 = DWConvNorm(stem_chs[0], stem_chs[1], stride=1, dtype=dtype)
            self.stem3 = DWConvNorm(stem_chs[1], stem_chs[2], stride=2, dtype=dtype)
        else:
            self.stem2 = ConvNorm(stem_chs[0], stem_chs[1], stride=1, dtype=dtype, quant=quant, resident=resident)
            self.stem3 = ConvNorm(stem_chs[1], stem_chs[2], stride=2, dtype=dtype, quant=quant, resident=resident,
                                  emit_float=resident and stem_float)
        in_ch = stem_chs[2]
        for i in range(4):
            for b in range(blocks[i]):
                self.add_module(
                    f"stage{i + 2}_block{b}",
                    OSAModule(in_ch, conv_chs[i], out_chs[i], layer_per_block, identity=b > 0,
                              depthwise=depthwise, dtype=dtype, quant=quant, resident=resident),
                )
                in_ch = out_chs[i]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.stem3(self.stem2(self.stem1(x)))
        outputs = {}
        if "stem" in self.out_features:
            outputs["stem"] = x
        for i in range(4):
            name = f"stage{i + 2}"
            if i > 0:  # stages 3-5 downsample first
                x = max_pool_ceil(x, 3, 2)
            for b in range(self.blocks[i]):
                x = getattr(self, f"{name}_block{b}")(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs

    @staticmethod
    def out_channels(conv_body: str) -> Dict[str, int]:
        stem_chs, _, out_chs, _, _, _ = VOVNET_STAGE_SPECS[conv_body]
        d = {"stem": stem_chs[2]}
        for i in range(4):
            d[f"stage{i + 2}"] = out_chs[i]
        return d
