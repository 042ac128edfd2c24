"""Typed configuration tree of the detector, as the PyTorch port reads it.

The port keeps its own copy of the JAX package's ``config.py`` dataclasses
(``faster_orefsdet_tpu/config.py``) so that it imports nothing of that
package. The copy holds the same fields with the same defaults, so that
``dataclasses.asdict`` of a preset here equals the JAX package's
``get_config(name)`` (``tests/test_torch_config.py`` guards that).

Fields named ``use_pallas_*`` name the JAX package's TPU kernels. A kernel
wrapper dispatches on the tensor's device (a CUDA tensor runs the
hand-written kernel, a CPU tensor its plain PyTorch twin), not on a flag.
``use_pallas_cgm`` still selects the path where the JAX package selects it:
the fused CGM with the flag (the serving presets), the differentiable
composition without it (fine-tuning). The NMS flags are not read: the NMS
wrapper is exact on both devices, so every NMS site goes through it.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence, Tuple


@dataclass(frozen=True)
class VoVNetConfig:
    conv_body: str = "V-19-slim-eSE"
    out_features: Tuple[str, ...] = ("stage3", "stage4", "stage5")
    norm: str = "FrozenBN"
    freeze_at: int = 3


@dataclass(frozen=True)
class FPNConfig:
    in_features: Tuple[str, ...] = ("stage3", "stage4", "stage5")
    out_channels: int = 128
    fuse_type: str = "sum"
    top_levels: int = 0  # 0: pure P3-P5
    bifpn_norm: str = "GN"
    bifpn_repeats: int = 4


@dataclass(frozen=True)
class DLAConfig:
    num_layers: int = 34
    norm: str = "BN"


@dataclass(frozen=True)
class CenterNetConfig:
    num_classes: int = 1
    in_features: Tuple[str, ...] = ("p3", "p4", "p5")
    fpn_strides: Tuple[int, ...] = (8, 16, 32)
    sizes_of_interest: Tuple[Tuple[int, int], ...] = ((0, 64), (48, 192), (128, 1000000))
    score_thresh: float = 1e-5
    hm_min_overlap: float = 0.8
    min_radius: int = 4
    hm_focal_alpha: float = 0.25
    hm_focal_beta: float = 4.0
    loss_gamma: float = 2.0
    reg_weight: float = 1.0
    not_norm_reg: bool = True
    with_agn_hm: bool = True
    only_proposal: bool = True
    pos_weight: float = 0.5
    neg_weight: float = 0.5
    sigmoid_clamp: float = 1e-4
    ignore_high_fp: float = 0.85
    loc_loss_type: str = "giou"
    more_pos: bool = False
    more_pos_thresh: float = 0.2
    more_pos_topk: int = 9
    not_nms: bool = False
    pre_nms_topk_train: int = 4000
    post_nms_topk_train: int = 2000
    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 256
    nms_thresh_train: float = 0.9
    nms_thresh_test: float = 0.6
    use_pallas_nms: bool = False
    norm: str = "GN"
    num_cls_convs: int = 1
    num_box_convs: int = 1
    num_share_convs: int = 0
    prior_prob: float = 0.01


@dataclass(frozen=True)
class ROIConfig:
    in_features: Tuple[str, ...] = ("p3", "p4", "p5")
    num_classes: int = 1
    cascade_ious: Tuple[float, ...] = (0.6,)
    cascade_bbox_reg_weights: Tuple[Tuple[float, float, float, float], ...] = (
        (10.0, 10.0, 5.0, 5.0),
    )
    pooler_resolution: int = 8
    pooler_resolution2: int = 4
    pooler_sampling_ratio: int = 0  # 0: adaptive ROIAlignV2 sampling
    canonical_box_size: int = 224
    canonical_level: int = 4
    batch_size_per_image: int = 128
    positive_fraction: float = 0.5
    proposal_append_gt: bool = True
    fc_dim: int = 128
    score_thresh_test: float = 0.0
    nms_thresh_test: float = 0.9
    detections_per_image: int = 100
    use_pallas_nms: bool = False
    mult_proposal_score: bool = False
    cls_agnostic_bbox_reg: bool = True
    smooth_l1_beta: float = 0.0


@dataclass(frozen=True)
class FewShotConfig:
    few_shot: bool = False
    support_way: int = 1
    support_shot: int = 24
    support_crop_size: int = 240


@dataclass(frozen=True)
class InputConfig:
    min_size_train: Tuple[int, ...] = (200, 240, 280, 320, 360, 400, 440)
    max_size_train: int = 1000
    min_size_test: int = 320
    max_size_test: int = 1000
    format: str = "BGR"
    pixel_mean: Tuple[float, float, float] = (103.530, 116.280, 123.675)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    size_divisibility: int = 32
    random_flip: bool = True

    def __post_init__(self):
        if self.size_divisibility < 32 or self.size_divisibility % 32:
            raise ValueError(
                f"size_divisibility={self.size_divisibility}: must be a "
                "positive multiple of 32 (FPN stride contract)"
            )


@dataclass(frozen=True)
class SolverConfig:
    ims_per_batch: int = 1
    base_lr: float = 0.001
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 1e-4
    weight_decay_norm: float = 0.0
    bias_lr_factor: float = 1.0
    head_lr_factor: float = 2.0
    steps: Tuple[int, ...] = (10000, 11000)
    gamma: float = 0.1
    max_iter: int = 12000
    lr_scheduler_name: str = "WarmupMultiStepLR"
    warmup_iters: int = 500
    warmup_factor: float = 0.00025
    warmup_method: str = "linear"
    checkpoint_period: int = 100
    clip_gradients: bool = True
    clip_type: str = "value"
    clip_value: float = 1.0
    norm_type: float = 2.0


@dataclass(frozen=True)
class StaticShapeConfig:
    max_gt_per_image: int = 100
    # candidates entering the decode-stage NMS at test time
    nms_budget_test: int = 1024
    train_canvas: Tuple[int, ...] = (448,)


@dataclass(frozen=True)
class Config:
    model_name: str = "CenterNet2Detector"
    backbone_name: str = "vovnet_fpn"
    # dtype of the convs and dense layers that the JAX package runs in it;
    # box decode, NMS, the ROI predictors and the CGM arithmetic stay f32
    compute_dtype: str = "float32"
    quantize: str = "none"
    use_pallas_cgm: bool = False
    vovnet: VoVNetConfig = field(default_factory=VoVNetConfig)
    dla: DLAConfig = field(default_factory=DLAConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    centernet: CenterNetConfig = field(default_factory=CenterNetConfig)
    roi: ROIConfig = field(default_factory=ROIConfig)
    fs: FewShotConfig = field(default_factory=FewShotConfig)
    input: InputConfig = field(default_factory=InputConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    static: StaticShapeConfig = field(default_factory=StaticShapeConfig)
    train_dataset: str = "coco_2017_train_stone"
    test_dataset: str = "coco_2017_val_stone"
    eval_period: int = 0
    output_dir: str = "./output/fsod/vovnet_25shot"
    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def finetune_vovnet_25shot() -> Config:
    """The published model configuration (configs/fsod/finetune_vovnet.yaml)."""
    return Config()


def finetune_r50_c4_1x() -> Config:
    """configs/fsod/finetune_R_50_C4_1x.yaml: ResNet-50 + FPN (res3-res5 ->
    P3-P5), a 4x4 main ROI pooler, 9 shots, LR steps (10000, 12000)."""
    cfg = Config(backbone_name="resnet_fpn", output_dir="./output/fsod/r50")
    return cfg.replace(
        roi=dataclasses.replace(cfg.roi, pooler_resolution=4),
        fpn=dataclasses.replace(cfg.fpn, in_features=("res3", "res4", "res5")),
        fs=dataclasses.replace(cfg.fs, support_shot=9),
        solver=dataclasses.replace(cfg.solver, steps=(10000, 12000)),
    )


def finetune_dla() -> Config:
    """configs/fsod/finetune_dla.yaml: DLA-34 with trainable BatchNorm +
    BiFPN (160 channels, 4 repeats), a 7x7 main ROI pooler, the decode's
    test NMS at 0.9, 9 shots, LR steps (10000, 12000), 12100 iterations."""
    cfg = Config(backbone_name="dla_bifpn", output_dir="./output/fsod/dla")
    return cfg.replace(
        fpn=dataclasses.replace(cfg.fpn, out_channels=160, in_features=("dla3", "dla4", "dla5")),
        roi=dataclasses.replace(cfg.roi, pooler_resolution=7),
        centernet=dataclasses.replace(cfg.centernet, nms_thresh_test=0.9),
        fs=dataclasses.replace(cfg.fs, support_shot=9),
        solver=dataclasses.replace(cfg.solver, steps=(10000, 12000), max_iter=12100),
    )


def serving_vovnet() -> Config:
    """The published model with the serving knobs on: bf16 compute and the
    fused CGM and NMS kernels."""
    cfg = finetune_vovnet_25shot().replace(compute_dtype="bfloat16", use_pallas_cgm=True)
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, use_pallas_nms=True),
        roi=dataclasses.replace(cfg.roi, use_pallas_nms=True),
    )


def serving_vovnet_fast() -> Config:
    """serving_vovnet with 64 proposals into the ROI stage instead of 256."""
    cfg = serving_vovnet()
    return cfg.replace(centernet=dataclasses.replace(cfg.centernet, post_nms_topk_test=64))


def serving_vovnet_int8() -> Config:
    """serving_vovnet_fast with W8A8 int8 convolutions in the VoVNet backbone
    and the FPN (``ops/quant.py``): int8 weights per output channel, int8
    activations with a dynamic per-example scale, int32 accumulation. The
    weights stay f32, so one checkpoint serves every preset."""
    return serving_vovnet_fast().replace(quantize="int8")


def serving_vovnet_int8_static() -> Config:
    """serving_vovnet_fast with W8A8 int8 convolutions whose activation
    scales were calibrated once (``pipelines/quant_calib.py``) and are fixed
    constants of the request. The builders require act_scales=."""
    return serving_vovnet_fast().replace(quantize="int8_static")


def serving_vovnet_int8_resident() -> Config:
    """serving_vovnet_fast with an int8-resident VoVNet: the stem and OSA
    conv chains pass int8 tensors from conv to conv (each conv's epilogue
    dequantizes, applies FrozenBN and relu, and requantizes with a calibrated
    output scale), and the OSA concat is int8 with the branches' scales folded
    into the concat conv's weights. The FPN keeps the int8_static scheme. The
    builders require act_scales= calibrated with this config."""
    return serving_vovnet_fast().replace(quantize="int8_resident")


def serving_vovnet_turbo() -> Config:
    """serving_vovnet_fast with halved decode budgets: per-level top-k 256
    and a 512-candidate NMS working set."""
    cfg = serving_vovnet_fast()
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=256),
        static=dataclasses.replace(cfg.static, nms_budget_test=512),
    )


_NAMED_CONFIGS = {
    "finetune_vovnet": finetune_vovnet_25shot,
    "finetune_vovnet_25shot": finetune_vovnet_25shot,
    "finetune_R_50_C4_1x": finetune_r50_c4_1x,
    "finetune_dla": finetune_dla,
    "serving_vovnet": serving_vovnet,
    "serving_vovnet_fast": serving_vovnet_fast,
    "serving_vovnet_int8": serving_vovnet_int8,
    "serving_vovnet_int8_static": serving_vovnet_int8_static,
    "serving_vovnet_int8_resident": serving_vovnet_int8_resident,
    "serving_vovnet_turbo": serving_vovnet_turbo,
}

PRESETS = tuple(_NAMED_CONFIGS)


def get_config(name: str = "finetune_vovnet") -> Config:
    try:
        return _NAMED_CONFIGS[name]()
    except KeyError:
        raise KeyError(f"unknown config '{name}'; have {sorted(_NAMED_CONFIGS)}") from None


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Command-line `key=value` overrides with dotted paths, e.g.
    `fs.support_shot=5`: values are Python literals (a bare word stays a
    string), coerced to the field's type where that is unambiguous."""

    def coerce(path: Sequence[str], cur: Any, value: Any) -> Any:
        if cur is None or isinstance(value, type(cur)):
            return value
        where = ".".join(path)
        if isinstance(cur, bool) and isinstance(value, str):
            # yacs-style lowercase bools; a leftover string would be truthy
            low = value.strip().lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
            raise ValueError(f"{where}: not a bool: {value!r}")
        if isinstance(cur, bool) and isinstance(value, int):
            if value in (0, 1):
                return bool(value)
            raise ValueError(f"{where}: not a bool: {value!r}")
        if isinstance(cur, tuple) and isinstance(value, (list, tuple)):
            return tuple(value)
        if isinstance(cur, float) and isinstance(value, int):
            return float(value)
        return value

    def set_path(obj: Any, path: Sequence[str], value: Any) -> Any:
        name = path[0]
        if not hasattr(obj, name):
            raise KeyError(f"config has no field {'.'.join(path)}")
        if len(path) == 1:
            return dataclasses.replace(obj, **{name: coerce(path, getattr(obj, name), value)})
        return dataclasses.replace(obj, **{name: set_path(getattr(obj, name), path[1:], value)})

    for ov in overrides:
        key, _, raw = ov.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        cfg = set_path(cfg, key.strip().split("."), value)
    return cfg
