"""The reference's released weights -> the port's state_dict (counterpart of
``faster_orefsdet_tpu/utils/torch_convert.py``).

The reference's ``model_final.pth`` is a torch state_dict of its
CenterNet2Detector (module tree in
log/fsod_finetune_stone_vovnet_25_test_log.txt:548-805). The port's modules
keep torch's layouts, so a conv or a Linear weight is carried as it is; what
changes:

  FrozenBatchNorm  -> folded affine: scale = w / sqrt(var + eps),
                      bias = b - mean * scale
  1x1 conv         -> Linear: weight [O, I, 1, 1] -> [O, I]
  roi box-head fc1 -> input permuted: torch flattens CHW (c*64 + h*8 + w),
                      the port flattens HWC (h*8C + w*C + c)
  dead params      -> dropped: roi fc2/fc3 (fsod_roi_heads.py:515-516
                      computes and discards them), the meta-arch conv1/conv2
                      (the commented-out branch of fsod_cen.py:244)

Each function returns the port's state_dict (f32 CPU tensors): the same
tensors as ``utils.params.from_jax_params`` of the JAX package's converter
output. The arithmetic runs in the checkpoint's own dtype and is rounded to
f32 once at the end, as the JAX package's does. A state_dict may hold torch
tensors or numpy arrays, bare or in a detectron2 checkpoint's ``{"model": sd}``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..models.bifpn import NODES_3LEVEL
from ..models.dla import DLA_SPECS
from ..models.resnet import RESNET_DEPTH_SPECS
from ..models.vovnet import VOVNET_STAGE_SPECS

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return x.detach().cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _frozen_bn(sd: Mapping, key: str, eps: float = 1e-5) -> StateDict:
    var = _t(sd[key + ".running_var"]) + eps
    # the square root in f64, rounded once: torch's f32 sqrt on the CPU is
    # not always the correctly rounded one that numpy's is
    scale = _t(sd[key + ".weight"]) / torch.sqrt(var.double()).to(var.dtype)
    bias = _t(sd[key + ".bias"]) - _t(sd[key + ".running_mean"]) * scale
    return {"scale": _f32(scale), "bias": _f32(bias)}


def _with_bias(sd: Mapping, key: str, weight: torch.Tensor) -> StateDict:
    out = {"weight": _f32(weight)}
    if key + ".bias" in sd:
        out["bias"] = _f32(_t(sd[key + ".bias"]))
    return out


def _layer(sd: Mapping, key: str) -> StateDict:
    """A conv or Linear as stored (weight, and bias where it has one)."""
    return _with_bias(sd, key, _t(sd[key + ".weight"]))


def _linear_from_1x1_conv(sd: Mapping, key: str) -> StateDict:
    return _with_bias(sd, key, _t(sd[key + ".weight"])[:, :, 0, 0])


def _fc1_permuted(sd: Mapping, key: str, c: int, p: int) -> StateDict:
    """Box-head fc1: its input columns from torch's CHW flatten to HWC."""
    w = _t(sd[key + ".weight"])  # [O, C*P*P], column c*P*P + h*P + w
    return _with_bias(sd, key, w.reshape(w.shape[0], c, p, p).permute(0, 2, 3, 1).reshape(w.shape[0], -1))


def _affine(sd: Mapping, key: str) -> StateDict:
    """GroupNorm's affine: weight / bias -> scale / bias."""
    return {"scale": _f32(_t(sd[key + ".weight"])), "bias": _f32(_t(sd[key + ".bias"]))}


def _flat(tree: Mapping, prefix: str = "") -> StateDict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, Mapping) else {key: v})
    return out


def _conv_unit(sd: Mapping, prefix: str, unit: str) -> Dict:
    """A conv + FrozenBN pair named `<unit>/conv`, `<unit>/norm`."""
    return {"conv": {"weight": _f32(_t(sd[f"{prefix}.{unit}/conv.weight"]))},
            "norm": _frozen_bn(sd, f"{prefix}.{unit}/norm")}


def _vip(sd: Mapping, prefix: str) -> Dict:
    return {
        "mlp_h": {"weight": _f32(_t(sd[f"{prefix}.mlp_h.weight"]))},
        "mlp_w": {"weight": _f32(_t(sd[f"{prefix}.mlp_w.weight"]))},
        "reweight_fc1": _layer(sd, f"{prefix}.reweighting.fc1"),
        "reweight_fc2": _layer(sd, f"{prefix}.reweighting.fc2"),
        "proj": _layer(sd, f"{prefix}.proj"),
    }


def convert_torch_checkpoint(state_dict: Mapping, conv_body: str = "V-19-slim-eSE",
                             num_stages: int = 1) -> StateDict:
    """The reference's VoVNet + FPN detector checkpoint -> the port's
    CenterNet2Detector state_dict."""
    sd = state_dict.get("model", state_dict)
    _, _, _, layer_per_block, blocks, _ = VOVNET_STAGE_SPECS[conv_body]

    bu = "backbone.bottom_up"
    backbone: Dict = {f"stem{i + 1}": _conv_unit(sd, f"{bu}.stem", f"stem_{i + 1}") for i in range(3)}
    for si in range(4):
        stage = si + 2
        for b in range(blocks[si]):
            mod = f"OSA{stage}_{b + 1}"
            prefix = f"{bu}.stage{stage}.{mod}"
            entry = {f"layer{li}": _conv_unit(sd, f"{prefix}.layers.{li}", f"{mod}_{li}")
                     for li in range(layer_per_block)}
            entry["concat"] = _conv_unit(sd, f"{prefix}.concat", f"{mod}_concat")
            entry["ese"] = {"fc": _layer(sd, f"{prefix}.ese.fc")}
            backbone[f"stage{stage}_block{b}"] = entry

    fpn: Dict = {}
    for s in (3, 4, 5):
        fpn[f"lateral{s}"] = _layer(sd, f"backbone.fpn_lateral{s}")
        fpn[f"output{s}"] = _layer(sd, f"backbone.fpn_output{s}")

    hd = "proposal_generator.centernet_head"
    head: Dict = {}
    # bbox_tower: Sequential [conv, GN, ReLU] repeated
    j = ti = 0
    while f"{hd}.bbox_tower.{ti}.weight" in sd:
        head[f"bbox_tower{j}"] = _layer(sd, f"{hd}.bbox_tower.{ti}")
        head[f"bbox_tower{j}_gn"] = _affine(sd, f"{hd}.bbox_tower.{ti + 1}")
        j, ti = j + 1, ti + 3
    head["bbox_pred"] = _layer(sd, f"{hd}.bbox_pred")
    head["agn_hm"] = _layer(sd, f"{hd}.agn_hm")
    si = 0
    while f"{hd}.scales.{si}.scale" in sd:
        head[f"scale{si}"] = {"scale": _f32(_t(sd[f"{hd}.scales.{si}.scale"]))}
        si += 1

    rh = "roi_heads"
    roi: Dict = {f"dsa_conv{i}": _linear_from_1x1_conv(sd, f"{rh}.conv{i}") for i in (1, 2, 3)}
    c = _t(sd[f"{rh}.conv3.weight"]).shape[0]  # FPN channels
    for st in range(num_stages):
        roi[f"stage{st}_fc1"] = _fc1_permuted(sd, f"{rh}.box_head.{st}.fc1", c, 8)
        roi[f"stage{st}_cls"] = _layer(sd, f"{rh}.box_predictor.{st}.cls_score")
        roi[f"stage{st}_bbox"] = _layer(sd, f"{rh}.box_predictor.{st}.bbox_pred")

    return _flat({
        "backbone": backbone, "fpn": fpn, "head": head, "roi": roi,
        **{f"vip_p{lv}": _vip(sd, f"vip_p{lv}") for lv in (3, 4, 5)},
        "cgm_conv3": _linear_from_1x1_conv(sd, "conv3"),
    })


def load_torch_pth(path: str) -> Dict:
    """The checkpoint at `path` as torch.load gives it, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _norm(sd: Mapping, key: str, norm: str, eps: float = 1e-5) -> Dict:
    """A torch norm layer -> the port's: norm="BN" keeps the trainable
    BatchNorm under "bn" (scale, bias and the running mean and var);
    "FrozenBN" folds it into the affine under "norm" (models/dla.py)."""
    if norm == "BN":
        return {"bn": {"scale": _f32(_t(sd[key + ".weight"])), "bias": _f32(_t(sd[key + ".bias"])),
                       "mean": _f32(_t(sd[key + ".running_mean"])), "var": _f32(_t(sd[key + ".running_var"]))}}
    return {"norm": _frozen_bn(sd, key, eps)}


def convert_dla_bifpn_backbone(state_dict: Mapping, num_layers: int = 34, norm: str = "BN",
                               bifpn_repeats: int = 4, out_channels: int = 160) -> StateDict:
    """The reference's DLA-34 + BiFPN checkpoint (the
    CenterNet2_DLA-BiFPN-P3_4x.pth init of finetune_dla.yaml; module tree of
    detectron2.7z!modeling/backbone/dlafpn.py:189-253 under
    `backbone.bottom_up.backbone` and bifpn_fcos.py:152-190 under
    `backbone.repeated_bifpn.{r}`) -> the `backbone.*` and `fpn.*` entries of
    the port's state_dict, the running statistics among them when
    norm="BN"; a full detector's state_dict takes them with ``update``."""
    sd = state_dict.get("model", state_dict)
    levels, channels = DLA_SPECS[num_layers]
    bp = "backbone.bottom_up.backbone"

    def conv_norm(tconv: str, tnorm: str) -> Dict:
        return {"conv": {"weight": _f32(_t(sd[tconv + ".weight"]))}, **_norm(sd, tnorm, norm)}

    def tree(tp: str, lv: int, c_in: int, c_out: int) -> Dict:
        """Tree (dlafpn.py:131-186): tree1 / tree2, + project, + root at lv 1."""
        out: Dict = {}
        if c_in != c_out:
            out["project"] = conv_norm(f"{tp}.project.0", f"{tp}.project.1")
        if lv == 1:
            for name in ("tree1", "tree2"):  # BasicBlock (dlafpn.py:36-64)
                out[name] = {f"conv{i}": conv_norm(f"{tp}.{name}.conv{i}", f"{tp}.{name}.bn{i}") for i in (1, 2)}
            out["root"] = {"conv": conv_norm(f"{tp}.root.conv", f"{tp}.root.bn")}
        else:
            out["tree1"] = tree(f"{tp}.tree1", lv - 1, c_in, c_out)
            out["tree2"] = tree(f"{tp}.tree2", lv - 1, c_out, c_out)
        return out

    backbone: Dict = {"base": conv_norm(f"{bp}.base_layer.0", f"{bp}.base_layer.1")}
    for li, n_convs in enumerate(levels[:2]):
        for i in range(n_convs):
            backbone[f"level{li}_{i}"] = conv_norm(f"{bp}.level{li}.{3 * i}", f"{bp}.level{li}.{3 * i + 1}")
    c_in = channels[1]
    for si in range(2, 6):
        backbone[f"level{si}"] = tree(f"{bp}.level{si}", levels[si], c_in, channels[si])
        c_in = channels[si]

    # BiFPN cells (GroupNorm has no state)
    fpn: Dict = {}
    for r in range(bifpn_repeats):
        tp = f"backbone.repeated_bifpn.{r}"
        cell: Dict = {}
        node_ch = list(channels[3:6] if r == 0 else (out_channels,) * 3)
        for feat_level, offsets in NODES_3LEVEL:
            for off in offsets:
                lname = f"lateral_{off}_f{feat_level}"
                if node_ch[off] != out_channels and lname not in cell:
                    cell[lname] = {"conv": _layer(sd, f"{tp}.{lname}"), "gn": _affine(sd, f"{tp}.{lname}.norm")}
            suffix = f"f{feat_level}_" + "_".join(map(str, offsets))
            cell[f"weights_{suffix}"] = _f32(_t(sd[f"{tp}.weights_{suffix}"]))
            cell[f"output_{suffix}"] = {"conv": {"weight": _f32(_t(sd[f"{tp}.outputs_{suffix}.weight"]))},
                                        "gn": _affine(sd, f"{tp}.outputs_{suffix}.norm")}
            node_ch.append(out_channels)
        fpn[f"repeat{r}"] = cell
    return _flat({"backbone": backbone, "fpn": fpn})



def convert_torchvision_resnet(state_dict: Mapping, depth: int = 50) -> StateDict:
    """A torchvision ResNet state_dict -> the port's ResNet keys: the stem and
    res2-res5 (``stem.*``, ``res2.block0.conv1.*``, ...), which load into a
    ``ResNetC4`` with res5 among its outputs; the ``res5.*`` keys alone load
    into a ``Res5Stage``. torchvision puts a stage's stride on the 3x3 conv:
    build the model with stride_in_1x1=False."""
    sd = state_dict.get("model", state_dict)
    blocks = RESNET_DEPTH_SPECS[depth]

    def conv_bn(conv_key: str, bn_key: str) -> Dict:
        return {"conv": {"weight": _f32(_t(sd[conv_key + ".weight"]))}, "norm": _frozen_bn(sd, bn_key)}

    tree: Dict = {"stem": conv_bn("conv1", "bn1")}
    for si, layer in enumerate(("layer1", "layer2", "layer3", "layer4")):
        stage: Dict = {}
        for b in range(blocks[si]):
            p = f"{layer}.{b}"
            entry = {f"conv{i}": conv_bn(f"{p}.conv{i}", f"{p}.bn{i}") for i in (1, 2, 3)}
            if f"{p}.downsample.0.weight" in sd:
                entry["shortcut"] = conv_bn(f"{p}.downsample.0", f"{p}.downsample.1")
            stage[f"block{b}"] = entry
        tree[f"res{si + 2}"] = stage
    return _flat(tree)
