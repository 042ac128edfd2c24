"""Detectron2-style yaml configs with ``_BASE_`` inheritance (counterpart of
``faster_orefsdet_tpu/config_yaml.py``).

The reference configures a run with yacs yamls layered over code defaults
(``configs/fsod/*.yaml``). This module resolves such a file onto the port's
typed ``Config``: the same upper-case dotted keys, the same inheritance (the
child's keys win), the same strictness (a key that is neither mapped nor
listed as ignored is an error).

The card's machine has no PyYAML, so the files are read by ``safe_load``
below: a reader of the YAML subset that the reference's configs use (nested
block mappings, plain and quoted scalars resolved as YAML 1.1 does, flow
lists, comments). Anything outside that subset raises.

``load_yaml`` dispatches on META_ARCHITECTURE: a CenterNet2Detector yaml
gives a ``Config``, ``Base-FSOD-C4.yaml`` alone (FsodRCNN, the AttentionRPN
baseline) a ``pipelines.attention_rpn.BaselineConfig``. ``load_yaml_config``
takes CenterNet2Detector yamls only. Configs whose ROI features are not the
p3/p4/p5 pyramid are dead in the reference (``DeadReferenceConfigError``).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Any, Dict, List, Tuple

from .config import Config


class DeadReferenceConfigError(ValueError):
    """The yaml describes a configuration that cannot run in the reference."""


# d2 dotted key -> Config dotted path
KEY_MAP: Dict[str, str] = {
    "MODEL.VOVNET.CONV_BODY": "vovnet.conv_body",
    "MODEL.VOVNET.OUT_FEATURES": "vovnet.out_features",
    "MODEL.VOVNET.NORM": "vovnet.norm",
    "MODEL.BACKBONE.FREEZE_AT": "vovnet.freeze_at",
    "MODEL.FPN.IN_FEATURES": "fpn.in_features",
    "MODEL.FPN.OUT_CHANNELS": "fpn.out_channels",
    "MODEL.FPN.FUSE_TYPE": "fpn.fuse_type",
    "MODEL.BIFPN.OUT_CHANNELS": "fpn.out_channels",
    "MODEL.BIFPN.NUM_BIFPN": "fpn.bifpn_repeats",
    "MODEL.BIFPN.NORM": "fpn.bifpn_norm",
    "MODEL.DLA.NUM_LAYERS": "dla.num_layers",
    "MODEL.DLA.NORM": "dla.norm",
    "MODEL.FCOS.TOP_LEVELS": "fpn.top_levels",
    "MODEL.ROI_HEADS.IN_FEATURES": "roi.in_features",
    "MODEL.ROI_HEADS.NUM_CLASSES": "roi.num_classes",
    "MODEL.ROI_HEADS.NMS_THRESH_TEST": "roi.nms_thresh_test",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST": "roi.score_thresh_test",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": "roi.batch_size_per_image",
    "MODEL.ROI_HEADS.POSITIVE_FRACTION": "roi.positive_fraction",
    "MODEL.ROI_HEADS.PROPOSAL_APPEND_GT": "roi.proposal_append_gt",
    "MODEL.ROI_BOX_CASCADE_HEAD.IOUS": "roi.cascade_ious",
    "MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS": "roi.cascade_bbox_reg_weights",
    "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": "roi.pooler_resolution",
    "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION2": "roi.pooler_resolution2",
    "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO": "roi.pooler_sampling_ratio",
    "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG": "roi.cls_agnostic_bbox_reg",
    "MODEL.ROI_BOX_HEAD.MULT_PROPOSAL_SCORE": "roi.mult_proposal_score",
    "MODEL.ROI_BOX_HEAD.FC_DIM": "roi.fc_dim",
    "MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA": "roi.smooth_l1_beta",
    "MODEL.CENTERNET.NUM_CLASSES": "centernet.num_classes",
    "MODEL.CENTERNET.IN_FEATURES": "centernet.in_features",
    "MODEL.CENTERNET.FPN_STRIDES": "centernet.fpn_strides",
    "MODEL.CENTERNET.SOI": "centernet.sizes_of_interest",
    "MODEL.CENTERNET.INFERENCE_TH": "centernet.score_thresh",
    "MODEL.CENTERNET.HM_MIN_OVERLAP": "centernet.hm_min_overlap",
    "MODEL.CENTERNET.MIN_RADIUS": "centernet.min_radius",
    "MODEL.CENTERNET.HM_FOCAL_ALPHA": "centernet.hm_focal_alpha",
    "MODEL.CENTERNET.HM_FOCAL_BETA": "centernet.hm_focal_beta",
    "MODEL.CENTERNET.LOSS_GAMMA": "centernet.loss_gamma",
    "MODEL.CENTERNET.REG_WEIGHT": "centernet.reg_weight",
    "MODEL.CENTERNET.NOT_NORM_REG": "centernet.not_norm_reg",
    "MODEL.CENTERNET.WITH_AGN_HM": "centernet.with_agn_hm",
    "MODEL.CENTERNET.ONLY_PROPOSAL": "centernet.only_proposal",
    "MODEL.CENTERNET.POS_WEIGHT": "centernet.pos_weight",
    "MODEL.CENTERNET.NEG_WEIGHT": "centernet.neg_weight",
    "MODEL.CENTERNET.SIGMOID_CLAMP": "centernet.sigmoid_clamp",
    "MODEL.CENTERNET.IGNORE_HIGH_FP": "centernet.ignore_high_fp",
    "MODEL.CENTERNET.LOC_LOSS_TYPE": "centernet.loc_loss_type",
    "MODEL.CENTERNET.MORE_POS": "centernet.more_pos",
    "MODEL.CENTERNET.MORE_POS_THRESH": "centernet.more_pos_thresh",
    "MODEL.CENTERNET.MORE_POS_TOPK": "centernet.more_pos_topk",
    "MODEL.CENTERNET.NOT_NMS": "centernet.not_nms",
    "MODEL.CENTERNET.PRE_NMS_TOPK_TRAIN": "centernet.pre_nms_topk_train",
    "MODEL.CENTERNET.POST_NMS_TOPK_TRAIN": "centernet.post_nms_topk_train",
    "MODEL.CENTERNET.PRE_NMS_TOPK_TEST": "centernet.pre_nms_topk_test",
    "MODEL.CENTERNET.POST_NMS_TOPK_TEST": "centernet.post_nms_topk_test",
    "MODEL.CENTERNET.NMS_TH_TRAIN": "centernet.nms_thresh_train",
    "MODEL.CENTERNET.NMS_TH_TEST": "centernet.nms_thresh_test",
    "MODEL.CENTERNET.NORM": "centernet.norm",
    "MODEL.CENTERNET.NUM_CLS_CONVS": "centernet.num_cls_convs",
    "MODEL.CENTERNET.NUM_BOX_CONVS": "centernet.num_box_convs",
    "MODEL.CENTERNET.NUM_SHARE_CONVS": "centernet.num_share_convs",
    "MODEL.CENTERNET.PRIOR_PROB": "centernet.prior_prob",
    "MODEL.PIXEL_MEAN": "input.pixel_mean",
    "MODEL.PIXEL_STD": "input.pixel_std",
    "INPUT.FS.FEW_SHOT": "fs.few_shot",
    "INPUT.FS.SUPPORT_WAY": "fs.support_way",
    "INPUT.FS.SUPPORT_SHOT": "fs.support_shot",
    "INPUT.MIN_SIZE_TRAIN": "input.min_size_train",
    "INPUT.MAX_SIZE_TRAIN": "input.max_size_train",
    "INPUT.MIN_SIZE_TEST": "input.min_size_test",
    "INPUT.MAX_SIZE_TEST": "input.max_size_test",
    "INPUT.FORMAT": "input.format",
    "SOLVER.IMS_PER_BATCH": "solver.ims_per_batch",
    "SOLVER.BASE_LR": "solver.base_lr",
    "SOLVER.MOMENTUM": "solver.momentum",
    "SOLVER.NESTEROV": "solver.nesterov",
    "SOLVER.WEIGHT_DECAY": "solver.weight_decay",
    "SOLVER.WEIGHT_DECAY_NORM": "solver.weight_decay_norm",
    "SOLVER.BIAS_LR_FACTOR": "solver.bias_lr_factor",
    "SOLVER.HEAD_LR_FACTOR": "solver.head_lr_factor",
    "SOLVER.STEPS": "solver.steps",
    "SOLVER.GAMMA": "solver.gamma",
    "SOLVER.MAX_ITER": "solver.max_iter",
    "SOLVER.LR_SCHEDULER_NAME": "solver.lr_scheduler_name",
    "SOLVER.WARMUP_ITERS": "solver.warmup_iters",
    "SOLVER.WARMUP_FACTOR": "solver.warmup_factor",
    "SOLVER.WARMUP_METHOD": "solver.warmup_method",
    "SOLVER.CHECKPOINT_PERIOD": "solver.checkpoint_period",
    "SOLVER.CLIP_GRADIENTS.ENABLED": "solver.clip_gradients",
    "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "solver.clip_type",
    "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": "solver.clip_value",
    "SOLVER.CLIP_GRADIENTS.NORM_TYPE": "solver.norm_type",
    "OUTPUT_DIR": "output_dir",
    "SEED": "seed",
    "TEST.EVAL_PERIOD": "eval_period",
}

# keys accepted but not mapped, with the reason
IGNORED_KEYS: Dict[str, str] = {
    "MODEL.META_ARCHITECTURE": "selects the config type (load_yaml_config)",
    "MODEL.PROPOSAL_GENERATOR.NAME": "implied by the meta-architecture",
    "MODEL.ROI_HEADS.NAME": "implied by the meta-architecture",
    "MODEL.ROI_HEADS.IOU_THRESHOLDS": "the cascade matcher uses ROI_BOX_CASCADE_HEAD.IOUS (d2 asserts the two equal)",
    "MODEL.ROI_BOX_HEAD.NAME": "the single fc1 head is structural",
    "MODEL.ROI_BOX_HEAD.NUM_FC": "the single fc1 head is structural",
    "MODEL.BACKBONE.NAME": "maps to Config.backbone_name (BACKBONE_BUILDERS)",
    "MODEL.WEIGHTS": "weights load through the train CLI's --init-npz",
    "MODEL.MASK_ON": "no mask head in this detector",
    "MODEL.RESNETS.DEPTH": "the resnet_fpn family is ResNet-50",
    "MODEL.RESNETS.OUT_FEATURES": "fixed res3-res5 for the p3-p5 pyramid",
    "MODEL.BIFPN.NUM_LEVELS": "the BiFPN always takes the dla3-dla5 pyramid",
    "MODEL.RPN.PRE_NMS_TOPK_TEST": "AttentionRPN baseline only",
    "MODEL.RPN.POST_NMS_TOPK_TEST": "AttentionRPN baseline only",
    "DATALOADER.NUM_WORKERS": "the train loader maps on one background thread",
    "VERSION": "yacs schema version tag",
}

# detectron2 BACKBONE.NAME -> Config.backbone_name
BACKBONE_BUILDERS = {
    "build_fcos_vovnet_fpn_backbone": "vovnet_fpn",
    "build_p35_fcos_dla_bifpn_backbone": "dla_bifpn",
    "build_mobilenetV3small_fpn_backbone": "mnv3_fpn",
    "build_p35_resnet_fpn_backbone": "resnet_fpn",
}


# BaselineConfig (FsodRCNN, the AttentionRPN baseline): d2 key -> field
BASELINE_KEY_MAP: Dict[str, str] = {
    "MODEL.RPN.PRE_NMS_TOPK_TEST": "rpn_pre_nms_topk_test",
    "MODEL.RPN.POST_NMS_TOPK_TEST": "rpn_post_nms_topk_test",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN": "rpn_pre_nms_topk_train",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN": "rpn_post_nms_topk_train",
    "MODEL.RPN.NMS_THRESH": "rpn_nms_thresh",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE": "rpn_batch_size",
    "MODEL.RPN.POSITIVE_FRACTION": "rpn_positive_fraction",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": "roi_batch_size",
    "MODEL.ROI_HEADS.POSITIVE_FRACTION": "roi_positive_fraction",
    "MODEL.ROI_HEADS.NUM_CLASSES": "num_classes",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST": "test_score_thresh",
    "MODEL.ROI_HEADS.NMS_THRESH_TEST": "test_nms_thresh",
    "MODEL.RESNETS.DEPTH": "depth",
    "INPUT.FS.SUPPORT_SHOT": "support_shot",
}
# baseline yaml keys without a BaselineConfig field: the training loop's and
# the runtime's (the solver and input settings apply when it is trained)
BASELINE_IGNORED_PREFIXES = (
    "SOLVER.", "INPUT.MIN_SIZE", "INPUT.MAX_SIZE", "INPUT.FS.SUPPORT_WAY",
    "DATASETS.", "DATALOADER.", "MODEL.META_ARCHITECTURE",
    "MODEL.PROPOSAL_GENERATOR.NAME", "MODEL.ROI_HEADS.NAME",
    "MODEL.ROI_HEADS.IOU_THRESHOLDS", "MODEL.BACKBONE.FREEZE_AT",
    "MODEL.WEIGHTS", "VERSION", "OUTPUT_DIR",
)


# ------------------------------------------------------------------ reader
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_NULLS = ("", "~", "null", "Null", "NULL")


def _plain_scalar(s: str) -> Any:
    """A plain scalar resolved by YAML 1.1's implicit types, as PyYAML's
    SafeLoader resolves it: null, bool, decimal int, float, else a string."""
    if s in _NULLS:
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        low = s.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(s.replace("_", ""))
    return s


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i] -> (its value, the index after it)."""
    q = text[i]
    out: List[str] = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = text[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}.get(esc, "\\" + esc))
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {text[i:]!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at the start or after a blank,
    outside quotes."""
    quote, escaped = None, False
    for i, c in enumerate(line):
        if quote:
            if escaped:
                escaped = False
            elif c == "\\" and quote == '"':
                escaped = True
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t:[,"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """One flow node (a list, a quoted or a plain scalar) starting at
    text[i] -> (value, index after it)."""
    while text[i] == " ":
        i += 1
    if text[i] == "[":
        items: List[Any] = []
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == "]":
                return items, i + 1
            item, i = _flow(text, i)
            items.append(item)
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != "]":
                raise ValueError(f"flow list: expected ',' or ']' at {text[i:]!r}")
    if text[i] == "{":
        raise ValueError("flow mappings are outside the supported YAML subset")
    if text[i] in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]":
        j += 1
    return _plain_scalar(text[i:j].strip()), j


def _value(text: str) -> Any:
    """The scalar or flow list after a mapping key."""
    if text[:1] in "'\"[":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after a value: {text!r}")
        return value
    if text[:1] in "{&*!|>%@`" or text[:2] == "- ":
        raise ValueError(f"{text!r} is outside the supported YAML subset")
    return _plain_scalar(text)


def safe_load(text: str) -> Dict[str, Any]:
    """Parse the YAML subset of detectron2 configs into nested dicts: block
    mappings by indentation, `key: value` with a plain, quoted or flow-list
    value, comments and blank lines. Equal to ``yaml.safe_load`` on it."""
    root: Dict[str, Any] = {}
    # (indent of the mapping's keys, the mapping); a key with no value opens
    # a child mapping whose indent is set by its first key
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]
    pending = None  # (parent mapping, key) of a key awaiting its block
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"line {n}: tabs in indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- ") or body == "-":
            raise ValueError(f"line {n}: block sequences are outside the supported YAML subset")
        if pending is not None:
            parent, key = pending
            pending = None
            if indent > stack[-1][0]:
                child: Dict[str, Any] = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"line {n}: inconsistent indentation")
        if body[:1] in "'\"":
            key, end = _quoted(body, 0)
            rest = body[end:].lstrip()
            if not rest.startswith(":"):
                raise ValueError(f"line {n}: expected ':' after a quoted key")
            rest = rest[1:]
        else:
            m = re.match(r"^([^:#]+?)\s*:(\s|$)", body)
            if m is None:
                raise ValueError(f"line {n}: not a 'key: value' line: {body!r}")
            key, rest = m.group(1), body[m.end(1):].lstrip()[1:]
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        rest = rest.strip()
        if rest:
            mapping[key] = _value(rest)
        else:
            pending = (mapping, key)
    if pending is not None:
        pending[0][pending[1]] = None
    return root


# ------------------------------------------------------------------ resolution
def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _deep_merge(base: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in child.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_merged_yaml(path: str) -> Dict[str, Any]:
    """Read a yaml and resolve its `_BASE_` chain (relative to the file; the
    child's keys win, as CfgNode.merge_from_file)."""
    with open(path) as f:
        tree = safe_load(f.read()) or {}
    base_rel = tree.pop("_BASE_", None)
    if base_rel is not None:
        base = load_merged_yaml(os.path.join(os.path.dirname(path), base_rel))
        tree = _deep_merge(base, tree)
    return tree


def _parse_value(v: Any) -> Any:
    """yacs reads tuple-like strings such as `(10000, 11000)` as Python
    literals; yaml leaves them strings."""
    if isinstance(v, str):
        s = v.strip()
        if s[:1] in "([":
            try:
                return ast.literal_eval(s)
            except (ValueError, SyntaxError):
                return v
    return v


def _coerce(cur: Any, value: Any) -> Any:
    """`value` in the shape and type of the field's current value (lists to
    tuples, nested too; ints to floats)."""
    if isinstance(cur, tuple):
        value = tuple(value) if isinstance(value, (list, tuple)) else (value,)
        elem = cur[0] if cur else None
        return tuple(_coerce(elem, v) for v in value)
    if isinstance(cur, bool):
        return bool(value)
    if isinstance(cur, float) and isinstance(value, int):
        return float(value)
    if cur is None and isinstance(value, list):
        return tuple(value)
    return value


def _set_path(obj: Any, path: str, value: Any) -> Any:
    head, _, rest = path.partition(".")
    if rest:
        return dataclasses.replace(obj, **{head: _set_path(getattr(obj, head), rest, value)})
    return dataclasses.replace(obj, **{head: _coerce(getattr(obj, head), value)})


def _config_from_flat(flat: Dict[str, Any]) -> Config:
    meta = flat.get("MODEL.META_ARCHITECTURE", "CenterNet2Detector")
    if meta != "CenterNet2Detector":
        raise ValueError(f"not a CenterNet2Detector yaml (META_ARCHITECTURE={meta!r})")

    roi_feats = _parse_value(flat.get("MODEL.ROI_HEADS.IN_FEATURES", ["p3", "p4", "p5"]))
    if tuple(roi_feats) != ("p3", "p4", "p5"):
        raise DeadReferenceConfigError(
            f"ROI_HEADS.IN_FEATURES={list(roi_feats)}: CenterNet2Detector indexes the p3/p4/p5 features, so "
            "this configuration is dead in the reference too (finetune_dla2.yaml, finetune_R_50_F.yaml)")

    cfg = Config()
    builder = flat.get("MODEL.BACKBONE.NAME")
    if builder is not None:
        if builder not in BACKBONE_BUILDERS:
            raise KeyError(f"unknown BACKBONE.NAME {builder!r}; have {sorted(BACKBONE_BUILDERS)}")
        cfg = cfg.replace(backbone_name=BACKBONE_BUILDERS[builder])

    for key, raw in flat.items():
        value = _parse_value(raw)
        if key in ("DATASETS.TRAIN", "DATASETS.TEST"):
            name = tuple(value)[0] if isinstance(value, (list, tuple)) else value
            cfg = cfg.replace(**{"train_dataset" if key.endswith("TRAIN") else "test_dataset": name})
        elif key in KEY_MAP:
            cfg = _set_path(cfg, KEY_MAP[key], value)
        elif key not in IGNORED_KEYS:
            raise KeyError(f"unmapped config key {key!r}: add it to KEY_MAP or IGNORED_KEYS")
    return cfg


def _baseline_from_flat(flat: Dict[str, Any]):
    from .pipelines.attention_rpn import BaselineConfig

    cfg = BaselineConfig()
    for key, raw in flat.items():
        if key in BASELINE_KEY_MAP:
            field = BASELINE_KEY_MAP[key]
            cfg = dataclasses.replace(cfg, **{field: _coerce(getattr(cfg, field), _parse_value(raw))})
        elif not any(key.startswith(p) or key == p.rstrip(".") for p in BASELINE_IGNORED_PREFIXES):
            raise KeyError(f"unmapped baseline config key {key!r}")
    return cfg


def load_yaml(path: str):
    """A yaml (with its `_BASE_` chain) by its META_ARCHITECTURE: a `Config`,
    or for FsodRCNN a `pipelines.attention_rpn.BaselineConfig`."""
    flat = _flatten(load_merged_yaml(path))
    if flat.get("MODEL.META_ARCHITECTURE", "CenterNet2Detector") == "FsodRCNN":
        return _baseline_from_flat(flat)
    return _config_from_flat(flat)


def load_yaml_config(path: str) -> Config:
    """A CenterNet2Detector yaml (with its `_BASE_` chain) as a `Config`; an
    FsodRCNN yaml raises (``load_yaml`` reads it)."""
    return _config_from_flat(_flatten(load_merged_yaml(path)))
