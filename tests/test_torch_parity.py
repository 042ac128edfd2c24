"""Full-module numerical parity: flax model (with converted weights) vs a
functional torch implementation of the reference math.

We generate a random torch state_dict with the reference checkpoint's exact
key names/shapes (from the golden log model dump :548-805), convert it with
utils.torch_convert, and drive both implementations with identical inputs.
The torch side is written functionally (F.conv2d chains) straight from the
reference equations — covering backbone, FPN, SM block, CenterNet head, CGM
fusion, and the DSA cascade head. ROIAlign + NMS are golden-tested
separately in test_ops_golden.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from faster_orefsdet_tpu.config import get_config
from faster_orefsdet_tpu.pipelines.inference import make_detector
from faster_orefsdet_tpu.utils.params import init_params, param_count
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint

import torch_budget  # noqa: F401 (the suite's torch thread budget)


# ---------------------------------------------------------- synthetic ckpt
def _rand(shape, g, std=None):
    # conv/linear weights get fan-in scaling so activations stay O(1) through
    # the deep chain (keeps the f32-accumulation comparison meaningful)
    if std is None:
        if len(shape) == 4:
            std = 1.0 / np.sqrt(shape[1] * shape[2] * shape[3])
        elif len(shape) == 2:
            std = 1.0 / np.sqrt(shape[1])
        else:
            std = 0.1
    return torch.from_numpy((g.standard_normal(shape) * std).astype(np.float32))


def make_torch_state_dict(seed=0):
    g = np.random.default_rng(seed)
    sd = {}

    def conv_bn(prefix, unit, cin, cout):
        sd[f"{prefix}.{unit}/conv.weight"] = _rand((cout, cin, 3, 3), g)
        sd[f"{prefix}.{unit}/norm.weight"] = _rand((cout,), g) + 1.0
        sd[f"{prefix}.{unit}/norm.bias"] = _rand((cout,), g)
        sd[f"{prefix}.{unit}/norm.running_mean"] = _rand((cout,), g)
        sd[f"{prefix}.{unit}/norm.running_var"] = torch.abs(_rand((cout,), g)) + 0.5

    def conv1x1_bn(prefix, unit, cin, cout):
        sd[f"{prefix}.{unit}/conv.weight"] = _rand((cout, cin, 1, 1), g)
        sd[f"{prefix}.{unit}/norm.weight"] = _rand((cout,), g) + 1.0
        sd[f"{prefix}.{unit}/norm.bias"] = _rand((cout,), g)
        sd[f"{prefix}.{unit}/norm.running_mean"] = _rand((cout,), g)
        sd[f"{prefix}.{unit}/norm.running_var"] = torch.abs(_rand((cout,), g)) + 0.5

    bu = "backbone.bottom_up"
    conv_bn(f"{bu}.stem", "stem_1", 3, 64)
    conv_bn(f"{bu}.stem", "stem_2", 64, 64)
    conv_bn(f"{bu}.stem", "stem_3", 64, 128)
    stage_in = [128, 112, 256, 384]
    conv_ch = [64, 80, 96, 112]
    out_ch = [112, 256, 384, 512]
    for si in range(4):
        stage = si + 2
        mod = f"OSA{stage}_1"
        p = f"{bu}.stage{stage}.{mod}"
        cin = stage_in[si]
        for li in range(3):
            conv_bn(f"{p}.layers.{li}", f"{mod}_{li}", cin if li == 0 else conv_ch[si], conv_ch[si])
        concat_in = stage_in[si] + 3 * conv_ch[si]
        conv1x1_bn(f"{p}.concat", f"{mod}_concat", concat_in, out_ch[si])
        sd[f"{p}.ese.fc.weight"] = _rand((out_ch[si], out_ch[si], 1, 1), g)
        sd[f"{p}.ese.fc.bias"] = _rand((out_ch[si],), g)

    for s, cin in zip((3, 4, 5), (256, 384, 512)):
        sd[f"backbone.fpn_lateral{s}.weight"] = _rand((128, cin, 1, 1), g)
        sd[f"backbone.fpn_lateral{s}.bias"] = _rand((128,), g)
        sd[f"backbone.fpn_output{s}.weight"] = _rand((128, 128, 3, 3), g)
        sd[f"backbone.fpn_output{s}.bias"] = _rand((128,), g)

    hd = "proposal_generator.centernet_head"
    sd[f"{hd}.bbox_tower.0.weight"] = _rand((128, 128, 3, 3), g)
    sd[f"{hd}.bbox_tower.0.bias"] = _rand((128,), g)
    sd[f"{hd}.bbox_tower.1.weight"] = _rand((128,), g) + 1.0
    sd[f"{hd}.bbox_tower.1.bias"] = _rand((128,), g)
    sd[f"{hd}.bbox_pred.weight"] = _rand((4, 128, 3, 3), g)
    sd[f"{hd}.bbox_pred.bias"] = _rand((4,), g) + 8.0
    sd[f"{hd}.agn_hm.weight"] = _rand((1, 128, 3, 3), g)
    sd[f"{hd}.agn_hm.bias"] = _rand((1,), g) - 4.0
    for i in range(3):
        sd[f"{hd}.scales.{i}.scale"] = torch.tensor([1.0 + 0.1 * i])

    for name, cin, cout in (("conv1", 128, 64), ("conv2", 128, 64), ("conv3", 256, 128)):
        sd[f"roi_heads.{name}.weight"] = _rand((cout, cin, 1, 1), g)
        sd[f"roi_heads.{name}.bias"] = _rand((cout,), g)
    sd["roi_heads.box_head.0.fc1.weight"] = _rand((128, 8192), g)
    sd["roi_heads.box_head.0.fc1.bias"] = _rand((128,), g)
    sd["roi_heads.box_predictor.0.cls_score.weight"] = _rand((2, 128), g)
    sd["roi_heads.box_predictor.0.cls_score.bias"] = _rand((2,), g)
    sd["roi_heads.box_predictor.0.bbox_pred.weight"] = _rand((4, 128), g)
    sd["roi_heads.box_predictor.0.bbox_pred.bias"] = _rand((4,), g)

    for lvl in ("p3", "p4", "p5"):
        p = f"vip_{lvl}"
        sd[f"{p}.mlp_h.weight"] = _rand((128, 128), g)
        sd[f"{p}.mlp_w.weight"] = _rand((128, 128), g)
        sd[f"{p}.reweighting.fc1.weight"] = _rand((64, 128), g)
        sd[f"{p}.reweighting.fc1.bias"] = _rand((64,), g)
        sd[f"{p}.reweighting.fc2.weight"] = _rand((256, 64), g)
        sd[f"{p}.reweighting.fc2.bias"] = _rand((256,), g)
        sd[f"{p}.proj.weight"] = _rand((128, 128), g)
        sd[f"{p}.proj.bias"] = _rand((128,), g)

    sd["conv3.weight"] = _rand((128, 256, 1, 1), g)
    sd["conv3.bias"] = _rand((128,), g)
    return sd


# -------------------------------------------------- functional torch fwd
def t_conv_bn(x, sd, prefix, unit, stride=1, k=3):
    w = sd[f"{prefix}.{unit}/conv.weight"]
    x = F.conv2d(x, w, stride=stride, padding=k // 2)
    bw = sd[f"{prefix}.{unit}/norm.weight"]
    bb = sd[f"{prefix}.{unit}/norm.bias"]
    mean = sd[f"{prefix}.{unit}/norm.running_mean"]
    var = sd[f"{prefix}.{unit}/norm.running_var"]
    scale = bw / torch.sqrt(var + 1e-5)
    x = x * scale.view(1, -1, 1, 1) + (bb - mean * scale).view(1, -1, 1, 1)
    return F.relu(x)


def t_vovnet(x, sd):
    bu = "backbone.bottom_up"
    x = t_conv_bn(x, sd, f"{bu}.stem", "stem_1", stride=2)
    x = t_conv_bn(x, sd, f"{bu}.stem", "stem_2")
    x = t_conv_bn(x, sd, f"{bu}.stem", "stem_3", stride=2)
    outs = {}
    for stage in (2, 3, 4, 5):
        if stage != 2:
            x = F.max_pool2d(x, 3, stride=2, ceil_mode=True)
        mod = f"OSA{stage}_1"
        p = f"{bu}.stage{stage}.{mod}"
        chunks = [x]
        h = x
        for li in range(3):
            h = t_conv_bn(h, sd, f"{p}.layers.{li}", f"{mod}_{li}")
            chunks.append(h)
        cat = torch.cat(chunks, dim=1)
        h = t_conv_bn(cat, sd, f"{p}.concat", f"{mod}_concat", k=1)
        gate = F.adaptive_avg_pool2d(h, 1)
        gate = F.conv2d(gate, sd[f"{p}.ese.fc.weight"], sd[f"{p}.ese.fc.bias"])
        gate = F.relu6(gate + 3.0) / 6.0
        x = h * gate
        outs[f"stage{stage}"] = x
    return outs


def t_fpn(bu_outs, sd):
    lat = {
        s: F.conv2d(bu_outs[f"stage{s}"], sd[f"backbone.fpn_lateral{s}.weight"],
                    sd[f"backbone.fpn_lateral{s}.bias"])
        for s in (3, 4, 5)
    }
    prev = lat[5]
    res = {5: prev}
    for s in (4, 3):
        prev = lat[s] + F.interpolate(prev, scale_factor=2.0, mode="nearest")
        res[s] = prev
    return {
        f"p{s}": F.conv2d(res[s], sd[f"backbone.fpn_output{s}.weight"],
                          sd[f"backbone.fpn_output{s}.bias"], padding=1)
        for s in (3, 4, 5)
    }


def t_sm_block(x, sd, prefix, seg_dim):
    # x: [B, H, W, C]; transcribed from fsod_cen.py:598-630
    b, h, w, c = x.shape
    s = c // seg_dim
    he = x.reshape(b, h, w, seg_dim, s).permute(0, 3, 2, 1, 4).reshape(b, seg_dim, w, h * s)
    he = F.linear(he, sd[f"{prefix}.mlp_h.weight"])
    he = he.reshape(b, seg_dim, w, h, s).permute(0, 3, 2, 1, 4).reshape(b, h, w, c)
    we = x.reshape(b, h, w, seg_dim, s).permute(0, 3, 1, 2, 4).reshape(b, seg_dim, h, w * s)
    we = F.linear(we, sd[f"{prefix}.mlp_w.weight"])
    we = we.reshape(b, seg_dim, h, w, s).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
    weight = (he + we).permute(0, 3, 1, 2).flatten(2).mean(2)
    weight = F.linear(weight, sd[f"{prefix}.reweighting.fc1.weight"],
                      sd[f"{prefix}.reweighting.fc1.bias"])
    weight = F.gelu(weight)
    weight = F.linear(weight, sd[f"{prefix}.reweighting.fc2.weight"],
                      sd[f"{prefix}.reweighting.fc2.bias"])
    # [2, B, C] -> softmax over the 2 branches -> [2, B, 1, 1, C]
    weight = weight.reshape(b, c, 2).permute(2, 0, 1).softmax(0).unsqueeze(2).unsqueeze(2)
    x = we * weight[0] + he * weight[1]
    return F.linear(x, sd[f"{prefix}.proj.weight"], sd[f"{prefix}.proj.bias"])


def t_centernet_head(feats, sd):
    hd = "proposal_generator.centernet_head"
    hms, regs = [], []
    for i, f in enumerate(feats):
        bt = F.conv2d(f, sd[f"{hd}.bbox_tower.0.weight"], sd[f"{hd}.bbox_tower.0.bias"],
                      padding=1)
        bt = F.group_norm(bt, 32, sd[f"{hd}.bbox_tower.1.weight"], sd[f"{hd}.bbox_tower.1.bias"])
        bt = F.relu(bt)
        reg = F.conv2d(bt, sd[f"{hd}.bbox_pred.weight"], sd[f"{hd}.bbox_pred.bias"], padding=1)
        reg = reg * sd[f"{hd}.scales.{i}.scale"]
        regs.append(F.relu(reg))
        hms.append(F.conv2d(bt, sd[f"{hd}.agn_hm.weight"], sd[f"{hd}.agn_hm.bias"], padding=1))
    return hms, regs


def t_dsa_stage(q8_nchw, s8_nchw, sd):
    s8 = s8_nchw.expand_as(q8_nchw)
    fused = F.conv2d(torch.cat([q8_nchw, s8], 1), sd["roi_heads.conv3.weight"],
                     sd["roi_heads.conv3.bias"])
    branch = torch.cat(
        [F.conv2d(q8_nchw, sd["roi_heads.conv1.weight"], sd["roi_heads.conv1.bias"]),
         F.conv2d(s8, sd["roi_heads.conv2.weight"], sd["roi_heads.conv2.bias"])], 1)
    attn8 = fused + branch
    x = F.relu(F.linear(attn8.flatten(1), sd["roi_heads.box_head.0.fc1.weight"],
                        sd["roi_heads.box_head.0.fc1.bias"]))
    scores = F.linear(x, sd["roi_heads.box_predictor.0.cls_score.weight"],
                      sd["roi_heads.box_predictor.0.cls_score.bias"])
    deltas = F.linear(x, sd["roi_heads.box_predictor.0.bbox_pred.weight"],
                      sd["roi_heads.box_predictor.0.bbox_pred.bias"])
    return scores, deltas


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def converted():
    cfg = get_config("finetune_vovnet")
    model = make_detector(cfg)
    template = init_params(model, cfg, jax.random.PRNGKey(0))
    sd = make_torch_state_dict()
    params = convert_torch_checkpoint(sd)
    return cfg, model, template, sd, params


def test_converted_tree_matches_init_shapes(converted):
    cfg, model, template, sd, params = converted
    t_flat = {jax.tree_util.keystr(p): v.shape
              for p, v in jax.tree_util.tree_flatten_with_path(template)[0]}
    c_flat = {jax.tree_util.keystr(p): v.shape
              for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert t_flat == c_flat


def test_backbone_fpn_parity(converted):
    cfg, model, template, sd, params = converted
    g = np.random.default_rng(10)
    x = g.standard_normal((1, 64, 96, 3), dtype=np.float32)

    ours = model.apply({"params": params}, jnp.asarray(x), method=model.features)
    ref = t_fpn(t_vovnet(torch.from_numpy(x).permute(0, 3, 1, 2), sd), sd)
    for lvl in ("p3", "p4", "p5"):
        r = ref[lvl].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(np.asarray(ours[lvl]), r, rtol=1e-3, atol=2e-4)


def test_sm_block_parity(converted):
    cfg, model, template, sd, params = converted
    g = np.random.default_rng(11)
    for lvl, size in (("p3", 32), ("p4", 16), ("p5", 8)):
        x = g.standard_normal((2, size, size, 128), dtype=np.float32)
        sup_feats = {
            "p3": jnp.zeros((2, 32, 32, 128)),
            "p4": jnp.zeros((2, 16, 16, 128)),
            "p5": jnp.zeros((2, 8, 8, 128)),
            lvl: jnp.asarray(x),
        }
        ours = model.apply({"params": params}, sup_feats, method=model.refine_support)[lvl]
        ref = t_sm_block(torch.from_numpy(x), sd, f"vip_{lvl}", size)
        # our output has the W/H transpose applied (permute(0,3,2,1) quirk)
        ref_t = ref.permute(0, 2, 1, 3).numpy()  # [B, W, H, C]
        np.testing.assert_allclose(np.asarray(ours), ref_t, rtol=1e-4, atol=1e-5)


def test_centernet_head_parity(converted):
    cfg, model, template, sd, params = converted
    g = np.random.default_rng(12)
    feats = {
        "p3": g.standard_normal((1, 16, 24, 128), dtype=np.float32),
        "p4": g.standard_normal((1, 8, 12, 128), dtype=np.float32),
        "p5": g.standard_normal((1, 4, 6, 128), dtype=np.float32),
    }
    hms, regs = model.apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in feats.items()},
        method=model.proposal_head,
    )
    t_feats = [torch.from_numpy(feats[l]).permute(0, 3, 1, 2) for l in ("p3", "p4", "p5")]
    r_hms, r_regs = t_centernet_head(t_feats, sd)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(hms[i]), r_hms[i].permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(regs[i]), r_regs[i].permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-5)


def test_cgm_conv3_fusion_parity(converted):
    cfg, model, template, sd, params = converted
    g = np.random.default_rng(13)
    q = g.standard_normal((1, 10, 14, 128), dtype=np.float32)
    k1 = g.standard_normal((128,), dtype=np.float32)
    k13 = g.standard_normal((3, 128), dtype=np.float32)
    k31 = g.standard_normal((3, 128), dtype=np.float32)
    kernels = {l: (jnp.asarray(k1), jnp.asarray(k13), jnp.asarray(k31))
               for l in ("p3", "p4", "p5")}
    feats = {"p3": jnp.asarray(q), "p4": jnp.asarray(q), "p5": jnp.asarray(q)}
    ours = model.apply({"params": params}, feats, kernels, method=model.correlate)["p3"]

    qt = torch.from_numpy(q).permute(0, 3, 1, 2)
    w1 = torch.from_numpy(k1).view(128, 1, 1, 1)
    w13 = torch.from_numpy(k13.T.copy()).view(128, 1, 1, 3)
    w31 = torch.from_numpy(k31.T.copy()).view(128, 1, 3, 1)
    c2 = F.relu(F.conv2d(F.relu(F.conv2d(qt, w1, groups=128)), w1, groups=128))
    d2 = F.relu(F.conv2d(F.relu(F.conv2d(qt, w13, padding=(0, 1), groups=128)),
                         w31, padding=(1, 0), groups=128))
    attn = c2 + d2 + qt
    fused = F.relu(F.conv2d(torch.cat([attn, qt], 1), sd["conv3.weight"], sd["conv3.bias"]))
    np.testing.assert_allclose(
        np.asarray(ours), fused.permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-5)


def test_dsa_stage_parity(converted):
    cfg, model, template, sd, params = converted
    g = np.random.default_rng(14)
    # drive roi_stage with a feature map + boxes; compare against torch using
    # OUR pooled features (ROIAlign parity is covered separately)
    from faster_orefsdet_tpu.ops.roi_align import multilevel_roi_align

    feats = [
        jnp.asarray(g.standard_normal((24, 32, 128), dtype=np.float32)),
        jnp.asarray(g.standard_normal((12, 16, 128), dtype=np.float32)),
        jnp.asarray(g.standard_normal((6, 8, 128), dtype=np.float32)),
    ]
    boxes = jnp.asarray([[8.0, 8.0, 120.0, 100.0], [30.0, 20.0, 90.0, 80.0]])
    s8 = g.standard_normal((8, 8, 128), dtype=np.float32)
    s4 = g.standard_normal((4, 4, 128), dtype=np.float32)

    out = model.apply(
        {"params": params}, feats, boxes, jnp.asarray(s8), jnp.asarray(s4), 0,
        method=model.roi_stage,
    )
    q8 = multilevel_roi_align(feats, boxes, [8, 16, 32], 8,
                              cfg.roi.pooler_sampling_ratio)
    q8_t = torch.from_numpy(np.asarray(q8)).permute(0, 3, 1, 2)
    s8_t = torch.from_numpy(s8).permute(2, 0, 1)[None]
    r_scores, r_deltas = t_dsa_stage(q8_t, s8_t, sd)
    # NOTE: torch flattens CHW; the converter permutes fc1 rows to our HWC —
    # outputs must agree exactly.
    np.testing.assert_allclose(np.asarray(out.scores), r_scores.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.deltas), r_deltas.numpy(), rtol=1e-3, atol=1e-4)
