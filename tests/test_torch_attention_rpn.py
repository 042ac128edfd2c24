"""The AttentionRPN baseline (FsodRCNN over ResNet-50 C4) in the port
against the JAX package, on the CPU: anchors, every FsodRCNN phase, the
RPN's labels, losses and proposals, the hard-negative CE, the support
cache, per-class inference and the episodic training loss with its
gradients.

Weights: the JAX package's `init_fsod_rcnn_params`, with the FrozenBN
affines drawn near 1 / 0 and the relation head's three score layers and its
box layer scaled by 1e-2 (at the init's scale every foreground probability
is 1.0, which would hide a wrong score, and the boxes clip to lines),
carried across by the port's `from_jax_params`.
Sizes: queries 96x128, 2 shots of 64x64, as tests/test_attention_rpn.py.
Cache, inference and value_and_grad of the loss are one jit of the JAX side.

Randomness: the anchor and ROI samplers draw with jax.random on one side
and a torch.Generator on the other, so the loss is held where no draw
matters: rpn_batch_size above the image's 720 anchors keeps every labelled
anchor; 4 proposals and 4 gt slots keep every ROI candidate (8 slots), and
with two of the proposals as the gt boxes at most 2 candidates are
background, which the hard-negative CE takes all of in either half (it
takes min(num_fg, n / 4) = 2 there), so neither the slot order nor the
ranks by foreground probability matter. The JAX losses are shown equal
under two keys (to 1e-6: the slot order changes the order of a sum). The
port's `injected_rois` hook, given the same candidates in their own order,
gives the same losses. The biases of the layers that a softmax or a mean over tokens
cancels (ZERO_GRAD) have a gradient of 0 up to rounding in both packages.

Tolerances: phases within 1e-4 of each output's largest |value|; anchors,
labels and the proposals' selected scores exact; rpn_losses and
hard_negative_ce rtol 1e-5; cache rtol 1e-3 / atol 2e-4; detections
greedy-matched (>= 85% at IoU >= 0.95, top 10 matched, |dscore| <= 2e-4);
losses rtol 1e-4; gradients within 1e-3 of each tensor's largest |grad|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.models import attention_rpn as jarpn
from faster_orefsdet_tpu.pipelines import attention_rpn as jpipe
from faster_orefsdet_tpu.pipelines.train_step import TrainBatch as JaxBatch
from faster_orefsdet_tpu.structures.instances import GroundTruth as JaxGT
from faster_orefsdet_tpu_torch.models import attention_rpn as tarpn
from faster_orefsdet_tpu_torch.ops.roi_align import roi_align
from faster_orefsdet_tpu_torch.pipelines import attention_rpn as tpipe
from faster_orefsdet_tpu_torch.pipelines.train_step import TrainBatch
from faster_orefsdet_tpu_torch.structures.instances import GroundTruth
from faster_orefsdet_tpu_torch.utils.params import from_jax_params, init_baseline_params
from test_torch_dla import assert_close_of_largest
from test_torch_resnet import perturb_norms
from test_torch_slice import _assert_detections_match, _np
import torch_budget  # noqa: F401 (the suite's torch thread budget)

OUT_TOL = 1e-4
RTOL = 1e-5
CACHE_TOL = dict(rtol=1e-3, atol=2e-4)
LOSS_RTOL, GRAD_TOL = 1e-4, 1e-3
SMALL = dict(rpn_pre_nms_topk_test=128, rpn_post_nms_topk_test=32, rpn_pre_nms_topk_train=128,
             rpn_post_nms_topk_train=4, rpn_batch_size=1024, roi_batch_size=32, detections_per_image=10,
             support_shot=2)
QUERY_HW, SUPPORT_HW, GT_SLOTS = (96, 128), (64, 64), 4
ZERO_GRAD = ("rpn_enhance.channel_k.bias", "rcnn_enhance.channel_k.bias", "channel_attention.ch_wq.bias",
             "relation_head.adapt_k.bias", "relation_head.adapt_q.bias")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def base():
    jcfg, cfg = jpipe.BaselineConfig(**SMALL), tpipe.BaselineConfig(**SMALL)
    jmodel = jpipe.make_fsod_rcnn(jcfg)
    params = perturb_norms(jax.jit(lambda key: jpipe.init_fsod_rcnn_params(jmodel, key))(jax.random.PRNGKey(0)), 1)
    for name in ("cls_score_cor", "cls_score_fc", "cls_score_pr", "bbox_pred_cor"):
        params["relation_head"][name] = {k: v * 0.01 for k, v in params["relation_head"][name].items()}
    sd = from_jax_params(params)
    model = tpipe.make_fsod_rcnn(cfg, sd, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params, sd=sd, model=model)


def japply(base, method, *args):
    m = base["jmodel"]
    return m.apply({"params": base["params"]}, *map(jnp.asarray, args), method=getattr(m, method))


def test_init_tree_loads_strictly(base):
    """init_fsod_rcnn_params' tree is the port's state_dict, leaf for leaf;
    the LayerNorm keeps flax's names and epsilon; the port's own init has
    the same keys and shapes."""
    model = tpipe.make_fsod_rcnn(base["cfg"], device="cpu")
    assert set(base["sd"]) == set(model.state_dict())
    assert {"channel_attention.ln.scale", "channel_attention.ln.bias"} <= set(base["sd"])
    assert model.channel_attention.ln.eps == 1e-6
    own = init_baseline_params(50, seed=0)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in base["sd"].items()}
    assert torch.allclose(own["channel_attention.ln.scale"].mean(), torch.tensor(1.0), atol=0.05)


@pytest.mark.parametrize("feat_hw", [(2, 3), (6, 8), (38, 50)])
def test_anchors_match_jax(feat_hw):
    got = tarpn.generate_anchors(feat_hw, 16)
    assert got.shape == (feat_hw[0] * feat_hw[1] * 15, 4)
    assert np.array_equal(got.numpy(), np.asarray(jarpn.generate_anchors(feat_hw, 16)))


def test_positional_encoding_matches_jax():
    for n, d in ((196, 1024), (49, 2048), (49, 1024)):
        assert np.array_equal(tarpn.positional_encoding_table(n, d).numpy(),
                              np.asarray(jarpn.positional_encoding_table(n, d)))


def test_features_match_jax(base):
    x = np.random.default_rng(2).standard_normal((1, *QUERY_HW, 3)).astype(np.float32)
    with torch.no_grad():
        got = base["model"].features(nchw(x))
    assert tuple(got.shape) == (1, 1024, 6, 8)
    assert_close_of_largest(got.permute(0, 2, 3, 1).numpy(), np.asarray(japply(base, "features", x)), OUT_TOL,
                            "res4")


@pytest.mark.parametrize("which,shape", [("rpn", (2, 196, 1024)), ("rcnn", (2, 49, 2048))])
def test_enhance_support_matches_jax(base, which, shape):
    """The shot-mean map with its spatial axes swapped: the random tokens
    give a map that is not symmetric, so a missing swap would show."""
    tokens = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        got = getattr(base["model"], f"enhance_support_{which}")(t(tokens))
    ref = np.asarray(japply(base, f"enhance_support_{which}", tokens))
    assert got.shape == ref.shape
    assert not np.allclose(ref, ref.transpose(0, 2, 1, 3), atol=1e-3)
    assert_close_of_largest(got.numpy(), ref, OUT_TOL, which)


@pytest.mark.parametrize("query_hw", [(6, 8), (20, 27)])
def test_rpn_attention_and_head_match_jax(base, query_hw):
    """rpn_attention (the query pooled to 14x14, also from 20x27, which 14
    divides in neither axis) and rpn_head's logits and deltas in anchor
    order."""
    g = np.random.default_rng(4)
    q = g.standard_normal((1, *query_hw, 1024)).astype(np.float32)
    sup = g.standard_normal((1, 14, 14, 1024)).astype(np.float32)
    with torch.no_grad():
        pos = base["model"].rpn_attention(nchw(q), t(sup))
        logits, deltas = base["model"].rpn_head(pos)
    jpos = japply(base, "rpn_attention", q, sup)
    jlogits, jdeltas = japply(base, "rpn_head", jpos)
    assert_close_of_largest(pos.permute(0, 2, 3, 1).numpy(), np.asarray(jpos), OUT_TOL, "attention")
    assert logits.shape == (1, query_hw[0] * query_hw[1] * 15) and deltas.shape == (*logits.shape, 4)
    assert_close_of_largest(logits[0].numpy(), np.asarray(jlogits), OUT_TOL, "logits")
    assert_close_of_largest(deltas[0].numpy(), np.asarray(jdeltas), OUT_TOL, "deltas")


def test_res5_and_relation_match_jax(base):
    g = np.random.default_rng(5)
    pooled = g.standard_normal((3, 14, 14, 1024)).astype(np.float32)
    sup = np.abs(g.standard_normal((1, 7, 7, 2048))).astype(np.float32)
    with torch.no_grad():
        feats = base["model"].res5_transform(t(pooled))
        pred = base["model"].relation(feats, t(sup))
    jfeats = japply(base, "res5_transform", pooled)
    jpred = japply(base, "relation", jfeats, sup)
    assert_close_of_largest(feats.numpy(), np.asarray(jfeats), OUT_TOL, "res5")
    assert_close_of_largest(pred.scores.numpy(), np.asarray(jpred.scores), OUT_TOL, "scores")
    assert_close_of_largest(pred.deltas.numpy(), np.asarray(jpred.deltas), OUT_TOL, "deltas")


def rpn_inputs(seed, feat_hw=(6, 8)):
    g = np.random.default_rng(seed)
    k = feat_hw[0] * feat_hw[1] * 15
    gt = np.zeros((GT_SLOTS, 4), np.float32)
    gt[0], gt[1] = [10, 12, 70, 80], [40, 20, 120, 90]
    valid = np.asarray([True, True, False, False])
    logits = g.standard_normal(k).astype(np.float32)
    deltas = (0.2 * g.standard_normal((k, 4))).astype(np.float32)
    return gt, valid, logits, deltas


def test_rpn_labels_and_losses_match_jax():
    """Labels exact where sampling keeps every labelled anchor (720 anchors,
    batch 1024), then the losses on the same inputs."""
    gt, valid, logits, deltas = rpn_inputs(6)
    anchors = tarpn.generate_anchors((6, 8), 16)
    jlabels, jmatched = jarpn.rpn_label_anchors(jnp.asarray(anchors.numpy()), JaxGT(
        jnp.asarray(gt), jnp.zeros(GT_SLOTS, jnp.int32), jnp.asarray(valid)), jax.random.PRNGKey(1), batch_size=1024)
    labels, matched = tarpn.rpn_label_anchors(anchors, GroundTruth(t(gt), torch.zeros(GT_SLOTS), torch.from_numpy(valid)),
                                              torch.Generator().manual_seed(1), batch_size=1024)
    assert np.array_equal(labels.numpy(), np.asarray(jlabels))
    assert np.array_equal(matched.numpy(), np.asarray(jmatched))
    assert (labels == 1).sum() > 0 and (labels == -1).sum() > 0 and (labels == 0).sum() > 0
    got = tarpn.rpn_losses(anchors, t(logits), t(deltas), labels, matched, 256)
    ref = jarpn.rpn_losses(jnp.asarray(anchors.numpy()), jnp.asarray(logits), jnp.asarray(deltas), jlabels, jmatched,
                           256)
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL, err_msg=k)


def test_rpn_label_sampling_caps_the_batch():
    """Below the labelled count the sampler keeps batch_size anchors, at most
    half of them positive, whatever the generator draws."""
    gt, valid, _, _ = rpn_inputs(6)
    anchors = tarpn.generate_anchors((6, 8), 16)
    for seed in (0, 1):
        labels, _ = tarpn.rpn_label_anchors(anchors, GroundTruth(t(gt), torch.zeros(GT_SLOTS),
                                                                 torch.from_numpy(valid)),
                                            torch.Generator().manual_seed(seed), batch_size=64)
        assert int((labels >= 0).sum()) == 64 and int((labels == 1).sum()) <= 32


@pytest.mark.parametrize("pre,post", [(128, 32), (720, 100)])
def test_rpn_predict_proposals_matches_jax(pre, post):
    """The kept set exact (the selected scores are the logits themselves),
    boxes within 1e-4; a batch of two images is each image alone."""
    _, _, logits, deltas = rpn_inputs(7)
    anchors = tarpn.generate_anchors((6, 8), 16)
    hw = np.asarray([90.0, 120.0], np.float32)
    ref = jarpn.rpn_predict_proposals(jnp.asarray(anchors.numpy()), jnp.asarray(logits), jnp.asarray(deltas),
                                      jnp.asarray(hw), pre_nms_topk=pre, post_nms_topk=post, nms_thresh=0.7)
    got = tarpn.rpn_predict_proposals(anchors, t(logits), t(deltas), t(hw), pre_nms_topk=pre, post_nms_topk=post,
                                      nms_thresh=0.7)
    assert np.array_equal(got.scores.numpy(), np.asarray(ref.scores))
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=1e-5, atol=1e-4)
    both = tarpn.rpn_predict_proposals(anchors, torch.stack([t(logits), -t(logits)]), torch.stack([t(deltas)] * 2),
                                       t(hw), pre_nms_topk=pre, post_nms_topk=post, nms_thresh=0.7)
    assert torch.equal(both.scores[0], got.scores) and torch.equal(both.boxes[0], got.boxes)


@pytest.mark.parametrize("n_fg", [0, 2, 5])
def test_hard_negative_ce_matches_jax(n_fg):
    g = np.random.default_rng(8 + n_fg)
    n = 32
    scores = (2 * g.standard_normal((n, 2))).astype(np.float32)
    gt = np.ones(n, np.int32)
    gt[g.choice(n, n_fg, replace=False)] = 0
    valid = g.uniform(size=n) < 0.9
    ref = float(jpipe.hard_negative_ce(jnp.asarray(scores), jnp.asarray(gt), jnp.asarray(valid)))
    got = tpipe.hard_negative_ce(t(scores), torch.from_numpy(gt), torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), ref, rtol=RTOL)
    batched = tpipe.hard_negative_ce(torch.stack([t(scores)] * 2), torch.from_numpy(np.stack([gt] * 2)),
                                     torch.from_numpy(np.stack([valid] * 2)))
    assert torch.equal(batched, torch.stack([got] * 2))


def support_inputs(seed):
    g = np.random.default_rng(seed)
    sup = g.standard_normal((2, *SUPPORT_HW, 3)).astype(np.float32)
    return sup, np.asarray([[4.0, 4.0, 60.0, 60.0], [6.0, 2.0, 50.0, 58.0]], np.float32)


def train_inputs(seed, model, cfg):
    """One query, its 2 shots, and as its 2 gt boxes the first and third of
    the 4 training proposals that the model gives it (the RPN draws nothing)."""
    g = np.random.default_rng(seed)
    images = g.standard_normal((1, *QUERY_HW, 3)).astype(np.float32)
    sup, sup_boxes = support_inputs(seed + 1)
    with torch.no_grad():
        res4 = model.features(nchw(images))
        pooled = roi_align(model.features(nchw(sup)), t(sup_boxes)[:, None], 1.0 / cfg.stride,
                                 cfg.pooler_resolution, cfg.sampling_ratio)[:, 0]
        logits, deltas = model.rpn_head(model.rpn_attention(res4, model.enhance_support_rpn(pooled.reshape(2, 196, -1))))
        props = tarpn.rpn_predict_proposals(tarpn.generate_anchors((6, 8), cfg.stride), logits[0], deltas[0],
                                            t(QUERY_HW), pre_nms_topk=cfg.rpn_pre_nms_topk_train,
                                            post_nms_topk=cfg.rpn_post_nms_topk_train, nms_thresh=cfg.rpn_nms_thresh)
    assert props.valid.all()
    gt = np.zeros((1, GT_SLOTS, 4), np.float32)
    gt[0, :2] = props.boxes[[0, 2]].numpy()
    gtv = np.zeros((1, GT_SLOTS), bool)
    gtv[0, :2] = True
    return dict(images=images, hw=np.asarray([QUERY_HW], np.float32), gt=gt, gtv=gtv, sup=sup[None],
                sup_boxes=sup_boxes[None], proposals=props.boxes.numpy())


@pytest.fixture(scope="module")
def pipes(base):
    """One jit of the JAX side (the cache, inference on it, value_and_grad
    of baseline_loss_fn), run under two keys; the port on the CPU."""
    jcfg, jmodel, cfg = base["jcfg"], base["jmodel"], base["cfg"]
    sup, sup_boxes = support_inputs(9)
    img = np.random.default_rng(10).standard_normal((*QUERY_HW, 3)).astype(np.float32)
    x = train_inputs(11, base["model"], cfg)
    jbatch = JaxBatch(*map(jnp.asarray, (x["images"], x["hw"], x["gt"], np.zeros((1, GT_SLOTS), np.int32), x["gtv"],
                                         x["sup"], x["sup_boxes"])))

    @jax.jit
    def run(params, key):
        cache = jpipe.build_baseline_cache(jmodel, params, jnp.asarray(sup), jnp.asarray(sup_boxes), jcfg)
        det = jpipe.baseline_inference_single(jmodel, params, cache, jnp.asarray(img), jnp.asarray(QUERY_HW, jnp.float32),
                                              jcfg)
        (total, losses), grads = jax.value_and_grad(
            lambda p: jpipe.baseline_loss_fn(p, jbatch, jmodel, jcfg, key), has_aux=True)(params)
        return cache, det, total, losses, grads

    cache, det, total, losses, grads = jax.tree.map(np.asarray, run(base["params"], jax.random.PRNGKey(0)))
    other_key_losses = jax.tree.map(float, run(base["params"], jax.random.PRNGKey(1))[3])

    model = base["model"]
    pcache = tpipe.build_baseline_cache(cfg, base["sd"], nchw(sup), t(sup_boxes), device="cpu")
    pdet = tpipe.build_baseline_inference_fn(cfg, base["sd"], device="cpu")(pcache, t(img).permute(2, 0, 1),
                                                                           QUERY_HW)
    pinned = tpipe.build_pinned_baseline_inference_fn(cfg, base["sd"], pcache, device="cpu")(
        t(img).permute(2, 0, 1), QUERY_HW)
    train = tpipe.make_fsod_rcnn(cfg, base["sd"], device="cpu").train()
    batch = TrainBatch(nchw(x["images"]), t(x["hw"]), t(x["gt"]), torch.zeros(1, GT_SLOTS, dtype=torch.int32),
                       torch.from_numpy(x["gtv"]), t(x["sup"]).permute(0, 1, 4, 2, 3), t(x["sup_boxes"]))
    ptotal, plosses = tpipe.baseline_loss_fn(train, batch, cfg, torch.Generator().manual_seed(3))
    ptotal.backward()
    rois = torch.cat([t(x["proposals"]), t(x["gt"][0])])[None]  # the candidates, proposals first
    roi_valid = torch.cat([torch.ones(len(x["proposals"]), dtype=torch.bool), torch.from_numpy(x["gtv"][0])])[None]
    with torch.no_grad():
        _, injected = tpipe.baseline_loss_fn(train, batch, cfg, torch.Generator().manual_seed(4),
                                             injected_rois=(rois, roi_valid))
    return dict(cache=cache, det=det, jtotal=float(total), jlosses={k: float(v) for k, v in losses.items()},
                other_key_losses=other_key_losses, jgrads=from_jax_params(grads), pcache=pcache, pdet=pdet,
                pinned=pinned,
                total=float(ptotal.detach()), losses={k: float(v.detach()) for k, v in plosses.items()}, train=train,
                injected={k: float(v) for k, v in injected.items()})


def test_cache_matches_jax(pipes):
    assert tuple(pipes["pcache"].res4_avg.shape) == (1, 1, 14, 14, 1024)
    assert tuple(pipes["pcache"].res5_avg.shape) == (1, 1, 7, 7, 2048)
    for got, ref, name in zip(pipes["pcache"], pipes["cache"], ("res4_avg", "res5_avg")):
        np.testing.assert_allclose(got.numpy(), ref, **CACHE_TOL, err_msg=name)


def _assert_matches_jax_inference(det, pipes):
    got = _np(det)
    ref = {k: np.asarray(getattr(pipes["det"], k)) for k in ("boxes", "scores", "valid")}
    assert 0.05 < ref["scores"][ref["valid"]].min() and ref["scores"].max() < 0.999  # not saturated
    _assert_detections_match(got, ref)
    assert np.array_equal(det.classes.numpy(), np.asarray(pipes["det"].classes))


def test_inference_matches_jax(pipes):
    _assert_matches_jax_inference(pipes["pdet"], pipes)


def test_pinned_inference_matches_jax(pipes):
    """build_pinned_baseline_inference_fn (the cache fixed at build time; on
    the CPU the eager path) against the JAX package's jitted
    baseline_inference_single (its jitted builder's program)."""
    _assert_matches_jax_inference(pipes["pinned"], pipes)


def test_loss_matches_jax(pipes):
    p = pipes
    assert set(p["losses"]) == set(p["jlosses"]) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    for k, ref in p["jlosses"].items():
        np.testing.assert_allclose(p["other_key_losses"][k], ref, rtol=1e-6, err_msg=k)  # no draw matters
        assert np.isfinite(ref) and ref != 0.0, k
        np.testing.assert_allclose(p["losses"][k], ref, rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(p["injected"][k], ref, rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(p["total"], p["jtotal"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("part", ["backbone", "rpn_head_mod", "res5", "relation_head", "rpn_enhance",
                                  "rcnn_enhance", "channel_attention"])
def test_loss_gradients_match_jax(pipes, part):
    checked = 0
    for name, param in pipes["train"].named_parameters():
        if not name.startswith(part + "."):
            continue
        ref = pipes["jgrads"][name]
        assert param.grad is not None, name
        if name in ZERO_GRAD:
            weight = float(pipes["jgrads"][name[:-len("bias")] + "weight"].abs().max())
            assert max(float(ref.abs().max()), float(param.grad.abs().max())) <= 1e-6 * weight, name
            checked += 1
            continue
        scale = float(ref.abs().max())
        err = float((param.grad - ref).abs().max())
        assert err <= GRAD_TOL * scale, f"{name}: max err {err:.3e}, largest |grad| {scale:.3e}"
        checked += 1
    assert checked > 0
