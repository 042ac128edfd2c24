"""The port's training ops against the JAX package's on the CPU, on seeded
inputs: the five losses, the CenterNet targets and MORE_POS mining (integer
outputs exact, floats within 1e-5), box encoding, the proposal matcher, the
stage and CenterNet losses, and the training decode; the ROI sampler by its
properties (its random draws come from a torch.Generator, not JAX's keys)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.models import cascade_roi as jroi
from faster_orefsdet_tpu.models import centernet as jcn
from faster_orefsdet_tpu.ops import heatmap as jhm
from faster_orefsdet_tpu.ops import losses as jl
from faster_orefsdet_tpu.structures import boxes as jboxes
from faster_orefsdet_tpu.structures.instances import GroundTruth as JaxGroundTruth
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models import cascade_roi, centernet
from faster_orefsdet_tpu_torch.ops import heatmap, losses
from faster_orefsdet_tpu_torch.structures import boxes
from faster_orefsdet_tpu_torch.structures.instances import GroundTruth

import torch_budget  # noqa: F401 (the suite's torch thread budget)

TOL = dict(rtol=1e-5, atol=1e-5)
CANVAS = (96, 128)
STRIDES = (8, 16, 32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(ref), **(tol or TOL))


def gt_set(g, b=2, n=6):
    """b images of n padded gt boxes on the canvas, the last ones invalid,
    spanning the three levels' size ranges."""
    xy = g.uniform(0, 90, (b, n, 2)).astype(np.float32)
    wh = g.uniform(6, 120, (b, n, 2)).astype(np.float32)
    gtb = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[:, -2:] = False
    valid[1, 0] = False
    return gtb, valid


# ------------------------------------------------------------------ losses

def test_binary_heatmap_focal_loss():
    g = np.random.default_rng(0)
    logits = (3 * g.standard_normal((2, 300))).astype(np.float32)
    targets = g.uniform(0, 1, (2, 300)).astype(np.float32)
    pos = g.integers(0, 300, (2, 12))
    pmask = g.uniform(size=(2, 12)) < 0.7
    hm = g.uniform(size=(2, 300)) < 0.9
    for ihf in (-1.0, 0.85):
        got = losses.binary_heatmap_focal_loss(t(logits), t(targets), t(pos), t(pmask), t(hm), ignore_high_fp=ihf)
        for i in range(2):
            ref = jl.binary_heatmap_focal_loss(jnp.asarray(logits[i]), jnp.asarray(targets[i]), jnp.asarray(pos[i]),
                                               jnp.asarray(pmask[i]), jnp.asarray(hm[i]), ignore_high_fp=ihf)
            close(got[0][i], ref[0])
            close(got[1][i], ref[1])


@pytest.mark.parametrize("alpha", [0.25, -1.0])
def test_heatmap_focal_loss(alpha):
    g = np.random.default_rng(1)
    logits = (2 * g.standard_normal((2, 200, 3))).astype(np.float32)
    targets = g.uniform(0, 1, (2, 200, 3)).astype(np.float32)
    pos = g.integers(0, 200, (2, 9))
    labels = g.integers(0, 3, (2, 9))
    pmask = g.uniform(size=(2, 9)) < 0.7
    hm = g.uniform(size=(2, 200)) < 0.9
    got = losses.heatmap_focal_loss(t(logits), t(targets), t(pos), t(labels), t(pmask), t(hm), alpha=alpha,
                                    ignore_high_fp=0.85)
    for i in range(2):
        ref = jl.heatmap_focal_loss(*(jnp.asarray(a[i]) for a in (logits, targets, pos, labels, pmask, hm)),
                                    alpha=alpha, ignore_high_fp=0.85)
        close(got[0][i], ref[0])
        close(got[1][i], ref[1])


@pytest.mark.parametrize("loss_type", ["giou", "iou", "linear_iou"])
def test_iou_loss_ltrb(loss_type):
    g = np.random.default_rng(2)
    pred = g.uniform(0, 20, (3, 50, 4)).astype(np.float32)
    target = g.uniform(0, 20, (3, 50, 4)).astype(np.float32)
    target[0, :5] = 0.0  # rows without a target
    weight = (g.uniform(size=(3, 50)) < 0.8).astype(np.float32)
    got = losses.iou_loss_ltrb(t(pred), t(target), t(weight), loss_type=loss_type)
    ref = jl.iou_loss_ltrb(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight), loss_type=loss_type)
    close(got, ref)
    close(losses.iou_loss_ltrb(t(pred), t(target), loss_type=loss_type),
          jl.iou_loss_ltrb(jnp.asarray(pred), jnp.asarray(target), loss_type=loss_type))


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_smooth_l1_and_cross_entropy(beta):
    g = np.random.default_rng(3)
    a, b = g.standard_normal((2, 4, 30, 4)).astype(np.float32)
    close(losses.smooth_l1_loss(t(a), t(b), beta), jl.smooth_l1_loss(jnp.asarray(a), jnp.asarray(b), beta))
    logits = g.standard_normal((3, 40, 2)).astype(np.float32)
    labels = g.integers(0, 2, (3, 40))
    valid = g.uniform(size=(3, 40)) < 0.6
    valid[2] = False  # no valid row: 0
    got = losses.softmax_cross_entropy(t(logits), t(labels), t(valid))
    for i in range(3):
        close(got[i], jl.softmax_cross_entropy(jnp.asarray(logits[i]), jnp.asarray(labels[i]),
                                               jnp.asarray(valid[i])))


# ------------------------------------------------------------------ boxes

def test_encode_deltas_and_nonempty():
    g = np.random.default_rng(4)
    src, tgt = gt_set(g, 3, 20)[0], gt_set(g, 3, 20)[0]
    src[0, 0, 2] = src[0, 0, 0]  # an empty box: the eps guards
    w = (10.0, 10.0, 5.0, 5.0)
    close(boxes.encode_deltas(t(src), t(tgt), w), jboxes.encode_deltas(jnp.asarray(src), jnp.asarray(tgt), w))
    np.testing.assert_array_equal(boxes.nonempty_mask(t(src), 5.0).numpy(),
                                  np.asarray(jboxes.nonempty_mask(jnp.asarray(src), 5.0)))
    # apply_deltas inverts encode_deltas on nonempty boxes
    d = boxes.encode_deltas(t(src[1:]), t(tgt[1:]), w)
    close(boxes.apply_deltas(d, t(src[1:]), w), tgt[1:], rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------------ targets

@pytest.fixture(scope="module")
def targets_pair():
    g = np.random.default_rng(5)
    gtb, valid = gt_set(g)
    sizes = get_config().centernet.sizes_of_interest
    got = heatmap.render_targets(t(gtb), t(valid), CANVAS, STRIDES, sizes)
    grids = jhm.compute_grids(CANVAS, STRIDES)
    refs = [jhm.render_targets(jnp.asarray(gtb[i]), jnp.asarray(valid[i]), grids, jhm.flat_strides(CANVAS, STRIDES),
                               jhm.flat_size_ranges(CANVAS, STRIDES, sizes), CANVAS, STRIDES, sizes)
            for i in range(len(gtb))]
    return gtb, valid, got, refs


def test_render_targets(targets_pair):
    gtb, valid, got, refs = targets_pair
    assert got.pos_inds.dtype == torch.int64 and got.pos_mask.dtype == torch.bool
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(got.pos_inds[i].numpy(), np.asarray(ref.pos_inds))
        np.testing.assert_array_equal(got.pos_mask[i].numpy(), np.asarray(ref.pos_mask))
        # which pixels carry a regression target, and the heatmap's support: exact
        np.testing.assert_array_equal((got.reg_targets[i] >= 0).numpy(), np.asarray(ref.reg_targets) >= 0)
        np.testing.assert_array_equal((got.heatmap[i] > 0).numpy(), np.asarray(ref.heatmap) > 0)
        close(got.reg_targets[i], ref.reg_targets)
        close(got.heatmap[i], ref.heatmap)
    assert got.pos_mask.any() and (got.reg_targets.amax(-1) >= 0).any()


def test_flat_level_constants():
    sizes = get_config().centernet.sizes_of_interest
    np.testing.assert_array_equal(heatmap.flat_strides(CANVAS, STRIDES).numpy(),
                                  np.asarray(jhm.flat_strides(CANVAS, STRIDES)))
    np.testing.assert_array_equal(heatmap.flat_size_ranges(CANVAS, STRIDES, sizes).numpy(),
                                  np.asarray(jhm.flat_size_ranges(CANVAS, STRIDES, sizes)))


@pytest.mark.parametrize("topk,thresh", [(9, 0.2), (4, 0.6)])
def test_more_pos_inds(targets_pair, topk, thresh):
    gtb, valid, _, _ = targets_pair
    g = np.random.default_rng(6)
    m = sum((CANVAS[0] // s) * (CANVAS[1] // s) for s in STRIDES)
    reg = g.uniform(0, 8, (2, m, 4)).astype(np.float32)
    sizes = get_config().centernet.sizes_of_interest
    inds, mask = heatmap.more_pos_inds(t(gtb), t(valid), t(reg), CANVAS, STRIDES, sizes, more_pos_topk=topk,
                                       more_pos_thresh=thresh)
    for i in range(2):
        ri, rm = jhm.more_pos_inds(jnp.asarray(gtb[i]), jnp.asarray(valid[i]), jnp.asarray(reg[i]), CANVAS,
                                   STRIDES, sizes, more_pos_topk=topk, more_pos_thresh=thresh)
        np.testing.assert_array_equal(inds[i].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(rm))
    assert mask.any()


def test_centernet_losses(targets_pair):
    gtb, valid, tg, refs = targets_pair
    g = np.random.default_rng(7)
    cfg = get_config().centernet
    shapes = [(CANVAS[0] // s, CANVAS[1] // s) for s in STRIDES]
    hms = [(2 * g.standard_normal((2, 1, h, w)) - 2).astype(np.float32) for h, w in shapes]
    regs = [g.uniform(0, 6, (2, 4, h, w)).astype(np.float32) for h, w in shapes]
    hw = np.asarray([[90.0, 120.0], [64.0, 100.0]], np.float32)
    cval = centernet._level_valid_mask(CANVAS, STRIDES, t(hw))
    num_pos = torch.tensor(3.5)
    got = centernet.centernet_losses([t(h) for h in hms], [t(r) for r in regs], tg, cfg, cval, num_pos_avg=num_pos)
    for i in range(2):
        jcval = jcn._level_valid_mask(CANVAS, STRIDES, jnp.asarray(hw[i]))
        np.testing.assert_array_equal(cval[i].numpy(), np.asarray(jcval))
        ref = jcn.centernet_losses([jnp.asarray(h[i].transpose(1, 2, 0)) for h in hms],
                                   [jnp.asarray(r[i].transpose(1, 2, 0)) for r in regs], refs[i],
                                   jax_get_config().centernet, jcval, num_pos_avg=jnp.asarray(3.5))
        for k, v in ref.items():
            close(got[k][i], v, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ ROI side

def test_match_proposals_and_stage_losses():
    g = np.random.default_rng(8)
    gtb, gvalid = gt_set(g, 2, 5)
    props = np.concatenate([gtb + g.uniform(-4, 4, gtb.shape).astype(np.float32), gt_set(g, 2, 30)[0]], 1)
    pvalid = g.uniform(size=props.shape[:2]) < 0.9
    classes = np.zeros(gvalid.shape, np.int32)
    cfg, jcfg = get_config().roi, jax_get_config().roi
    gt = GroundTruth(t(gtb), t(classes), t(gvalid))
    midx, fg = cascade_roi.match_proposals(t(props), t(pvalid), gt, 0.6)
    cls_t, box_t = cascade_roi.label_proposals(t(props), t(pvalid), gt, 0.6, cfg.num_classes)
    scores = g.standard_normal((2, props.shape[1], 2)).astype(np.float32)
    deltas = g.standard_normal((2, props.shape[1], 4)).astype(np.float32)
    got = cascade_roi.stage_losses(cascade_roi.StageOutput(t(scores), t(deltas)), t(props), cls_t, box_t,
                                   t(pvalid), cfg, 0)
    for i in range(2):
        jgt = JaxGroundTruth(jnp.asarray(gtb[i]), jnp.asarray(classes[i]), jnp.asarray(gvalid[i]))
        rm, rf = jroi.match_proposals(jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jgt, 0.6)
        np.testing.assert_array_equal(midx[i].numpy(), np.asarray(rm))
        np.testing.assert_array_equal(fg[i].numpy(), np.asarray(rf))
        rcls = jnp.where(rf & jnp.asarray(pvalid[i]), jgt.classes[rm], jcfg.num_classes)
        np.testing.assert_array_equal(cls_t[i].numpy(), np.asarray(rcls))
        ref = jroi.stage_losses(jroi.StageOutput(jnp.asarray(scores[i]), jnp.asarray(deltas[i])),
                                jnp.asarray(props[i]), rcls, jgt.boxes[rm], jnp.asarray(pvalid[i]), jcfg, 0)
        for k, v in ref.items():
            close(got[k][i], v)
    assert fg.any() and (~fg).any()


def _sampler_setup(n_fg_clusters=3, n_bg=300, seed=0, b=2):
    """tests/test_subsample_proposals.py's scene, on b images."""
    g = np.random.default_rng(seed)
    gtb = np.asarray([[10, 10, 60, 70], [100, 40, 180, 120], [200, 150, 260, 230]], np.float32)
    fg_props = np.concatenate([gtb + g.uniform(-2, 2, (3, 4)).astype(np.float32) for _ in range(n_fg_clusters)])
    xy = g.uniform(300, 500, (n_bg, 2)).astype(np.float32)
    wh = g.uniform(10, 40, (n_bg, 2)).astype(np.float32)
    props = np.concatenate([fg_props, np.concatenate([xy, xy + wh], 1)]).astype(np.float32)
    gt = GroundTruth(t(np.repeat(gtb[None], b, 0)), torch.zeros(b, 3, dtype=torch.int32),
                     torch.ones(b, 3, dtype=torch.bool))
    return gt, t(np.repeat(props[None], b, 0)), torch.ones(b, len(props), dtype=torch.bool), len(fg_props)


def _sample(seed, *args):
    return cascade_roi.subsample_proposals(torch.Generator().manual_seed(seed), *args, get_config().roi)


def test_subsample_counts_and_labels():
    cfg = get_config().roi  # 128 slots, fraction 0.5, IoU 0.6
    gt, props, valid, n_fg = _sampler_setup()
    s_boxes, cls_t, box_t, slot_valid = _sample(0, props, valid, gt)
    assert s_boxes.shape == (2, cfg.batch_size_per_image, 4) and cls_t.dtype == torch.int64
    n_pos = ((cls_t == 0) & slot_valid).sum(1)
    n_neg = ((cls_t == cfg.num_classes) & slot_valid).sum(1)
    # fg candidates: the 9 jittered boxes and the 3 appended gts
    assert n_pos.tolist() == [n_fg + 3] * 2
    assert (n_neg == cfg.batch_size_per_image - n_pos).all() and (n_pos + n_neg == slot_valid.sum(1)).all()
    fg_slots = (cls_t == 0) & slot_valid
    iou = boxes.pairwise_iou(box_t[fg_slots], s_boxes[fg_slots]).diagonal()
    assert (iou >= cfg.cascade_ious[0]).all()
    # the valid slots come first
    assert (slot_valid.int().diff(dim=1) <= 0).all()


def test_subsample_caps_positive_fraction():
    cfg = get_config().roi
    gt, props, valid, n_fg = _sampler_setup(n_fg_clusters=40, n_bg=20)
    _, cls_t, _, slot_valid = _sample(3, props, valid, gt)
    max_pos = int(cfg.batch_size_per_image * cfg.positive_fraction)
    assert n_fg + 3 > max_pos
    assert (((cls_t == 0) & slot_valid).sum(1) == max_pos).all()
    # only 20 negatives exist: the rest of the slots stay invalid
    assert (((cls_t == cfg.num_classes) & slot_valid).sum(1) == 20).all()
    assert (slot_valid.sum(1) == max_pos + 20).all()


def test_subsample_append_gt_guarantees_positives():
    gt, props, valid, n_fg = _sampler_setup()
    _, cls_t, box_t, slot_valid = _sample(1, props[:, n_fg:], valid[:, n_fg:], gt)
    assert (((cls_t == 0) & slot_valid).sum(1) == 3).all()  # exactly the three gts


def test_subsample_deterministic_per_generator():
    gt, props, valid, _ = _sampler_setup()
    a, b, c = _sample(7, props, valid, gt), _sample(7, props, valid, gt), _sample(8, props, valid, gt)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


# ------------------------------------------------------------------ decode

def test_training_decode_matches_jax():
    """decode_proposals(training=True): the train top-k sizes and threshold,
    the NMS budget cut (forced here, the default being 2048), and the
    compaction, against the JAX package image by image."""
    base = get_config()
    cfg = dataclasses.replace(base.centernet, pre_nms_topk_train=150, post_nms_topk_train=64)
    jcfg = dataclasses.replace(jax_get_config().centernet, pre_nms_topk_train=150, post_nms_topk_train=64)
    g = np.random.default_rng(9)
    shapes = [(CANVAS[0] // s, CANVAS[1] // s) for s in STRIDES]
    hms = [(2 * g.standard_normal((2, 1, h, w)) - 1).astype(np.float32) for h, w in shapes]
    regs = [g.uniform(0, 4, (2, 4, h, w)).astype(np.float32) for h, w in shapes]
    hw = np.asarray([[96.0, 120.0], [70.0, 100.0]], np.float32)
    for budget in (None, 200):
        got = centernet.decode_proposals([t(h) for h in hms], [t(r) for r in regs], cfg, CANVAS, t(hw),
                                         training=True, nms_budget=budget)
        assert got.boxes.shape == (2, 64, 4)
        for i in range(2):
            ref = jcn.decode_proposals([jnp.asarray(h[i].transpose(1, 2, 0)) for h in hms],
                                       [jnp.asarray(r[i].transpose(1, 2, 0)) for r in regs], jcfg, CANVAS,
                                       jnp.asarray(hw[i]), training=True, nms_budget=budget)
            np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(ref.valid))
            close(got.boxes[i], ref.boxes)
            close(got.scores[i], ref.scores)
