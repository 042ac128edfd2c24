"""The DSA head's fold (``models.cascade_roi.dsa_fold``) against its chain.

Everything between the pooled rows and fc1's ReLU is linear in the query
and the support, so serving runs it as one GEMM with a folded weight and a
per-support bias; training runs the chain (the fusion's three Linears on
the pooled rows and the expanded support, then fc1), whose weights need
their gradients. Held here on the CPU:

- the fold against the chain at VoVNet's (P 8, C 128), DLA's (P 7, C 160)
  and the fast presets' (P 4) shapes, in a 3-stage cascade and at a narrow
  width (P 7, C 16), with one support for every row and one per row: in
  f64 to 1e-12 of the output's range, in f32 to 1e-5; a stacked cache's
  fold (one bias row a class) on class-major rows against the chain given
  the same supports one a row; a fold made for another support or dtype
  refused;
- the query paths with the fold made once by the caller and made at the
  call, bit for bit, and the pinned builders making it once, for the
  pyramid's dtype, at build time;
- the route by what the inputs show, and the training route's outputs and
  gradients bit for bit against the chain as it was written before the fold.
"""

import dataclasses

import numpy as np
import pytest
import torch

from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models import cascade_roi
from faster_orefsdet_tpu_torch.models.cascade_roi import DSACascadeHead, dsa_fold
from faster_orefsdet_tpu_torch.models.layers import at_least_f32, linear
from faster_orefsdet_tpu_torch.ops.roi_align_cuda import multilevel_roi_pool
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache, stack_support_caches
from faster_orefsdet_tpu_torch.utils.params import init_params
import torch_budget  # noqa: F401 (the suite's torch thread budget)

# name: (pooler P, channels C, cascade stages)
SHAPES = {"vovnet": (8, 128, 2), "dla": (7, 160, 2), "fast": (4, 128, 2), "three_stages": (8, 128, 3),
          "narrow": (7, 16, 2)}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CANVAS, IMAGE_HW = (96, 128), (96.0, 120.0)


def _head(name, dtype=torch.float32, seed=0):
    p, c, stages = SHAPES[name]
    roi = get_config("finetune_vovnet").roi
    roi = dataclasses.replace(roi, pooler_resolution=p, cascade_ious=(0.6, 0.7, 0.8)[:stages],
                              cascade_bbox_reg_weights=(roi.cascade_bbox_reg_weights * 3)[:stages])
    torch.manual_seed(seed)
    head = DSACascadeHead(roi, c)
    for prm in head.parameters():  # O(1) outputs from O(1) rows
        torch.nn.init.normal_(prm, std=1.0 / np.sqrt(prm.shape[-1]))
    return head.to(dtype)


def _inputs(name, dtype, rows=2, per_row=False, seed=1):
    """Maps [rows, C, H_l, W_l] at strides 8-32 of a 128x192 canvas, 5 boxes
    a row over every level, and a support [P, P, C] or [rows, P, P, C]."""
    p, c, _ = SHAPES[name]
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(rows, c, 16 >> i, 24 >> i, generator=g, dtype=dtype) for i in range(3)]
    xy = torch.rand(rows, 5, 2, generator=g) * torch.tensor([100.0, 60.0])
    wh = torch.tensor([[8.0, 8.0], [30.0, 20.0], [60.0, 50.0], [90.0, 60.0], [150.0, 110.0]])
    boxes = torch.cat([xy, xy + wh], dim=-1)
    support = torch.randn(*((rows,) if per_row else ()), p, p, c, generator=g, dtype=dtype)
    return feats, boxes, support


def _parent_chain(head, features, boxes, support_8, stage):
    """The head's forward as it was before the fold: the chain, always."""
    cfg = head.cfg
    q8 = multilevel_roi_pool(features, boxes, cascade_roi.ROI_STRIDES, cfg.pooler_resolution,
                             cfg.pooler_sampling_ratio, cfg.canonical_box_size, cfg.canonical_level)
    s8 = support_8.to(q8.dtype)
    if s8.dim() == 4:
        s8 = s8[:, None]
    s8 = s8.expand(q8.shape)
    fused = linear(torch.cat([q8, s8], dim=-1), head.dsa_conv3)
    branch = torch.cat([linear(q8, head.dsa_conv1), linear(s8, head.dsa_conv2)], dim=-1)
    attn8 = fused + branch
    x = attn8.reshape(*attn8.shape[:2], -1)
    x = at_least_f32(torch.relu(linear(x, getattr(head, f"stage{stage}_fc1"))))
    return linear(x, getattr(head, f"stage{stage}_cls")), linear(x, getattr(head, f"stage{stage}_bbox"))


def _assert_close(got, ref, dtype):
    for a, b in zip(got, ref):
        span = (b.max() - b.min()).item()
        assert a.dtype == b.dtype
        assert (a - b).abs().max().item() <= TOL[dtype] * span, ((a - b).abs().max().item(), span)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("per_row", [False, True], ids=["one_support", "per_row_support"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_fold_equals_the_chain(name, per_row, dtype):
    head = _head(name, dtype)
    feats, boxes, support = _inputs(name, dtype, per_row=per_row)
    stages = len(head.cfg.cascade_ious)
    with torch.enable_grad():  # trainable parameters: the chain
        chain = [head(feats, boxes, support, None, k) for k in range(stages)]
    with torch.inference_mode():
        at_call = [head(feats, boxes, support, None, k) for k in range(stages)]
        fold = dsa_fold(head, support, dtype)
        given = [head(feats, boxes, support, None, k, fold) for k in range(stages)]
    fc, (p, c, _) = head.cfg.fc_dim, SHAPES[name]
    assert [tuple(w.shape) for w in fold.w] == [(p * p * c, fc)] * stages
    assert [tuple(g.shape) for g in fold.g] == [(2 if per_row else 1, fc)] * stages
    for ch, a, b in zip(chain, at_call, given):
        assert ch.scores.requires_grad and not a.scores.requires_grad
        _assert_close(a, [t.detach() for t in ch], dtype)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(SHAPES))
def test_stacked_fold_serves_class_major_rows(name):
    """A stacked cache's fold, one bias row a class, on rows laid out class
    by class (the multiclass path's), against the chain given the same
    supports one a row; the chain given the stacked cache expands it to
    the same rows."""
    head, classes, images = _head(name, torch.float64), 3, 2
    feats, boxes, support = _inputs(name, torch.float64, rows=classes * images, per_row=True)
    support = support[::images]  # one a class
    per_row = support.repeat_interleave(images, dim=0)
    stages = range(len(head.cfg.cascade_ious))
    with torch.enable_grad():  # trainable parameters: the chain
        ref = [head(feats, boxes, per_row, None, k) for k in stages]
        stacked = [head(feats, boxes, support, None, k) for k in stages]
    with torch.inference_mode():
        fold = dsa_fold(head, support, torch.float64)
        got = [head(feats, boxes, support, None, k, fold) for k in stages]
    for a, b, c in zip(got, ref, stacked):
        _assert_close(a, [t.detach() for t in b], torch.float64)
        assert all(torch.equal(x, y) for x, y in zip(b, c))
    assert fold.g[0].shape[0] == classes


@pytest.mark.parametrize("stale", ["support", "dtype"])
def test_a_fold_for_another_support_or_dtype_is_refused(stale):
    """The fold stands for the support it was made from, rounded to the
    pooled rows' dtype: one made from another support tensor, or for rows
    of another dtype, is refused rather than used or made again."""
    head = _head("vovnet")
    feats, boxes, support = _inputs("vovnet", torch.float32)
    with torch.inference_mode():
        fold = dsa_fold(head, support.clone() if stale == "support" else support,
                        torch.float32 if stale == "support" else torch.bfloat16)
        with pytest.raises(ValueError, match="another support"):
            head(feats, boxes, support, None, 0, fold)


CONTEXTS = {
    "inference_mode": (torch.inference_mode, True, False, False),
    "no_grad": (torch.no_grad, True, False, False),
    "grad_frozen_head": (torch.enable_grad, False, False, False),
    "grad_trainable_head": (torch.enable_grad, True, False, True),
    "grad_support": (torch.enable_grad, False, True, True),
}


@pytest.mark.parametrize("context", list(CONTEXTS))
def test_the_route_is_what_the_inputs_show(context):
    """The chain exactly where a gradient is wanted of the pooled rows, the
    support or a parameter; CUDA calls alone are counted."""
    mode, trainable, support_grad, chain = CONTEXTS[context]
    head = _head("fast").requires_grad_(trainable)
    feats, boxes, support = _inputs("fast", torch.float32)
    support.requires_grad_(support_grad)
    before = (cascade_roi.counter.folded_calls, cascade_roi.counter.chain_calls)
    with mode():
        q8 = multilevel_roi_pool(feats, boxes, cascade_roi.ROI_STRIDES, 4, 2)
        assert head.needs_chain(q8, support) is chain
        out = head(feats, boxes, support, None, 0)
    assert out.scores.requires_grad is chain
    assert (cascade_roi.counter.folded_calls, cascade_roi.counter.chain_calls) == before


@pytest.mark.parametrize("name", ["vovnet", "dla"])
def test_training_takes_the_chain_with_its_gradients(name):
    """Under grad with trainable parameters and maps that need a gradient,
    the head is the chain as written before the fold: its outputs and every
    gradient bit for bit."""
    head = _head(name)
    feats, boxes, support = _inputs(name, torch.float32, per_row=True)

    def side(forward):
        maps = [f.clone().requires_grad_(True) for f in feats]
        head.zero_grad()
        outs = [o for k in range(len(head.cfg.cascade_ious)) for o in forward(maps, k)]
        sum((o * torch.linspace(-1.0, 1.0, o.shape[-1])).sum() for o in outs).backward()
        return [o.detach() for o in outs], [m.grad for m in maps], [p.grad.clone() for p in head.parameters()]

    sides = [side(lambda maps, k: head(maps, boxes, support, None, k)),
             side(lambda maps, k: _parent_chain(head, maps, boxes, support, k))]
    (outs, map_grads, grads), (ref_outs, ref_map_grads, ref_grads) = sides
    assert all(torch.equal(a, b) for a, b in zip(outs, ref_outs))
    assert all(torch.equal(a, b) for a, b in zip(map_grads, ref_map_grads))
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))


def _small(cfg):
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=128, post_nms_topk_test=32),
        roi=dataclasses.replace(cfg.roi, detections_per_image=24),
        input=dataclasses.replace(cfg.input, min_size_test=96, max_size_test=160),
    )


def _cache(seed, c=128, p=8):
    g = np.random.default_rng(seed)
    return SupportCache(*(torch.from_numpy((0.5 * g.standard_normal((s, s, c))).astype(np.float32))
                          for s in (32, 16, 8, p, 4)))


@pytest.fixture(scope="module")
def serving():
    cfg = _small(get_config("finetune_vovnet"))
    model = tinf.make_detector(cfg, init_params(cfg, seed=1), device="cpu")
    img = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, *CANVAS)).astype(np.float32))
    return dict(cfg=cfg, model=model, caches=[_cache(s) for s in (0, 1, 2)], img=img,
                hw=torch.tensor([IMAGE_HW, (80.0, 128.0)]))


class _FoldCalls:
    """Counts ``DSACascadeHead.fold_stage`` calls (the fold's making)."""

    def __init__(self, monkeypatch):
        self.n = 0
        make = DSACascadeHead.fold_stage

        def counted(head, s8, stage):
            self.n += 1
            return make(head, s8, stage)

        monkeypatch.setattr(DSACascadeHead, "fold_stage", counted)


@pytest.mark.parametrize("path", ["single_class", "multiclass"])
def test_query_paths_fold_given_or_made_at_the_call(serving, path, monkeypatch):
    s, calls = serving, _FoldCalls(monkeypatch)
    model, stages = s["model"], len(s["cfg"].roi.cascade_ious)
    if path == "single_class":
        run, cache = tinf.query_path, s["caches"][0]
    else:
        run, cache = tinf.query_path_multiclass, stack_support_caches(s["caches"])
    at_call = run(model, cache, s["img"], s["hw"])
    assert calls.n == stages
    with torch.inference_mode():
        fold = tinf.cache_fold(model, cache)
    assert [g.shape[0] for g in fold.g] == [1 if path == "single_class" else 3] * stages
    calls.n = 0
    given = run(model, cache, s["img"], s["hw"], fold=fold)
    assert calls.n == 0
    assert all(torch.equal(a, b) for a, b in zip(at_call, given)) and at_call.valid.any()


@pytest.mark.parametrize("name", ["serving_vovnet", "finetune_dla", "serving_vovnet_int8"])
def test_pinned_builders_make_the_fold_once_for_the_pyramid(name, monkeypatch):
    """The pinned builder's fold is made at build time for the dtype the
    pyramid has (bf16, f32, int8's bf16 dequantized), so no request makes
    it again; and the request equals the eager builder's."""
    cfg = _small(get_config(name))
    c, p = cfg.fpn.out_channels, cfg.roi.pooler_resolution
    sd, cache = init_params(cfg, seed=2), _cache(4, c, p)
    calls = _FoldCalls(monkeypatch)
    pinned = tinf.build_pinned_inference_fn(cfg, sd, cache, device="cpu")
    stages = len(cfg.roi.cascade_ious)
    assert calls.n == stages
    img = torch.from_numpy(np.random.default_rng(5).standard_normal((3, *CANVAS)).astype(np.float32))
    got = pinned(img, IMAGE_HW)
    assert calls.n == stages
    ref = tinf.build_inference_fn(cfg, sd, device="cpu")(cache, img, IMAGE_HW)
    assert calls.n == 2 * stages
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
