"""The port's COCO evaluation, dataset records and eval loop against the JAX
package, on the CPU. AP to 1e-9 on the same detections. The eval loop on a
6-image synthetic set (written by the JAX package's own generator): the
detections each loop feeds its evaluator, per image in frame coordinates,
matched by test_torch_slice's criteria, and the AP table within 0.5 points
of the JAX loop's, on the set's own ground truth and on ground truth taken
from the JAX loop's detections (random weights score ~0 AP on the former,
so the latter is what shows that the tolerance has something to hold). The
port resizes on the host with PyTorch (held within one uint8 level of cv2
in test_torch_preprocess); here the JAX loop resizes with the port's
function too, so both loops read the same pixels."""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.data import coco as jcoco
from faster_orefsdet_tpu.data.synthetic import make_synthetic_setup
from faster_orefsdet_tpu.evaluation import coco_eval as jeval
from faster_orefsdet_tpu.pipelines import evaluate as jevaluate
from faster_orefsdet_tpu.pipelines import preprocess as jpreprocess
from faster_orefsdet_tpu.pipelines.inference import make_detector as jax_make_detector
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.data import coco, loader
from faster_orefsdet_tpu_torch.evaluation import coco_eval
from faster_orefsdet_tpu_torch.pipelines import evaluate, preprocess
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_torch_parity import make_torch_state_dict
from test_torch_slice import SCORE_ATOL
import torch_budget  # noqa: F401 (the suite's torch thread budget)

AP_ATOL = 1e-9
EVAL_AP_POINTS = 0.5
MATCH_IOU, MATCH_FRACTION = 0.95, 0.85  # test_torch_slice's criteria
AP_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@100")


def _random_set(seed, n_images=7):
    g = np.random.default_rng(seed)
    dets, gts = [], []
    for i in range(n_images):
        m = int(g.integers(0, 6))
        xy = g.uniform(0, 300, (m, 2))
        wh = g.uniform(8, 150, (m, 2))
        gt = np.concatenate([xy, xy + wh], 1)
        crowd = g.uniform(size=m) < 0.15
        n = int(g.integers(0, 30))
        jitter = g.normal(0, 6, (n, 4))
        base = gt[g.integers(0, m, n)] if m else g.uniform(0, 300, (n, 4))
        boxes = np.sort((base + jitter).reshape(n, 2, 2), axis=1).reshape(n, 4)
        scores = np.round(g.uniform(size=n), 2)  # ties included
        if i != 3:  # an image with ground truth and no detections
            dets.append((i, boxes, scores))
        gts.append((i, gt, crowd))
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_ap_matches_jax(seed):
    dets, gts = _random_set(seed)
    got = coco_eval.coco_ap([coco_eval.DetResult(*d) for d in dets],
                            [coco_eval.GTImage(i, b, c, (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])) for i, b, c in gts])
    ref = jeval.coco_ap([jeval.DetResult(*d) for d in dets],
                        [jeval.GTImage(i, b, c, (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])) for i, b, c in gts])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=AP_ATOL, nan_ok=True), k
    ev, jev = coco_eval.COCOEvaluator(), jeval.COCOEvaluator()
    for e in (ev, jev):
        for i, b, s in dets:
            e.process(i, b, s)
        for i, b, c in gts:
            e.add_ground_truth(i, b, c)
    a, b = ev.evaluate(), jev.evaluate()
    for k in b:
        assert a[k] == pytest.approx(b[k], abs=AP_ATOL, nan_ok=True), k


def test_load_coco_json_and_support_index(tmp_path):
    doc = {
        "images": [{"id": 7, "file_name": "a.jpg", "height": 240, "width": 320},
                   {"id": 9, "file_name": "b.jpg", "height": 100, "width": 50}],
        "annotations": [
            {"id": 1, "image_id": 7, "category_id": 1, "bbox": [10, 20, 30, 40]},
            {"id": 2, "image_id": 7, "category_id": 2, "bbox": [1.5, 2.5, 3, 4], "iscrowd": 1},
            {"id": 3, "image_id": 7, "category_id": 2, "bbox": [5, 5, 5, 5]},
            {"id": 4, "image_id": 99, "category_id": 1, "bbox": [0, 0, 1, 1]},
        ],
    }
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(doc))
    got = coco.load_coco_json(str(path), "/data/img")
    ref = jcoco.load_coco_json(str(path), "/data/img")
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in ref]
    assert got[0].annotations[0].bbox == (10, 20, 40, 60)
    split, jsplit = coco.split_per_class(got), jcoco.split_per_class(ref)
    assert [dataclasses.asdict(r) for r in split] == [dataclasses.asdict(r) for r in jsplit]
    entries = [coco.SupportEntry(1, 7, 1, "/s/1.jpg", (1.0, 2.0, 30.0, 40.0))]
    coco.save_support_index(str(tmp_path / "idx.json"), entries)
    assert coco.load_support_index(str(tmp_path / "idx.json")) == entries
    assert [dataclasses.asdict(e) for e in jcoco.load_support_index(str(tmp_path / "idx.json"))] == \
        [dataclasses.asdict(e) for e in entries]


def test_eval_loader_needs_an_imread_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    rec = coco.ImageRecord("x.jpg", 1, 120, 160)
    with pytest.raises(ImportError, match="imread="):
        next(loader.eval_loader([rec], get_config()))
    frame = np.zeros((120, 160, 3), np.uint8)
    _, canvas, hw, scale = next(loader.eval_loader([rec], get_config(), imread=lambda path: frame))
    assert canvas.shape == (3, 320, 448) and hw == (320, 427) and scale == (120 / 320, 160 / 427)


def _small(cfg):
    return cfg.replace(input=dataclasses.replace(cfg.input, min_size_test=128, max_size_test=192),
                       fs=dataclasses.replace(cfg.fs, support_shot=2))


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    records, entries = make_synthetic_setup(str(tmp_path_factory.mktemp("eval")), num_images=6, seed=0)
    return records, entries


def _record_fed_detections(monkeypatch, evaluator_cls, fed):
    """Record, per image id, what the evaluator's process() receives into
    the dict fed[fed["run"]]."""
    process = evaluator_cls.process

    def recording(self, image_id, boxes, scores):
        fed.setdefault(fed["run"], {})[image_id] = {
            "boxes": np.asarray(boxes, np.float64), "scores": np.asarray(scores, np.float64),
            "valid": np.ones(len(scores), bool)}
        return process(self, image_id, boxes, scores)

    monkeypatch.setattr(evaluator_cls, "process", recording)


def _assert_fed_match(got, ref):
    """One image's detections as fed to the evaluators (frame coordinates):
    the same count, > 0; >= MATCH_FRACTION greedy-matched one to one at IoU
    >= MATCH_IOU with |dscore| <= SCORE_ATOL; each side's top 10 matched.
    Equal boxes match, the degenerate ones (clipped to a line) included."""
    gb, gs, rb, rs = got["boxes"], got["scores"], ref["boxes"], ref["scores"]
    assert len(gs) == len(rs) > 0, (len(gs), len(rs))
    lt = np.maximum(gb[:, None, :2], rb[None, :, :2])
    wh = np.clip(np.minimum(gb[:, None, 2:], rb[None, :, 2:]) - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area(gb)[:, None] + area(rb)[None, :] - inter
    iou = np.where(inter > 0, inter / np.maximum(union, 1e-12), 0.0)
    iou = np.where((gb[:, None, :] == rb[None, :, :]).all(-1), 1.0, iou)
    used_g, used_r, dscore = set(), set(), 0.0
    for j, r in zip(*np.unravel_index(np.argsort(-iou, axis=None, kind="stable"), iou.shape)):
        if iou[j, r] < MATCH_IOU:
            break
        if j not in used_g and r not in used_r:
            used_g.add(int(j))
            used_r.add(int(r))
            dscore = max(dscore, abs(gs[j] - rs[r]))
    assert len(used_r) >= MATCH_FRACTION * len(rs), f"{len(used_r)}/{len(rs)} matched"
    assert dscore <= SCORE_ATOL, dscore
    assert set(np.argsort(-gs, kind="mergesort")[:10].tolist()) <= used_g
    assert set(np.argsort(-rs, kind="mergesort")[:10].tolist()) <= used_r


def _assert_tables_close(got, ref):
    for k in AP_KEYS:
        assert np.isnan(got[k]) == np.isnan(ref[k]), k
        if not np.isnan(ref[k]):
            assert abs(got[k] - ref[k]) <= EVAL_AP_POINTS, (k, got[k], ref[k])


def test_evaluate_matches_jax(synthetic, monkeypatch):
    records, entries = synthetic
    monkeypatch.setattr(jpreprocess, "resize_image_host", preprocess.resize_image_host)
    fed = {}
    _record_fed_detections(monkeypatch, jeval.COCOEvaluator, fed)
    _record_fed_detections(monkeypatch, coco_eval.COCOEvaluator, fed)
    jcfg, cfg = _small(jax_get_config("finetune_vovnet")), _small(get_config("finetune_vovnet"))
    params = convert_torch_checkpoint(make_torch_state_dict(seed=3))
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    model = jax_make_detector(jcfg)
    jcache = jevaluate.encode_support_set(model, params, entries, jcfg)
    fed["run"] = "jax"
    ref = jevaluate.evaluate(model, params, jcache, records, jcfg)
    cache = evaluate.encode_support_set(cfg, sd, entries, device="cpu")
    for name in cache._fields:
        np.testing.assert_allclose(getattr(cache, name).numpy(), np.asarray(getattr(jcache, name)),
                                   rtol=1e-2, atol=2e-2, err_msg=name)
    fed["run"] = "port"
    got1 = evaluate.evaluate(cfg, sd, cache, records, device="cpu")
    fed["run"] = "port_batch4"
    got4 = evaluate.evaluate(cfg, sd, cache, records, batch_size=4, device="cpu")
    # what each loop fed its evaluator: every image, in frame coordinates
    ids = [r.image_id for r in records]
    assert sorted(fed["jax"]) == sorted(fed["port"]) == sorted(fed["port_batch4"]) == sorted(ids)
    for i in ids:
        _assert_fed_match(fed["port"][i], fed["jax"][i])
        _assert_fed_match(fed["port_batch4"][i], fed["port"][i])
    _assert_tables_close(got1, ref)
    for k in AP_KEYS:
        if not np.isnan(ref[k]):
            # batch 4 (uint8 canvases, tail padded) gives batch 1's table
            assert got4[k] == pytest.approx(got1[k], abs=1e-6), k
    for got in (got1, got4):
        assert got["fps"] > 0 and got["latency_p50_s"] > 0 and got["latency_mean_s"] > 0

    # ground truth from the JAX loop's detections of positive area: the JAX
    # loop now scores far above the tolerance, and a port loop that lost or
    # misplaced its detections would score far below it
    recs = [dataclasses.replace(r, annotations=[
        jcoco.Annotation(100 * r.image_id + j, tuple(map(float, b)), 1)
        for j, b in enumerate(fed["jax"][r.image_id]["boxes"]) if (b[2] - b[0]) * (b[3] - b[1]) > 1.0])
        for r in records]
    assert all(r.annotations for r in recs)
    fed["run"] = "jax_self"
    ref_self = jevaluate.evaluate(model, params, jcache, recs, jcfg)
    fed["run"] = "port_self"
    got_self = evaluate.evaluate(cfg, sd, cache, recs, device="cpu")
    assert min(ref_self["AP50"], ref_self["AR@100"]) >= 20 * EVAL_AP_POINTS, ref_self
    _assert_tables_close(got_self, ref_self)


def test_evaluate_refuses_quantized_config():
    """A static-quantized config without scales calibrates on the eval set:
    with no images to calibrate on it is refused."""
    with pytest.raises(ValueError, match="no calibration images"):
        evaluate.evaluate(get_config().replace(quantize="int8_static"), None, None, [], device="cpu")
