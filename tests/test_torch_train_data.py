"""The port's training data path against the JAX package's on the CPU: the
episodic mapper on the JAX synthetic set written to disk (chosen scale,
flip, boxes, image_hw and support entries exact; canvases and resized
crops within one uint8 level, the port resizing with PyTorch where the JAX
package uses cv2), support-crop writing, the training canvas, and the
port's loader and in-memory synthetic set."""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.data import coco as jcoco
from faster_orefsdet_tpu.data.loader import train_canvas as jax_train_canvas
from faster_orefsdet_tpu.data.mapper import EpisodicMapper as JaxMapper
from faster_orefsdet_tpu.data.mapper import SupportSampler as JaxSampler
from faster_orefsdet_tpu.data.synthetic import make_synthetic_setup as jax_synthetic
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.data import coco
from faster_orefsdet_tpu_torch.data.loader import collate, train_canvas, train_loader
from faster_orefsdet_tpu_torch.data.mapper import EpisodicMapper, SupportSampler
from faster_orefsdet_tpu_torch.data.synthetic import make_synthetic_setup

import torch_budget  # noqa: F401 (the suite's torch thread budget)


def small(cfg, crop=240):
    return cfg.replace(fs=dataclasses.replace(cfg.fs, support_shot=3, support_crop_size=crop),
                       static=dataclasses.replace(cfg.static, max_gt_per_image=8))


def to_port_records(records):
    return [coco.ImageRecord(r.file_name, r.image_id, r.height, r.width,
                             [coco.Annotation(a.id, tuple(a.bbox), a.category_id, a.iscrowd) for a in r.annotations])
            for r in records]


def to_port_entries(entries):
    return [coco.SupportEntry(e.id, e.image_id, e.category_id, e.file_path, tuple(e.support_box)) for e in entries]


@pytest.fixture(scope="module")
def jax_set(tmp_path_factory):
    """The JAX package's synthetic set (images, 240 px crops) on disk, and
    200 px crops of the same annotations, which the mappers resize."""
    root = tmp_path_factory.mktemp("synthetic")
    records, entries = jax_synthetic(str(root), num_images=6, seed=3)
    small_entries = jcoco.build_support_crops(records, str(root / "support200"), crop_size=200)
    return records, entries, small_entries, root


def _close_uint8(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("crop_set", ["240", "200"])
def test_mapper_matches_jax(jax_set, crop_set):
    records, entries, small_entries, _ = jax_set
    entries = entries if crop_set == "240" else small_entries
    jcfg, cfg = small(jax_get_config()), small(get_config())
    jrecs = jcoco.split_per_class(records)
    precs = coco.split_per_class(to_port_records(records))
    canvas = jax_train_canvas(jrecs, jcfg)
    assert train_canvas(precs, cfg) == canvas
    jmap = JaxMapper(jcfg, JaxSampler(entries), canvas_hw=canvas)
    pmap = EpisodicMapper(cfg, SupportSampler(to_port_entries(entries)), canvas_hw=canvas)
    flips = set()
    for i, (jr, pr) in enumerate(zip(jrecs, precs)):
        ref, got = jmap(jr, np.random.default_rng(i)), pmap(pr, np.random.default_rng(i))
        assert got.image_hw == ref.image_hw and got.image_key == ref.image_key
        assert got.support_key == ref.support_key
        flips.add(got.image_key[2])
        for f in ("gt_boxes", "gt_classes", "gt_valid", "support_boxes", "support_classes"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
        _close_uint8(got.image, ref.image)
        _close_uint8(got.support_images, ref.support_images)
        if crop_set == "240":  # crops of the right size are read, not resized
            np.testing.assert_array_equal(got.support_images, ref.support_images)
        shot = jcfg.fs.support_shot
        anns = jr.annotations
        ids = [e.id for e in JaxSampler(entries).sample(anns[0].category_id, jr.image_id, [a.id for a in anns],
                                                        1, shot, anns[0].id)]
        assert [e.id for e in pmap.sampler.sample(anns[0].category_id, pr.image_id, [a.id for a in anns], 1, shot,
                                                  anns[0].id)] == ids
    assert flips == {True, False}


def test_build_support_crops_matches_jax(jax_set):
    records, entries, _, root = jax_set
    written = {}
    got = coco.build_support_crops(to_port_records(records), str(root / "support"), crop_size=240,
                                   imread=cv2.imread, imwrite=written.__setitem__)
    assert [(e.id, e.image_id, e.category_id, e.file_path) for e in got] == [
        (e.id, e.image_id, e.category_id, e.file_path) for e in entries]
    for e, ref in zip(got, entries):
        np.testing.assert_allclose(e.support_box, ref.support_box, rtol=1e-6)
    # the JAX package's crops went through JPEG: hold the port's against
    # cv2's resize of the same crop
    r = records[0]
    ann = r.annotations[0]
    img = cv2.imread(r.file_name)
    x1, y1, x2, y2 = ann.bbox
    pw, ph = (x2 - x1) * 0.15, (y2 - y1) * 0.15
    crop = img[max(0, int(y1 - ph)):min(r.height, int(y2 + ph) + 1),
               max(0, int(x1 - pw)):min(r.width, int(x2 + pw) + 1)]
    _close_uint8(written[got[0].file_path], cv2.resize(crop, (240, 240), interpolation=cv2.INTER_LINEAR))


def test_collate_and_loader():
    cfg = small(get_config(), crop=64)
    cfg = cfg.replace(input=dataclasses.replace(cfg.input, min_size_train=(64, 80), max_size_train=160))
    records, entries, imread = make_synthetic_setup(5, seed=1, crop_size=64, image_hw=(96, 128),
                                                    blob_size=(20.0, 40.0), root="mem")
    # one portrait image: its own canvas orientation and its own batches
    records[0].height, records[0].width = records[0].width, records[0].height
    portrait = imread(records[0].file_name).transpose(1, 0, 2).copy()
    store = {records[0].file_name: portrait}
    mapper = EpisodicMapper(cfg, SupportSampler(entries), canvas_hw=train_canvas(records, cfg),
                            imread=lambda p: store.get(p, imread(p)))
    ex = [mapper(r, np.random.default_rng(i)) for i, r in enumerate(records[1:3])]
    batch = collate(ex, "cpu", device_sup_cache={}, device_img_cache={})
    hc, wc = train_canvas(records, cfg)
    assert batch.images.shape == (2, 3, hc, wc) and batch.images.dtype == torch.uint8
    assert batch.images.is_contiguous(memory_format=torch.channels_last)
    assert batch.support_images.shape == (2, 3, 3, 64, 64)
    assert batch.gt_boxes.shape == (2, 8, 4) and batch.gt_valid.dtype == torch.bool
    np.testing.assert_array_equal(batch.images[0].permute(1, 2, 0).numpy(), ex[0].image)

    loader = train_loader(split := coco.split_per_class(records), mapper, 2, seed=0, device="cpu")
    try:
        shapes = {tuple(next(loader).images.shape) for _ in range(6)}
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    assert shapes <= {(2, 3, hc, wc), (2, 3, wc, hc)} and len(split) == 5


def test_synthetic_set_in_memory_and_written(tmp_path):
    records, entries, imread = make_synthetic_setup(3, seed=2, crop_size=64, image_hw=(96, 128),
                                                    root=str(tmp_path / "mem"))
    assert not (tmp_path / "mem").exists()  # nothing written without a writer
    assert len(entries) == sum(len(r.annotations) for r in records) > 0
    for r in records:
        img = imread(r.file_name)
        assert img.shape == (96, 128, 3) and img.dtype == np.uint8
        for a in r.annotations:
            x1, y1, x2, y2 = a.bbox
            assert 0 <= x1 < x2 <= 128 and 0 <= y1 < y2 <= 96
    assert imread(entries[0].file_path).shape == (64, 64, 3)

    root = tmp_path / "disk"
    w_records, w_entries, _ = make_synthetic_setup(3, seed=2, crop_size=64, image_hw=(96, 128), root=str(root),
                                                   writer=cv2.imwrite)
    loaded = coco.load_coco_json(str(root / "instances.json"), str(root / "images"))
    assert [(r.file_name, [a.bbox for a in r.annotations]) for r in loaded] == [
        (r.file_name, [a.bbox for a in r.annotations]) for r in w_records]
    assert all(os.path.exists(e.file_path) for e in coco.load_support_index(str(root / "support_index.json")))
    assert json.loads((root / "instances.json").read_text())["categories"] == [{"id": 1, "name": "ore"}]
