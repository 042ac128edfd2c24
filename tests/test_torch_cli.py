"""The port's single-card workflow against the JAX package's, on the CPU, on
files written with cv2: build_support (the same crops, byte for byte, and
the same index), demo (detections recorded at ``draw_detections`` in both
modules and greedy-matched: an image glob, --parallel, --debug with its
overlay inputs), visualize_features (every map within 1e-4 of its largest)
and debug_vis itself. Both read the weights from one npz that the port
wrote from a reference-layout checkpoint (``utils.torch_convert``). Video
input is in ``test_torch_cli_video.py``.

The JAX CLIs start from ``init_params`` (a 40 s trace of the whole model on
the CPU) before --params overwrites every leaf; here that start is the
converted tree itself, so the runs stay short."""

import os

import cv2
import numpy as np
import pytest
import torch

import faster_orefsdet_tpu.config as jax_config
import faster_orefsdet_tpu.pipelines.preprocess as jax_preprocess
import faster_orefsdet_tpu.utils.debug_vis as jax_debug_vis
import faster_orefsdet_tpu.utils.params as jax_params
from faster_orefsdet_tpu.cli import build_support as jax_build_support
from faster_orefsdet_tpu.cli import demo as jax_demo
from faster_orefsdet_tpu.cli import visualize_features as jax_visualize
from faster_orefsdet_tpu.data.synthetic import generate_ore_dataset
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint as jax_convert
from faster_orefsdet_tpu_torch.cli import build_support, demo, visualize_features
from faster_orefsdet_tpu_torch.data.coco import load_support_index
from faster_orefsdet_tpu_torch.ops.heatmap import CenterNetTargets
from faster_orefsdet_tpu_torch.pipelines.preprocess import resize_image_host
from faster_orefsdet_tpu_torch.structures.instances import Detections, Proposals
from faster_orefsdet_tpu_torch.utils import debug_vis
from faster_orefsdet_tpu_torch.utils.checkpoint import save_params_npz
from faster_orefsdet_tpu_torch.utils.torch_convert import convert_torch_checkpoint, load_torch_pth
from test_torch_eval import _assert_fed_match
from test_torch_parity import make_torch_state_dict
from test_torch_preprocess import HOST_U8_ATOL
import torch_budget  # noqa: F401 (the suite's torch thread budget)

SEED = 3  # the weights of test_torch_eval's parity
JAX_RESIZE = jax_preprocess.resize_image_host  # the JAX package's own (cv2), before the module's swap
TINY = ["centernet.pre_nms_topk_test=64", "centernet.post_nms_topk_test=16", "roi.detections_per_image=8",
        "input.min_size_test=96", "input.max_size_test=160", "fs.support_shot=2", "fs.support_crop_size=96"]


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """A synthetic COCO set on disk; the reference-layout .pth converted by
    the port into model.npz. For the module's runs, the JAX package's
    init_params is the converted tree and its host resize the port's (as in
    test_torch_eval: cv2's rounds to within one level of it, which random
    weights amplify)."""
    root = tmp_path_factory.mktemp("workflow")
    json_path, images = generate_ore_dataset(str(root / "data"), num_images=3, seed=0)
    torch.save({"model": make_torch_state_dict(SEED)}, root / "model_final.pth")
    npz = str(root / "model.npz")
    save_params_npz(npz, convert_torch_checkpoint(load_torch_pth(str(root / "model_final.pth"))))
    tree = jax_convert(make_torch_state_dict(SEED))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_params, "init_params", lambda model, cfg, key: tree)
    mp.setattr(jax_preprocess, "resize_image_host", resize_image_host)
    yield dict(root=root, json=json_path, images=images, npz=npz)
    mp.undo()


@pytest.fixture(scope="module")
def supports(workflow):
    """build_support of both packages on the same set."""
    w = workflow
    out = {}
    for name, fn in (("jax", jax_build_support.main), ("port", build_support.main)):
        argv = ["--json", w["json"], "--images", w["images"], "--out", str(w["root"] / f"support_{name}"),
                "--crop-size", "96"]
        mp = pytest.MonkeyPatch()
        mp.setattr("sys.argv", ["build_support"] + argv)
        try:
            fn() if name == "jax" else fn(argv)
        finally:
            mp.undo()
        out[name] = str(w["root"] / f"support_{name}" / "support_index.json")
    return out


def test_build_support_matches_jax(workflow, supports):
    ref, got = (load_support_index(supports[k]) for k in ("jax", "port"))
    assert len(got) == len(ref) > 0
    for e, r in zip(got, ref):
        assert (e.id, e.image_id, e.category_id, os.path.basename(e.file_path)) == \
            (r.id, r.image_id, r.category_id, os.path.basename(r.file_path))
        assert e.support_box == r.support_box
        with open(e.file_path, "rb") as a, open(r.file_path, "rb") as b:
            assert a.read() == b.read(), e.file_path
    # --max-per-class keeps the first crops of each class
    capped, _ = build_support.build_support(workflow["json"], workflow["images"], str(workflow["root"] / "cap"),
                                            96, max_per_class=1, imread=cv2.imread, imwrite=lambda p, a: True,
                                            resize=build_support.cv2_resize)
    assert [e.id for e in capped] == [next(e.id for e in got if e.category_id == c)
                                      for c in sorted({e.category_id for e in got})]


def _record(mp, module, out):
    """Record the detections each frame is drawn with."""
    def draw(img, boxes, scores, thresh):
        out.append((np.asarray(boxes, np.float64).reshape(-1, 4), np.asarray(scores, np.float64)))
        return img.copy()
    mp.setattr(module, "draw_detections", draw)


def _record_debug(mp, module, out):
    original = module.debug_test

    def debug(image, agn_hms, proposals, *args, **kw):
        out.append((np.asarray(image.permute(1, 2, 0) if isinstance(image, torch.Tensor) else image),
                    [np.asarray(h) for h in agn_hms],
                    {k: np.asarray(getattr(proposals, k)) for k in ("boxes", "scores", "valid")}))
        return original(image, agn_hms, proposals, *args, **kw)
    mp.setattr(module, "debug_test", debug)


def _run_demo(which, argv, draws, debugs=None):
    mp = pytest.MonkeyPatch()
    try:
        _record(mp, jax_demo if which == "jax" else demo, draws)
        if debugs is not None:
            _record_debug(mp, jax_debug_vis if which == "jax" else debug_vis, debugs)
        if which == "jax":
            mp.setattr("sys.argv", ["demo"] + argv)
            jax_demo.main()
        else:
            demo.main(argv + ["--device", "cpu"])
    finally:
        mp.undo()


def _assert_match(got, ref):
    """One frame's detections by test_torch_eval's criteria: the same count,
    >= 85% greedy-matched at IoU 0.95 with |dscore| <= 2e-4, each side's
    top 10 matched."""
    (gb, gs), (rb, rs) = got, ref
    _assert_fed_match({"boxes": gb, "scores": gs}, {"boxes": rb, "scores": rs})


@pytest.fixture(scope="module")
def glob_runs(workflow, supports):
    """The demo on the image glob, with --debug, in both packages."""
    w = workflow
    runs = {}
    for which in ("jax", "port"):
        argv = ["--input", os.path.join(w["images"], "*.jpg"), "--output", str(w["root"] / f"out_{which}"),
                "--support-index", supports["jax"], "--params", w["npz"], "--confidence", "0.0", "--debug",
                *TINY]
        draws, debugs = [], []
        _run_demo(which, argv, draws, debugs)
        runs[which] = (draws, debugs)
    return runs


def test_demo_glob_matches_jax(glob_runs):
    (got, _), (ref, _) = glob_runs["port"], glob_runs["jax"]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _assert_match(g, r)


def test_demo_debug_matches_jax(workflow, glob_runs):
    """The overlays' inputs: the denormalized canvas and the heatmaps within
    1 on 0-255, the proposals matched; each image's four PNGs written."""
    (_, got), (_, ref) = glob_runs["port"], glob_runs["jax"]
    assert len(got) == len(ref) == 3
    mean, std = jax_config.get_config().input.pixel_mean, jax_config.get_config().input.pixel_std
    for (gi, gh, gp), (ri, rh, rp) in zip(got, ref):
        a, b = debug_vis.denormalize(gi, mean, std), jax_debug_vis.denormalize(ri, mean, std)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert [h.shape for h in gh] == [h.shape for h in rh]
        assert max(float(np.abs(x - y).max()) for x, y in zip(gh, rh)) * 255 <= 1
        g, r = (((p["boxes"][p["valid"]], p["scores"][p["valid"]])) for p in (gp, rp))
        _assert_match(g, r)
    names = sorted(f for f in os.listdir(workflow["root"] / "out_port") if "_debug_" in f)
    assert names == sorted(f for f in os.listdir(workflow["root"] / "out_jax") if "_debug_" in f)
    assert len(names) == 3 * 4


def test_demo_canvases_match_jax_own_resize(workflow, glob_runs, monkeypatch):
    """The canvases the port's demo fed its detector (as --debug drew them)
    against the JAX package's preprocess_host with its own cv2 resize, not
    the port's that the module's other runs share: within one uint8 level
    on the 0-255 scale, as test_torch_preprocess holds the host path."""
    monkeypatch.setattr(jax_preprocess, "resize_image_host", JAX_RESIZE)
    assert jax_preprocess.resize_image_host is not resize_image_host
    inp = jax_config.get_config().input
    min_size, max_size = (int(next(o.split("=")[1] for o in TINY if o.startswith(f"input.{k}=")))
                          for k in ("min_size_test", "max_size_test"))
    paths = sorted(os.listdir(workflow["images"]))
    canvases = [image for image, _, _ in glob_runs["port"][1]]
    assert len(canvases) == len(paths) == 3
    for path, got in zip(paths, canvases):
        img = cv2.imread(os.path.join(workflow["images"], path))
        rh, rw = jax_preprocess.resize_shortest_edge_size(*img.shape[:2], min_size, max_size)
        canvas_hw = tuple(jax_preprocess.ceil_to(x, inp.size_divisibility) for x in (rh, rw))
        ref, _, _ = jax_preprocess.preprocess_host(img, min_size, max_size, canvas_hw, inp.pixel_mean, inp.pixel_std)
        assert got.shape == ref.shape, path
        diff = (got - ref) * np.asarray(inp.pixel_std, np.float32)
        assert np.abs(diff).max() <= HOST_U8_ATOL + 1e-3, (path, np.abs(diff).max())


def test_demo_parallel_matches_jax(workflow, supports, glob_runs):
    """--parallel (AsyncPredictor) on the glob against the JAX sequential run."""
    w = workflow
    draws = []
    _run_demo("port", ["--input", os.path.join(w["images"], "*.jpg"), "--output", str(w["root"] / "out_parallel"),
                       "--support-index", supports["port"], "--params", w["npz"], "--confidence", "0.0",
                       "--parallel", *TINY], draws)
    ref = glob_runs["jax"][0]
    assert len(draws) == len(ref) == 3
    for g, r in zip(draws, ref):
        _assert_match(g, r)
    assert sorted(os.listdir(w["root"] / "out_parallel")) == ["00000.jpg", "00001.jpg", "00002.jpg"]


def test_demo_refuses_what_is_not_ported():
    for flags, match in ((["--num-devices", "2"], "requires --video-input/--webcam"),
                         (["--config", "serving_vovnet_int8_static", "--calib-glob", "x/*.png"],
                          "needs calibration images"),
                         (["--parallel", "--debug"], "sequential")):
        with pytest.raises(SystemExit, match=match):
            demo.main(["--input", "x/*.png", "--support-index", "i.json", *flags])
    assert demo.parse_args(["--input", "x", "--support-index", "i"]).device == "cuda"


def _visualize(which, argv):
    """Run a package's visualize_features CLI -> {file name: the map it saved}."""
    module, saver = (jax_visualize, "_save_heatmap") if which == "jax" else (visualize_features, "save_heatmap")
    original, maps = getattr(module, saver), {}

    def save(arr, path, base_img=None):
        maps[os.path.basename(path)] = np.asarray(arr, np.float64)
        original(arr, path, base_img)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(module, saver, save)
        if which == "jax":  # its CLI takes no overrides
            small = jax_config.apply_overrides(jax_config.get_config("finetune_vovnet"), TINY)
            mp.setattr(jax_config, "get_config", lambda name="finetune_vovnet": small)
            mp.setattr("sys.argv", ["visualize_features"] + argv)
            jax_visualize.main()
        else:
            visualize_features.main(argv + ["--device", "cpu", *TINY])
    finally:
        mp.undo()
    return maps


def test_visualize_features_matches_jax(workflow, supports, glob_runs):
    w = workflow
    img = os.path.join(w["images"], "00000.jpg")
    maps = {which: _visualize(which, ["--input", img, "--support-index", supports["jax"], "--params", w["npz"],
                                      "--out", str(w["root"] / f"maps_{which}")])
            for which in ("jax", "port")}
    assert sorted(maps["port"]) == sorted(maps["jax"]) and len(maps["jax"]) == 9
    for name, ref in maps["jax"].items():
        got = maps["port"][name]
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), name
    assert sorted(os.listdir(w["root"] / "maps_port")) == sorted(os.listdir(w["root"] / "maps_jax"))


def test_debug_vis_matches_jax(tmp_path):
    """The same arrays into both packages' debug_vis give the same files."""
    g = np.random.default_rng(0)
    canvas = g.standard_normal((64, 96, 3)).astype(np.float32)
    mean, std = (103.5, 116.3, 123.7), (57.4, 57.1, 58.4)
    hms = [g.uniform(0, 1, (64 // s, 96 // s, 1)).astype(np.float32) for s in (8, 16, 32)]
    boxes = np.concatenate([g.uniform(0, 40, (6, 2)), g.uniform(50, 90, (6, 2))], 1).astype(np.float32)
    scores = g.uniform(0, 1, 6).astype(np.float32)
    valid = np.asarray([True] * 5 + [False])
    props = Proposals(*map(torch.from_numpy, (boxes, scores, valid)))
    dets = Detections(torch.from_numpy(boxes), torch.from_numpy(scores), torch.zeros(6, dtype=torch.int32),
                      torch.from_numpy(valid))
    port_paths = debug_vis.debug_test(torch.from_numpy(canvas).permute(2, 0, 1), [torch.from_numpy(h) for h in hms],
                                      props, str(tmp_path / "port"), pixel_mean=mean, pixel_std=std)
    port_paths.append(debug_vis.debug_second_stage(canvas, dets, str(tmp_path / "port"), pixel_mean=mean,
                                                   pixel_std=std))
    jax_paths = jax_debug_vis.debug_test(canvas, hms, props, str(tmp_path / "jax"), pixel_mean=mean, pixel_std=std)
    jax_paths.append(jax_debug_vis.debug_second_stage(canvas, dets, str(tmp_path / "jax"), pixel_mean=mean,
                                                      pixel_std=std))
    assert len(port_paths) == len(jax_paths) == 5
    for a, b in zip(port_paths, jax_paths):
        assert os.path.basename(a) == os.path.basename(b)
        np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))
    targets = CenterNetTargets(None, torch.from_numpy(g.uniform(0, 1, 8 * 12 + 4 * 6 + 2 * 3).astype(np.float32)),
                               torch.tensor([3, 100, 121]), torch.tensor([True, True, False]))
    gt_valid = np.asarray([True, False, True])
    for debug_train, out in ((debug_vis.debug_train, "port"), (jax_debug_vis.debug_train, "jax")):
        paths = debug_train(canvas, targets, boxes[:3], gt_valid, (64, 96), (8, 16, 32), str(tmp_path / out),
                            pixel_mean=mean, pixel_std=std)
        assert [os.path.basename(p) for p in paths] == [f"train_gthm_{i}.png" for i in range(3)] + ["train_blend.png"]
    for name in os.listdir(tmp_path / "jax"):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / name)), cv2.imread(str(tmp_path / "jax" / name)))
    flat = g.standard_normal((8 * 12 + 4 * 6 + 2 * 3, 2))
    for x, y in zip(debug_vis.split_levels(torch.from_numpy(flat), (64, 96), (8, 16, 32)),
                    jax_debug_vis.split_levels(flat, (64, 96), (8, 16, 32))):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(debug_vis.blend_heatmaps(debug_vis.denormalize(canvas, mean, std), hms[:1]),
                                  jax_debug_vis.blend_heatmaps(jax_debug_vis.denormalize(canvas, mean, std), hms[:1]))
