"""The port stands alone: it imports nothing of JAX or of the JAX package,
its entry points run on the card unless asked for the CPU, and its kernel
wrappers never answer a CUDA request with the plain result."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from faster_orefsdet_tpu_torch.cli import demo, visualize_features
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.data.coco import SupportEntry
from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
from faster_orefsdet_tpu_torch.pipelines import attention_rpn, evaluate, inference, onestage, support_cache
from faster_orefsdet_tpu_torch.data import loader
from faster_orefsdet_tpu_torch.pipelines import train_step
from faster_orefsdet_tpu_torch.pipelines.async_predictor import AsyncPredictor
from faster_orefsdet_tpu_torch.parallel import make_mesh, make_sharded_serving
from faster_orefsdet_tpu_torch.parallel.eval_dp import evaluate_sharded
from faster_orefsdet_tpu_torch.parallel.mesh import Mesh
from faster_orefsdet_tpu_torch.utils import profiling

import torch_budget  # noqa: F401 (the suite's torch thread budget)

REPO = Path(__file__).resolve().parent.parent


def _run_blocked(blocked, body: str) -> subprocess.CompletedProcess:
    """Run `body` in a fresh interpreter in which importing a package of
    `blocked` raises."""
    code = f"BLOCKED = {tuple(blocked)!r}\n" + textwrap.dedent(
        """
        import importlib, importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        """
    ) + textwrap.dedent(body)
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def _import_every_module(blocked):
    """Import every module of the port and chip_smoke.py in a fresh
    interpreter in which importing a package of `blocked` raises."""
    code = f"BLOCKED = {tuple(blocked)!r}\n" + textwrap.dedent(
        """
        import importlib, importlib.abc, pkgutil, runpy, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import faster_orefsdet_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_check")
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        print(len(names), "modules")
        """
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 32


def test_port_imports_without_jax():
    _import_every_module(("jax", "jaxlib", "flax", "optax", "orbax", "faster_orefsdet_tpu", "yaml"))


@pytest.mark.parametrize("module", ["config_yaml", "models.dla", "models.bifpn", "utils.torch_convert",
                                    "utils.debug_vis", "cli.build_support", "cli.demo", "cli.visualize_features",
                                    "ops.quant", "pipelines.quant_calib", "utils.events", "parallel",
                                    "parallel.mesh", "parallel.train_dp", "parallel.serve_dp",
                                    "parallel.eval_dp", "cli.train", "pipelines.attention_rpn",
                                    "pipelines.onestage models.dlaup models.res2net models.regnet ops.deform_conv "
                                    "ops.attention ops.fed_loss data.samplers utils.profiling evaluation.coco_eval"])
def test_new_module_imports_alone(module):
    """The yaml reader, DLA and BiFPN, the checkpoint converter, the debug
    overlays, the workflow's CLIs, the int8 ops, the calibration, the
    event logger, the data-parallel package, the train command line and the
    AttentionRPN baseline (with it the ResNet and MobileNetV3 modules), the
    one-stage detector, the rest of the backbone zoo, the deformable conv,
    the attention zoo, the federated loss, the samplers, the profiling
    utilities and the COCO evaluation (these ten in one interpreter) import
    with none of jax, flax, yaml, cv2 or PIL present (the card's
    machine has no PyYAML, cv2 or PIL); the reader reads the reference's
    configs there, the baseline's included."""
    out = _run_blocked(("jax", "jaxlib", "flax", "optax", "faster_orefsdet_tpu", "yaml", "cv2", "PIL"), f"""
        import importlib
        for name in "{module}".split():
            importlib.import_module(f"faster_orefsdet_tpu_torch.{{name}}")
        if "{module}" == "parallel.train_dp":
            from faster_orefsdet_tpu_torch.parallel.train_dp import build_pinned_dp_train_step
        if "{module}" == "pipelines.attention_rpn":
            assert {{"faster_orefsdet_tpu_torch.models.resnet", "faster_orefsdet_tpu_torch.models.mobilenet",
                     "faster_orefsdet_tpu_torch.models.attention_rpn"}} <= set(sys.modules)
        from faster_orefsdet_tpu_torch.config_yaml import load_yaml_config
        assert load_yaml_config("configs/fsod/finetune_dla.yaml").fpn.out_channels == 160
        from faster_orefsdet_tpu_torch.config_yaml import load_yaml
        assert type(load_yaml("configs/fsod/Base-FSOD-C4.yaml")).__name__ == "BaselineConfig"
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        """)
    assert out.returncode == 0, out.stderr


def test_port_imports_without_image_libraries():
    """The card's machine has no cv2 and no PIL: no module of the port may
    import either when it is imported (the eval loader's default reader
    imports cv2 only when it is called)."""
    _import_every_module(("cv2", "PIL"))


def _support_cache_builder(cfg, sd):
    return support_cache.build_support_cache(cfg, sd, torch.zeros(1, 3, 64, 64), torch.zeros(1, 4))


def _encode_support_set(cfg, sd):
    entry = SupportEntry(1, 1, 1, "crop.jpg", (8.0, 8.0, 200.0, 200.0))
    crop = np.zeros((240, 240, 3), np.uint8)
    return evaluate.encode_support_set(cfg, sd, [entry], imread=lambda path: crop)


@pytest.mark.parametrize("builder", [
    lambda cfg, sd: inference.make_detector(cfg, sd),
    lambda cfg, sd: inference.build_inference_fn(cfg, sd),
    lambda cfg, sd: inference.build_batched_inference_fn(cfg, sd),
    _support_cache_builder,
    lambda cfg, sd: support_cache.load_support_cache("cache.npz"),
    lambda cfg, sd: inference.build_serving_fn(cfg, sd, (480, 640)),
    lambda cfg, sd: inference.build_pinned_inference_fn(cfg, sd, None),
    lambda cfg, sd: inference.build_multiclass_inference_fn(cfg, sd),
    lambda cfg, sd: AsyncPredictor(cfg, sd, None),
    lambda cfg, sd: evaluate.evaluate(cfg, sd, None, []),
    _encode_support_set,
    lambda cfg, sd: train_step.make_train_model(cfg, sd),
    lambda cfg, sd: train_step.build_train_state(cfg, sd),
    lambda cfg, sd: loader.train_loader([], None, 1),
    lambda cfg, sd: loader.collate([]),
    lambda cfg, sd: make_mesh(),
    lambda cfg, sd: make_sharded_serving(cfg, sd, (480, 640), Mesh((torch.device("cuda", 0),)), None),
    lambda cfg, sd: evaluate_sharded(cfg, sd, None, [], Mesh((torch.device("cuda", 0),))),
], ids=["make_detector", "build_inference_fn", "build_batched_inference_fn", "build_support_cache",
        "load_support_cache", "build_serving_fn", "build_pinned_inference_fn",
        "build_multiclass_inference_fn", "AsyncPredictor", "evaluate", "encode_support_set",
        "make_train_model", "build_train_state", "train_loader", "collate", "make_mesh",
        "make_sharded_serving", "evaluate_sharded"])
def test_builders_default_to_the_card(builder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builder(get_config("serving_vovnet"), None)


@pytest.mark.parametrize("cli", [demo, visualize_features], ids=["demo", "visualize_features"])
def test_clis_default_to_the_card(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--input", "frame.jpg", "--support-index", "support_index.json"]
    assert cli.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


@pytest.mark.parametrize("build", [inference.build_inference_fn, inference.build_batched_inference_fn],
                         ids=["build_inference_fn", "build_batched_inference_fn"])
def test_served_cache_stays_on_its_device(build):
    """A request never copies the support cache to the model's device: a
    cache elsewhere is refused before any work."""
    fn = build(get_config("serving_vovnet"), None, device="cpu")
    cache = support_cache.SupportCache(*(torch.zeros(s, s, 128, device="meta") for s in (32, 16, 8, 8, 4)))
    with pytest.raises(ValueError, match="support cache on meta"):
        fn(cache, torch.zeros(1, 3, 64, 64), torch.tensor([[64.0, 64.0]]))


def _cgm_args(device=None):
    q = torch.zeros(1, 4, 5, 128, device=device)
    c = torch.zeros(128, device=device)
    t = torch.zeros(3, 128, device=device)
    return q, c, t, t, torch.zeros(128, 256, device=device), c


def _nms_args(device=None):
    return (torch.zeros(1, 8, 4, device=device), torch.zeros(1, 8, device=device),
            torch.ones(1, 8, dtype=torch.bool, device=device))


def test_wrappers_reject_other_devices():
    with pytest.raises(ValueError):
        cgm_cuda.cgm_correlate_fused(*_cgm_args("meta"))
    with pytest.raises(ValueError):
        nms_cuda.nms_mask(*_nms_args("meta"), 0.5)


def test_wrappers_launch_or_raise_on_cuda(monkeypatch):
    """A CUDA tensor goes to the kernel; here there is no kernel to launch,
    so the call must raise, never fall back to the plain twin."""

    def plain_called(*a, **k):
        raise AssertionError("plain twin called for a CUDA tensor")

    monkeypatch.setattr(cgm_cuda, "cgm_fused_plain", plain_called)
    monkeypatch.setattr(nms_cuda, "nms_mask_plain", plain_called)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    before = (cgm_cuda.counter.launches, nms_cuda.counter.launches)
    with pytest.raises(RuntimeError):
        cgm_cuda.cgm_correlate_fused(*_cgm_args())
    with pytest.raises(RuntimeError):
        nms_cuda.nms_mask(*_nms_args(), 0.5)
    assert (cgm_cuda.counter.launches, nms_cuda.counter.launches) == before


def test_wrappers_validate_cuda_inputs(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q, *rest = _cgm_args()
    with pytest.raises(ValueError, match="q must be"):
        cgm_cuda.cgm_correlate_fused(q[0], *rest)
    with pytest.raises(ValueError, match="k1 must be"):
        cgm_cuda.cgm_correlate_fused(q[..., :64].contiguous(), *rest)
    with pytest.raises(ValueError, match="contiguous"):
        cgm_cuda.cgm_correlate_fused(q.transpose(1, 2), *rest)
    boxes, scores, valid = _nms_args()
    with pytest.raises(ValueError, match="boxes must be"):
        nms_cuda.nms_mask(boxes[..., :3].contiguous(), scores, valid, 0.5)
    with pytest.raises(ValueError, match="valid must be"):
        nms_cuda.nms_mask(boxes, scores, valid.float(), 0.5)


@pytest.mark.parametrize("name", ["serving_vovnet_int8", "serving_vovnet_int8_static", "serving_vovnet_int8_resident"])
def test_quantized_detector_runs_without_jax(name):
    """Each quantized preset's detector is built, calibrated and served on
    the CPU in an interpreter where jax, flax and the JAX package cannot be
    imported."""
    out = _run_blocked(("jax", "jaxlib", "flax", "optax", "orbax", "faster_orefsdet_tpu", "yaml"), f"""
        import torch
        from faster_orefsdet_tpu_torch.config import get_config
        from faster_orefsdet_tpu_torch.pipelines.inference import build_inference_fn
        from faster_orefsdet_tpu_torch.pipelines.quant_calib import calibrate_act_scales
        from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache
        from faster_orefsdet_tpu_torch.utils.params import init_params

        cfg = get_config("{name}").replace(compute_dtype="float32")
        sd = init_params(cfg, seed=0)
        images = torch.randn(2, 3, 64, 96)
        scales = None if cfg.quantize == "int8" else calibrate_act_scales(cfg, sd, images, device="cpu")
        cache = SupportCache(*(torch.zeros(s, s, 128) for s in (32, 16, 8, 8, 4)))
        det = build_inference_fn(cfg, sd, device="cpu", act_scales=scales)(cache, images[0], (64.0, 96.0))
        assert det.boxes.shape == (64, 4) and torch.isfinite(det.boxes).all() and det.valid.any()
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        """)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("builder", [
    lambda cfg: attention_rpn.make_fsod_rcnn(cfg),
    lambda cfg: attention_rpn.build_baseline_cache(cfg, None, torch.zeros(1, 3, 64, 64), torch.zeros(1, 4)),
    lambda cfg: attention_rpn.build_baseline_inference_fn(cfg, None),
], ids=["make_fsod_rcnn", "build_baseline_cache", "build_baseline_inference_fn"])
def test_baseline_entry_points_default_to_the_card(builder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builder(attention_rpn.BaselineConfig())


def test_resnet_family_runs_without_jax():
    """finetune_R_50_C4_1x and mnv3_fpn serve, and the AttentionRPN baseline
    builds its cache and serves, on the CPU in an interpreter where jax,
    flax and the JAX package cannot be imported."""
    out = _run_blocked(("jax", "jaxlib", "flax", "optax", "orbax", "faster_orefsdet_tpu", "yaml"), """
        import torch
        from faster_orefsdet_tpu_torch.config import get_config
        from faster_orefsdet_tpu_torch.config_yaml import load_yaml
        from faster_orefsdet_tpu_torch.pipelines import attention_rpn
        from faster_orefsdet_tpu_torch.pipelines.inference import build_inference_fn
        from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache
        from faster_orefsdet_tpu_torch.utils.params import init_baseline_params, init_params

        image = torch.randn(3, 64, 96)
        cache = SupportCache(*(torch.zeros(s, s, 128) for s in (32, 16, 8, 4, 4)))
        for cfg in (get_config("finetune_R_50_C4_1x"), get_config("serving_vovnet").replace(
                backbone_name="mnv3_fpn", compute_dtype="float32")):
            c = cache if cfg.roi.pooler_resolution == 4 else cache._replace(rcnn_8=torch.zeros(8, 8, 128))
            det = build_inference_fn(cfg, init_params(cfg, seed=0), device="cpu")(c, image, (64.0, 96.0))
            assert torch.isfinite(det.boxes).all() and det.valid.any()
        bcfg = load_yaml("configs/fsod/Base-FSOD-C4.yaml")
        sd = init_baseline_params(bcfg.depth, seed=0)
        bcache = attention_rpn.build_baseline_cache(bcfg, sd, torch.randn(2, 3, 64, 64),
                                                    torch.tensor([[4.0, 4.0, 60.0, 60.0]] * 2), device="cpu")
        det = attention_rpn.build_baseline_inference_fn(bcfg, sd, device="cpu")(bcache, image, (64.0, 96.0))
        assert torch.isfinite(det.boxes).all() and det.valid.any()
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        """)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("builder", [
    lambda cfg: onestage.make_onestage(cfg),
    lambda cfg: onestage.build_onestage_inference_fn(cfg, None),
    lambda cfg: profiling.measure_model(cfg),
], ids=["make_onestage", "build_onestage_inference_fn", "measure_model"])
def test_onestage_and_profiling_default_to_the_card(builder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builder(get_config("finetune_vovnet"))


@pytest.mark.parametrize("builder", [
    lambda: inference.build_pinned_serving_fn(get_config("serving_vovnet"), None, None, (480, 640)),
    lambda: inference.build_pinned_multiclass_inference_fn(get_config("serving_vovnet"), None, None),
    lambda: onestage.build_pinned_onestage_inference_fn(get_config("finetune_vovnet"), None),
    lambda: attention_rpn.build_pinned_baseline_inference_fn(attention_rpn.BaselineConfig(), None, None),
], ids=["build_pinned_serving_fn", "build_pinned_multiclass_inference_fn", "build_pinned_onestage_inference_fn",
        "build_pinned_baseline_inference_fn"])
def test_pinned_builders_default_to_the_card(builder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builder()


def test_coco_matcher_is_the_ports_own(monkeypatch):
    """The port keeps its own copy of the C++ matcher and builds it into its
    own build directory: evaluating loads no library from native/."""
    import ctypes

    from faster_orefsdet_tpu_torch.evaluation import coco_eval
    from faster_orefsdet_tpu_torch.ops import _native

    assert (REPO / "faster_orefsdet_tpu_torch/csrc/cocoeval.cc").is_file()
    sources = [p for p in (REPO / "faster_orefsdet_tpu_torch").rglob("*.py") if "native/" in p.read_text()]
    assert not sources, sources
    loaded = []
    cdll = ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL", lambda path, *a, **k: loaded.append(str(path)) or cdll(path, *a, **k))
    monkeypatch.setattr(coco_eval, "_NATIVE", "build")
    _native.host_library.cache_clear()
    try:
        gt = coco_eval.GTImage(1, np.asarray([[0.0, 0.0, 10.0, 10.0]]), np.zeros(1, bool), np.asarray([100.0]))
        ap = coco_eval.coco_ap([coco_eval.DetResult(1, np.asarray([[0.0, 0.0, 10.0, 10.0]]), np.ones(1))], [gt])
    finally:
        _native.host_library.cache_clear()
    assert ap["AP"] == 100.0
    assert len(loaded) == 1 and loaded[0].startswith(str(REPO / "faster_orefsdet_tpu_torch" / "_build")), loaded
