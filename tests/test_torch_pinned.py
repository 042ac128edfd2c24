"""The port's pinned builders on the CPU: capture safety and equality with
the eager builders.

On the card a pinned builder captures its request body once into a CUDA
graph (``pipelines.graphs.PinnedFn``). A capture fails, or a replay reads
stale memory, where the body waits for the device or copies from the host.
``CaptureSafety``, a ``TorchDispatchMode``, records the aten ops of one
eager run of a body after a warm-up run (as a capture follows its
warm-up), the kernels' plain twins left unrecorded (on the card each is
one launch), and refuses: scalar reads (``item``,
``_local_scalar_dense``, ``is_nonzero``, ``equal``), ops whose output size
depends on the data (``nonzero``, one-argument ``where``,
``masked_select``, ``unique*``, indexing or index_put with a bool index),
tensors made from host data in the body (``lift_fresh``) and copies to
the CPU (``to`` / ``_to_copy`` naming the CPU). It is calibrated both ways:
the query path that ``PinnedInferenceFn`` has captured on the card since
PR 2 passes it, and toy bodies with each refused op fail it. Then every
new pinned body (raw-frame serving, multiclass, one-stage, baseline)
must pass it.

On the CPU every pinned builder runs its eager path, so each must give its
eager builder's detections bit for bit. Sizes: ``test_torch_serving``'s
small-budget finetune_vovnet at 96x128 canvases (120x160 frames), the
one-stage detector over P3-P7 at 256x384 with 3 classes, the baseline at
96x128 with 2 shots of 64x64; seeded port inits, random support caches."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
from faster_orefsdet_tpu_torch.pipelines import attention_rpn as tpipe
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines import onestage
from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache, stack_support_caches
from faster_orefsdet_tpu_torch.utils.params import init_baseline_params, init_onestage_params, init_params
from test_torch_onestage import p3_p7
import torch_budget  # noqa: F401 (the suite's torch thread budget)

FRAME_HW, CANVAS, IMAGE_HW = (120, 160), (96, 128), (96.0, 120.0)
ONESTAGE_CANVAS, ONESTAGE_HW = (256, 384), (256.0, 360.0)
SCALAR_READS = {"aten::item", "aten::_local_scalar_dense", "aten::is_nonzero", "aten::equal"}
DATA_SIZED = {"aten::nonzero", "aten::nonzero_static", "aten::masked_select", "aten::unique_dim",
              "aten::unique_consecutive", "aten::unique_dim_consecutive", "aten::_unique", "aten::_unique2"}
HOST_DATA = {"aten::lift_fresh", "aten::lift_fresh_copy"}
INDEXING = {"aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"}
COPIES = {"aten::to", "aten::_to_copy"}


def _names_cpu(args, kwargs) -> bool:
    return any(isinstance(a, torch.device) and a.type == "cpu" or a == "cpu"
               for a in (*args, *kwargs.values()))


def _bool_index(args) -> bool:
    indices = args[1] if len(args) > 1 else ()
    return any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8) for i in indices or ())


class CaptureSafety(TorchDispatchMode):
    """Records the ops of a run that a CUDA graph cannot hold (the module's
    docstring lists them) in `refused`, as "aten::name.overload"."""

    def __init__(self):
        super().__init__()
        self.refused = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if (name in SCALAR_READS | DATA_SIZED | HOST_DATA
                or (name == "aten::where" and func._overloadname == "default")
                or (name in INDEXING and _bool_index(args))
                or (name in COPIES and _names_cpu(args[1:], kwargs))):
            self.refused.append(f"{name}.{func._overloadname}")
        return func(*args, **kwargs)


def refusals(run, *inputs):
    """The refused ops of run(*inputs), recorded after one warm-up run, as
    a capture follows its warm-up (device constants are made then)."""
    run(*inputs)
    with CaptureSafety() as mode:
        run(*inputs)
    return mode.refused


def _opaque(fn):
    def unrecorded(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return unrecorded


@pytest.fixture(autouse=True)
def kernels_are_one_launch(monkeypatch):
    """On the CPU the kernel wrappers run their plain twins (the NMS twin
    loops to a fixpoint, reading a flag each round); on the card each call
    is one kernel launch, so the mode does not look inside the twins."""
    monkeypatch.setattr(nms_cuda, "nms_mask_plain", _opaque(nms_cuda.nms_mask_plain))
    monkeypatch.setattr(cgm_cuda, "cgm_fused_plain", _opaque(cgm_cuda.cgm_fused_plain))


def _small(cfg):
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=128, post_nms_topk_test=32),
        roi=dataclasses.replace(cfg.roi, detections_per_image=24),
        input=dataclasses.replace(cfg.input, min_size_test=96, max_size_test=160),
    )


def _cache(seed):
    g = np.random.default_rng(seed)
    return SupportCache(*(torch.from_numpy((0.5 * g.standard_normal((s, s, 128))).astype(np.float32))
                          for s in (32, 16, 8, 8, 4)))


def _frames(seed, n):
    # pixels near the mean: O(1) normalized values, as test_torch_serving's
    mean = np.asarray(get_config().input.pixel_mean, np.float32)
    g = np.random.default_rng(seed)
    u8 = np.clip(np.rint(mean + 8.0 * g.standard_normal((n, *FRAME_HW, 3))), 0, 255).astype(np.uint8)
    return torch.from_numpy(u8).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def serving():
    cfg = _small(get_config("finetune_vovnet"))
    sd = init_params(cfg, seed=1)
    caches = [_cache(s) for s in (0, 1, 2)]
    img = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 3, *CANVAS)).astype(np.float32))
    return dict(cfg=cfg, sd=sd, caches=caches, mcache=stack_support_caches(caches), img=img,
                hw=torch.tensor([IMAGE_HW]), frames=_frames(4, 2))


@pytest.fixture(scope="module")
def one():
    cfg = p3_p7(get_config("finetune_vovnet"), 3)
    img = np.random.default_rng(13).standard_normal((1, 3, *ONESTAGE_CANVAS)).astype(np.float32)
    return dict(cfg=cfg, sd=init_onestage_params(cfg, seed=3), img=torch.from_numpy(img),
                hw=torch.tensor([ONESTAGE_HW]))


@pytest.fixture(scope="module")
def baseline():
    cfg = tpipe.BaselineConfig(rpn_pre_nms_topk_test=128, rpn_post_nms_topk_test=32, detections_per_image=10,
                               support_shot=2)
    sd = init_baseline_params(50, seed=0)
    g = np.random.default_rng(9)
    sup = torch.from_numpy(g.standard_normal((2, 3, 64, 64)).astype(np.float32))
    cache = tpipe.build_baseline_cache(cfg, sd, sup, torch.tensor([[4.0, 6.0, 50.0, 60.0], [10.0, 2.0, 60.0, 44.0]]),
                                       device="cpu")
    img = torch.from_numpy(g.standard_normal((3, *CANVAS)).astype(np.float32))
    return dict(cfg=cfg, sd=sd, cache=cache, img=img, hw=torch.tensor(IMAGE_HW))


def _bodies(serving, one, baseline):
    """(pinned function, the inputs of its captured body) for each path."""
    s, o, b = serving, one, baseline
    raw, _ = tinf.build_pinned_serving_fn(s["cfg"], s["sd"], s["caches"][0], FRAME_HW, device="cpu")
    return {
        "raw_frames": (raw, (s["frames"],)),
        "multiclass": (tinf.build_pinned_multiclass_inference_fn(s["cfg"], s["sd"], s["mcache"], device="cpu"),
                       (s["img"], s["hw"])),
        "onestage": (onestage.build_pinned_onestage_inference_fn(o["cfg"], o["sd"], device="cpu"), (o["img"], o["hw"])),
        "baseline": (tpipe.build_pinned_baseline_inference_fn(b["cfg"], b["sd"], b["cache"], device="cpu"),
                     (b["img"], b["hw"])),
    }


def test_capture_safety_accepts_the_captured_query_path(serving):
    """The query path PinnedInferenceFn captures on the card, f32 canvases
    at batch 1 and uint8 canvases (normalized in the body) at batch 2."""
    s = serving
    pinned = tinf.build_pinned_inference_fn(s["cfg"], s["sd"], s["caches"][0], device="cpu")
    u8 = s["frames"][:, :, :CANVAS[0], :CANVAS[1]].contiguous()
    assert refusals(pinned.run, s["img"], s["hw"]) == []
    assert refusals(pinned.run, u8, torch.tensor([IMAGE_HW, (80.0, 100.0)])) == []


# toy bodies, each with the op the mode must refuse in it outside and inside
# inference mode (there some ops are not decomposed, as in the builders' bodies)
TOYS = {
    "item": (lambda x: x * x.sum().item(), "aten::_local_scalar_dense", "aten::item"),
    "is_nonzero": (lambda x: x * 2 if (x > 0).any() else x, "aten::_local_scalar_dense", "aten::is_nonzero"),
    "nonzero": (lambda x: torch.nonzero(x > 0), "aten::nonzero", "aten::nonzero"),
    "where_one_arg": (lambda x: torch.where(x > 0)[0], "aten::nonzero", "aten::where"),
    "bool_index": (lambda x: x[x > 0], "aten::index", "aten::index"),
    "bool_index_put": (lambda x: x.clone().index_put_((x > 1,), torch.zeros(())), "aten::index_put_",
                       "aten::index_put_"),
    "host_data": (lambda x: x * torch.tensor([1.0, 2.0, 3.0]), "aten::lift_fresh", "aten::lift_fresh"),
    "to_cpu": (lambda x: x.to("cpu", torch.float64), "aten::_to_copy", "aten::to"),
    "unique": (lambda x: torch.unique(x, dim=0), "aten::unique_dim", "aten::unique_dim"),
}


@pytest.mark.parametrize("inference", [False, True], ids=["grad_mode", "inference_mode"])
@pytest.mark.parametrize("toy", list(TOYS))
def test_capture_safety_refuses_a_sync_or_host_copy(toy, inference):
    fn, op_outside, op_inside = TOYS[toy]
    with torch.inference_mode(inference):
        got = refusals(fn, torch.randn(4, 3))
    op = op_inside if inference else op_outside
    assert any(r.startswith(op + ".") for r in got), got


@pytest.mark.parametrize("path", ["raw_frames", "multiclass", "onestage", "baseline"])
def test_pinned_bodies_are_capture_safe(serving, one, baseline, path):
    fn, inputs = _bodies(serving, one, baseline)[path]
    assert refusals(fn.run, *inputs) == []


def _assert_equal(got, ref):
    assert type(got) is type(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert ref.valid.any()


def test_pinned_serving_equals_eager(serving):
    s = serving
    fn, canvas = tinf.build_pinned_serving_fn(s["cfg"], s["sd"], s["caches"][0], FRAME_HW, device="cpu")
    eager, eager_canvas = tinf.build_serving_fn(s["cfg"], s["sd"], FRAME_HW, device="cpu")
    assert canvas == eager_canvas == CANVAS
    _assert_equal(fn(s["frames"]), eager(s["caches"][0], s["frames"]))
    assert not fn.graphs and fn.kernel_launches() == {"cgm": 0, "nms": 0}
    with pytest.raises(ValueError, match="serves 120x160"):
        fn(torch.zeros(1, 3, *CANVAS))


def test_pinned_multiclass_equals_eager(serving):
    s = serving
    fn = tinf.build_pinned_multiclass_inference_fn(s["cfg"], s["sd"], s["mcache"], device="cpu")
    ref = tinf.build_multiclass_inference_fn(s["cfg"], s["sd"], device="cpu")(s["mcache"], s["img"][0], IMAGE_HW)
    _assert_equal(fn(s["img"][0], IMAGE_HW), ref)
    batch = fn(s["img"], s["hw"])  # a batch of one: [1, K, ...]
    _assert_equal(type(ref)(*(t[0] for t in batch)), ref)


def test_pinned_onestage_equals_eager(one):
    o = one
    fn = onestage.build_pinned_onestage_inference_fn(o["cfg"], o["sd"], device="cpu")
    eager = onestage.build_onestage_inference_fn(o["cfg"], o["sd"], device="cpu")
    _assert_equal(fn(o["img"][0], ONESTAGE_HW), eager(o["img"][0], ONESTAGE_HW))
    with pytest.raises(ValueError, match="size_divisibility"):
        fn(torch.zeros(3, 160, 224), (160.0, 224.0))


def test_pinned_baseline_equals_eager(baseline):
    b = baseline
    fn = tpipe.build_pinned_baseline_inference_fn(b["cfg"], b["sd"], b["cache"], device="cpu")
    eager = tpipe.build_baseline_inference_fn(b["cfg"], b["sd"], device="cpu")
    _assert_equal(fn(b["img"], IMAGE_HW), eager(b["cache"], b["img"], IMAGE_HW))
