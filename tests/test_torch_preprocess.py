"""The port's preprocessing against the JAX package's, on the CPU: the
resize arithmetic exactly, the device path (``jax.image.resize``'s
antialiased bilinear weights) within 2e-3 of a level on the 0-255 scale, and the
host path (PyTorch bilinear, no image library) within one uint8 level of
cv2's INTER_LINEAR, which rounds in fixed point."""

import dataclasses
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.pipelines import preprocess as jp
from faster_orefsdet_tpu_torch import config_yaml
from faster_orefsdet_tpu_torch.config import InputConfig, get_config
from faster_orefsdet_tpu_torch.pipelines import preprocess as tp

import torch_budget  # noqa: F401 (the suite's torch thread budget)

DEVICE_ATOL = 2e-3  # f32 sums in another order (JAX's CPU einsum is ~9e-4 off the exact value)
HOST_U8_ATOL = 1  # cv2 rounds its weights to fixed point
HOST_F32_ATOL = 0.02  # cv2 holds f32 weights in a fixed-point table too
MEAN, STD = (103.53, 116.28, 123.675), (57.375, 57.12, 58.395)


def test_resize_sizes_and_canvases_exact():
    sizes = [96, 120, 160, 200, 240, 320, 333, 480, 481, 640, 800, 1080, 1333, 1920]
    for h, w, short, max_size in itertools.product(sizes, sizes, (96, 128, 320, 800), (160, 1000, 1333)):
        assert tp.resize_shortest_edge_size(h, w, short, max_size) == \
            jp.resize_shortest_edge_size(h, w, short, max_size), (h, w, short, max_size)
    for x in range(1, 400, 7):
        assert tp.ceil_to(x) == jp.ceil_to(x) and tp.ceil_to(x, 64) == jp.ceil_to(x, 64)
    buckets = [(320, 448), (448, 320), (640, 640)]
    for nh, nw in itertools.product((100, 320, 330, 447, 600, 700), repeat=2):
        assert tp.canvas_for(nh, nw, buckets) == jp.canvas_for(nh, nw, buckets)
        assert tp.canvas_for(nh, nw) == jp.canvas_for(nh, nw)


def _fsod_c4_input() -> InputConfig:
    # Base-FSOD-C4.yaml's test size, as the baseline's serving cell reads it
    yaml = Path(__file__).resolve().parents[1] / "configs/fsod/Base-FSOD-C4.yaml"
    test = config_yaml.load_merged_yaml(str(yaml))["INPUT"]
    return InputConfig(min_size_test=int(test["MIN_SIZE_TEST"]), max_size_test=int(test["MAX_SIZE_TEST"]))


@pytest.mark.parametrize("frame_hw,inputs,canvas_hw", [
    ((480, 640), "serving_vovnet", (320, 448)),
    ((480, 640), "fsod_c4", (608, 800)),
    ((333, 250), "serving_vovnet", (448, 320)),  # resized 426x320: 426 is no multiple of 32
    ((1080, 1920), "fsod_c4", (576, 1024)),  # resized 562x1000, the long side capped
    ((200, 300), "divisibility_64", (320, 512)),  # resized 320x480: 480 is no multiple of 64
], ids=["vga-serving_vovnet", "vga-fsod_c4", "333x250-serving_vovnet", "1080p-fsod_c4", "200x300-d64"])
def test_frame_geometry_matches_jax(frame_hw, inputs, canvas_hw):
    """The raw-frame builders' geometry against the JAX package's resize
    arithmetic, canvas rule and scale back to the frame."""
    inp = {"serving_vovnet": lambda: get_config("serving_vovnet").input, "fsod_c4": _fsod_c4_input,
           "divisibility_64": lambda: dataclasses.replace(get_config("serving_vovnet").input,
                                                          size_divisibility=64)}[inputs]()
    h, w = frame_hw
    rh, rw = jp.resize_shortest_edge_size(h, w, inp.min_size_test, inp.max_size_test)
    geo = tp.frame_geometry(h, w, inp)
    assert geo.resized_hw == (rh, rw)
    assert geo.canvas_hw == jp.canvas_for(rh, rw, divisibility=inp.size_divisibility) == canvas_hw
    assert geo.scale_hw == (h / rh, w / rw)


def test_normalize_and_pad_exact():
    img = np.random.default_rng(0).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tp.normalize(img, MEAN, STD), jp.normalize(img, MEAN, STD))
    for x in (img, tp.normalize(img, MEAN, STD)):
        np.testing.assert_array_equal(tp.pad_to_canvas(x, (64, 64)), jp.pad_to_canvas(x, (64, 64)))
        assert tp.pad_to_canvas(x, (64, 64)).dtype == x.dtype
    with pytest.raises(ValueError, match="does not fit"):
        tp.pad_to_canvas(img, (32, 64))


@pytest.mark.parametrize("in_hw,out_hw", [((120, 160), (96, 128)), ((480, 640), (320, 427)),
                                          ((200, 300), (320, 480))],
                         ids=["120x160-96x128", "480x640-320x427", "upscale-200x300-320x480"])
def test_preprocess_device_matches_jax(in_hw, out_hw):
    g = np.random.default_rng(sum(in_hw))
    frames = g.integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    canvas = (tp.ceil_to(out_hw[0]), tp.ceil_to(out_hw[1]))
    got = tp.preprocess_device(torch.from_numpy(frames).permute(0, 3, 1, 2), out_hw, canvas, MEAN, STD)
    assert got.shape == (2, 3, *canvas) and got.dtype == torch.float32
    for i in range(2):
        ref = np.asarray(jp.preprocess_device(jnp.asarray(frames[i]), out_hw, canvas, MEAN, STD))
        # the tolerance holds on the 0-255 scale, before division by std
        diff = (got[i].permute(1, 2, 0).numpy() - ref) * np.asarray(STD, np.float32)
        assert np.abs(diff).max() <= DEVICE_ATOL, np.abs(diff).max()
        assert not got[i, :, out_hw[0]:].any() and not got[i, :, :, out_hw[1]:].any()


@pytest.mark.parametrize("in_hw", [(480, 640), (200, 300), (333, 250)], ids=str)
def test_host_path_matches_cv2(in_hw):
    g = np.random.default_rng(in_hw[0])
    img = g.integers(0, 256, (*in_hw, 3), dtype=np.uint8)
    newh, neww = tp.resize_shortest_edge_size(*in_hw, 320, 1000)
    got = tp.resize_image_host(img, newh, neww)
    ref = jp.resize_image_host(img, newh, neww)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= HOST_U8_ATOL
    f32 = tp.resize_image_host(img.astype(np.float32), newh, neww)
    assert np.abs(f32 - jp.resize_image_host(img.astype(np.float32), newh, neww)).max() <= HOST_F32_ATOL

    canvas_hw = (tp.ceil_to(newh), tp.ceil_to(neww))
    canvas, hw, scale = tp.preprocess_host(img, 320, 1000, canvas_hw, MEAN, STD)
    jcanvas, jhw, jscale = jp.preprocess_host(img, 320, 1000, canvas_hw, MEAN, STD)
    assert canvas.shape == (3, *canvas_hw) and hw == jhw and scale == jscale
    diff = (canvas.permute(1, 2, 0).numpy() - jcanvas) * np.asarray(STD, np.float32)
    assert np.abs(diff).max() <= HOST_U8_ATOL + 1e-3
