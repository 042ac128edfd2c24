"""The port's int8 ops and layers (``ops/quant.py``, ``models/layers.QuantConv``,
the resident ``ConvNorm``, the quantized VoVNet + FPN) against the JAX
package's, on the CPU. Inputs are seeded numpy arrays, NHWC / HWIO on the
JAX side and NCHW / OIHW here. The int8 tensors and the int32 accumulators
must be equal exactly; dequantized results within 1e-6 relative (the same
f32 products); a whole quantized backbone + FPN, where an f32 difference
upstream may flip a rare int8 rounding, within 1e-3 of each level's
largest value.

The whole-model reference is the JAX package's forward run op by op
(``jax.disable_jit``). The float ops between the int8 convs (the eSE's
mean and 1x1 conv) sum in another order than XLA's and differ in the last
bits; an int8 quantization erases that unless a value sits at a rounding
boundary, and a dynamic scale, an abs-max, passes it on to a whole tensor's
grid. Measured over the inputs of seeds 20-27 (this file's features case is
seed 20): with static scales the port's levels equal JAX's bit for bit at
all eight; the dynamic int8 preset is within 3e-7 of the largest value at
six and 3.3e-3 and 1.6e-2 at two, where a flipped rounding ran through the
later convs. Under ``jax.jit`` XLA's CPU backend also contracts FrozenBN's
multiply and add into one FMA (one ulp off on about 12% of an epilogue's
values, read from the fused HLO), so the jitted forward differs from its
own op-by-op run by as much (2.4% of p3's largest under int8_resident with
the port's scales at seed 20): it is not the reference of an exact check.
The serving tests hold the port against the jitted builders.

Calibration is a dynamic pass: its scales equal JAX's op-by-op calibration
within CALIB_RTOL before the first float reduction (the stem's and stage
2's keys) and within CALIB_FLIP_RTOL after it (measured at most 6.7e-3
over seeds 20-27, typically below 5e-7; the jitted JAX calibration is about
1% off its own op-by-op run)."""

CALIB_RTOL = 1e-5
CALIB_FLIP_RTOL = 1e-2

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.models import layers as jlayers
from faster_orefsdet_tpu.ops import quant as jq
from faster_orefsdet_tpu.pipelines import inference as jinf
from faster_orefsdet_tpu.pipelines import quant_calib as jcalib
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models import layers
from faster_orefsdet_tpu_torch.models.detector import CenterNet2Detector
from faster_orefsdet_tpu_torch.ops import quant
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines import quant_calib
from faster_orefsdet_tpu_torch.pipelines.quant_calib import calibrate_act_scales, load_act_scales, save_act_scales
from faster_orefsdet_tpu_torch.utils.params import from_jax_params
from test_torch_parity import make_torch_state_dict
from test_torch_pinned import refusals
import torch_budget  # noqa: F401 (the suite's torch thread budget)

DEQUANT_RTOL = 1e-6  # the same f32 products of the same int32 and scales
LEVEL_TOL = 1e-3  # of each FPN level's largest |value|: a rare int8 rounding flip upstream


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _jax_acc(xq, wq, stride, padding):
    """The JAX package's int8 conv product (its int8_conv's own call)."""
    xq = xq if xq.ndim == 4 else xq[None]
    dn = lax.conv_dimension_numbers(xq.shape, wq.shape, ("NHWC", "HWIO", "NHWC"))
    return lax.conv_general_dilated(xq, wq, (stride, stride), [(padding, padding)] * 2, dimension_numbers=dn,
                                    preferred_element_type=jnp.int32)


def _equal_nchw(got: torch.Tensor, ref):
    assert torch.equal(got, _nchw(ref)), int((got != _nchw(ref)).sum())


def _close(got: torch.Tensor, ref, rtol=DEQUANT_RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.moveaxis(np.asarray(ref, np.float32), -1, -3),
                               rtol=rtol, atol=rtol * float(np.abs(np.asarray(ref)).max()))


# ---------------------------------------------------------------- ops
@pytest.mark.parametrize("axes", [None, (1, 2, 3)], ids=["per_tensor", "per_example"])
def test_quantize_symmetric_matches_jax(axes):
    x = _x(0, (3, 9, 11, 16)) * np.asarray([1.0, 5.0, 0.01], np.float32)[:, None, None, None]
    jqx, js = jq.quantize_symmetric(jnp.asarray(x), axes=axes)
    q, s = quant.quantize_symmetric(_nchw(x), dims=axes)
    _equal_nchw(q, jqx)
    assert torch.equal(s.reshape(-1), torch.from_numpy(np.array(js).reshape(-1)))


def test_quantize_weights_per_output_channel_matches_jax():
    k = _x(1, (3, 3, 16, 24), 0.1)
    jwq, jsw = jq.quantize_symmetric(jnp.asarray(k), axes=(0, 1, 2))
    wq, sw = quant.quantize_symmetric(_oihw(k), dims=(1, 2, 3))
    assert torch.equal(wq, _oihw(jwq)) and torch.equal(sw.reshape(-1), torch.from_numpy(np.array(jsw).ravel()))


@pytest.mark.parametrize("scale", [0.0173, 0.5, 3.0])
def test_quantize_static_and_requantize_match_jax(scale):
    x = _x(2, (2, 7, 5, 8), 2.0)
    _equal_nchw(quant.quantize_static(_nchw(x), scale), jq.quantize_static(jnp.asarray(x), scale))
    qt = quant.requantize(_nchw(x), scale)
    _equal_nchw(qt.q, jq.requantize(jnp.asarray(x), scale).q)
    assert qt.scale == scale


CONV_CASES = [  # (name, x shape NHWC, kernel, stride, padding, act_scale)
    ("3x3_s1_dynamic", (2, 12, 10, 16), 3, 1, 1, None),
    ("3x3_s2_dynamic", (2, 13, 11, 16), 3, 2, 1, None),
    ("3x3_s1_static", (2, 12, 10, 16), 3, 1, 1, 0.031),
    ("3x3_s2_static", (1, 13, 11, 16), 3, 2, 1, 0.029),
    ("1x1_dynamic", (2, 6, 7, 24), 1, 1, 0, None),
    ("1x1_static", (2, 6, 7, 24), 1, 1, 0, 0.025),
    ("stem_k27_s2", (1, 16, 20, 3), 3, 2, 1, None),
    ("unbatched_3d", (9, 10, 8), 3, 2, 1, None),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_matches_jax(case):
    _, shape, ksz, stride, pad, act_scale = case
    x = _x(3, shape)
    k = _x(4, (ksz, ksz, shape[-1], 24), 0.2)
    ref = jq.int8_conv(jnp.asarray(x), jnp.asarray(k), stride, pad, act_scale=act_scale)
    got = quant.int8_conv(_nchw(x), _oihw(k), stride, pad, act_scale=act_scale)
    assert got.dtype == torch.float32 and got.shape == _nchw(ref).shape
    _close(got, ref)
    # the int8 grid and the int32 accumulator, exactly
    xb = x if x.ndim == 4 else x[None]
    if act_scale is None:
        jxq, _ = jq.quantize_symmetric(jnp.asarray(xb), axes=(1, 2, 3))
        xq, _ = quant.quantize_symmetric(_nchw(xb), dims=(1, 2, 3))
    else:
        jxq, xq = jq.quantize_static(jnp.asarray(xb), act_scale), quant.quantize_static(_nchw(xb), act_scale)
    jwq, _ = jq.quantize_symmetric(jnp.asarray(k), axes=(0, 1, 2))
    wq, _ = quant.quantize_symmetric(_oihw(k), dims=(1, 2, 3))
    _equal_nchw(xq, jxq)
    _equal_nchw(quant.int8_conv2d(xq, wq, (stride, stride), (pad, pad)), _jax_acc(jxq, jwq, stride, pad))


def test_int8_conv_per_example_scales_in_a_batch():
    """One loud image in the batch leaves the others' scales alone, as in JAX."""
    x = _x(5, (3, 8, 8, 16)) * np.asarray([1.0, 100.0, 0.1], np.float32)[:, None, None, None]
    k = _x(6, (3, 3, 16, 8), 0.2)
    got = quant.int8_conv(_nchw(x), _oihw(k), 1, 1)
    _close(got, jq.int8_conv(jnp.asarray(x), jnp.asarray(k), 1, 1))
    alone = quant.int8_conv(_nchw(x[2:]), _oihw(k), 1, 1)
    assert torch.equal(got[2:], alone)


@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar", "per_channel"])
def test_int8_conv_resident_matches_jax(per_channel):
    g = np.random.default_rng(7)
    qa = g.integers(-127, 128, (2, 9, 10, 5), np.int8)
    qb = g.integers(-127, 128, (2, 9, 10, 3), np.int8)
    k = _x(8, (3, 3, 8, 16), 0.2)
    if per_channel:
        jx = jq.qconcat([jq.QTensor(jnp.asarray(qa), 0.3), jq.QTensor(jnp.asarray(qb), 1.7)])
        x = quant.qconcat([quant.QTensor(_nchw(qa), 0.3), quant.QTensor(_nchw(qb), 1.7)])
        assert torch.equal(x.scale, torch.from_numpy(np.array(jx.scale, np.float32)))
    else:
        q = np.concatenate([qa, qb], -1)
        jx, x = jq.QTensor(jnp.asarray(q), 0.0421), quant.QTensor(_nchw(q), 0.0421)
    for stride in (1, 2):
        jacc, jfactor = jq.int8_conv_resident(jx, jnp.asarray(k), stride, 1)
        acc, factor = quant.int8_conv_resident(x, _oihw(k), stride, 1)
        assert acc.dtype == torch.int32
        _equal_nchw(acc, jacc)
        assert torch.equal(factor, torch.from_numpy(np.array(jfactor)))


def test_qconcat_scale_vectors_match_jax():
    g = np.random.default_rng(9)
    parts = [g.integers(-127, 128, (1, 4, 4, c), np.int8) for c in (3, 2, 4)]
    scales = [0.5, 2.0, 0.125]
    jcat = jq.qconcat([jq.QTensor(jnp.asarray(p), s) for p, s in zip(parts, scales)])
    cat = quant.qconcat([quant.QTensor(_nchw(p), s) for p, s in zip(parts, scales)])
    _equal_nchw(cat.q, jcat.q)
    assert torch.equal(cat.scale, torch.from_numpy(np.array(jcat.scale, np.float32)))
    # dynamic scales (0-dim tensors) give the same vector
    dyn = quant.qconcat([quant.QTensor(_nchw(p), torch.tensor(s)) for p, s in zip(parts, scales)])
    assert torch.equal(dyn.scale, cat.scale)
    assert torch.equal(cat.dequant(), _nchw(jcat.dequant()))


def test_int8_matmul_matches_jax():
    x = _x(10, (5, 3, 40))
    w = _x(11, (40, 24), 0.3)
    ref = jq.int8_matmul(jnp.asarray(x), jnp.asarray(w))
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=DEQUANT_RTOL,
                               atol=DEQUANT_RTOL * float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("m,k,n", [(1, 27, 64), (16, 40, 24), (17, 32, 8), (300, 1152, 80), (5, 3, 7)])
def test_int8_gemm_pads_to_the_card_rules_exactly(m, k, n):
    """Zero rows and columns bring any shape to cuBLASLt's rules (M > 16, K
    and N multiples of 8) without changing the product."""
    g = np.random.default_rng(m * k + n)
    a = torch.from_numpy(g.integers(-127, 128, (m, k), np.int8))
    b = torch.from_numpy(g.integers(-127, 128, (n, k), np.int8))
    got = quant.int8_gemm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, (a.long() @ b.long().t()).int())


# ---------------------------------------------------------------- layers
def _jax_quantconv(features, ksz, stride, pad, bias):
    return jlayers.QuantConv(features, (ksz, ksz), strides=stride, padding=pad, use_bias=bias)


@pytest.mark.parametrize("mode", ["dynamic", "static", "raw_dynamic", "raw_static"])
def test_quantconv_matches_jax(mode):
    x = _x(12, (2, 10, 12, 16))
    k, b = _x(13, (3, 3, 16, 32), 0.2), _x(14, (32,), 0.1)
    scales = {"": 0.027} if mode.endswith("static") else None
    jmod = _jax_quantconv(32, 3, 2, 1, True)
    conv = layers.QuantConv(16, 32, 3, 2, 1, bias=True)
    conv.load_state_dict({"weight": _oihw(k), "bias": torch.from_numpy(b)})
    raw = mode.startswith("raw")
    with jq.static_act_scales(scales):
        ref = jmod.apply({"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x), raw=raw)
    with quant.static_act_scales(scales), torch.no_grad():
        got = conv(_nchw(x), raw=raw)
    if raw:
        _equal_nchw(got[0], ref[0])
        assert torch.equal(got[1], torch.from_numpy(np.array(ref[1])))
    else:
        _close(got, ref)


def _convnorm_params(seed, cin, cout, ksz):
    k = _x(seed, (ksz, ksz, cin, cout), 0.2)
    scale, bias = 1.0 + _x(seed + 1, (cout,), 0.1), _x(seed + 2, (cout,), 0.1)
    jp = {"conv": {"kernel": jnp.asarray(k)}, "norm": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    sd = {"conv.weight": _oihw(k), "norm.scale": torch.from_numpy(scale), "norm.bias": torch.from_numpy(bias)}
    return jp, sd


@pytest.mark.parametrize("inp", ["float", "qtensor"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_resident_convnorm_matches_jax(inp, static):
    """The resident epilogue: dequant, FrozenBN, relu, requant; the int8
    output and its scale exactly as JAX's."""
    jp, sd = _convnorm_params(15, 8, 16, 3)
    x = _x(18, (2, 9, 11, 8))
    scales = {"conv": 0.02, "": 0.05} if static else None
    jmod = jlayers.ConvNorm(16, 3, quant=True, resident=True)
    mod = layers.ConvNorm(8, 16, 3, quant=True, resident=True)
    mod.load_state_dict(sd)
    layers.assign_scale_keys(mod)
    if inp == "qtensor":
        q = np.random.default_rng(19).integers(-127, 128, x.shape, np.int8)
        jx, tx = jq.QTensor(jnp.asarray(q), 0.031), quant.QTensor(_nchw(q), 0.031)
    else:
        jx, tx = jnp.asarray(x), _nchw(x)
    with jq.static_act_scales(scales):
        ref = jmod.apply({"params": jp}, jx)
    with quant.static_act_scales(scales), torch.no_grad():
        got = mod(tx)
    _equal_nchw(got.q, ref.q)
    assert float(got.scale) == float(ref.scale)
    # emit_float returns the f32 map before the requant
    jmod_f = jlayers.ConvNorm(16, 3, quant=True, resident=True, emit_float=True)
    mod_f = layers.ConvNorm(8, 16, 3, quant=True, resident=True, emit_float=True)
    mod_f.load_state_dict(sd)
    layers.assign_scale_keys(mod_f)
    with jq.static_act_scales(scales):
        ref_f = jmod_f.apply({"params": jp}, jx)
    with quant.static_act_scales(scales), torch.no_grad():
        _close(mod_f(tx), ref_f)


@pytest.mark.parametrize("which", ["quantconv", "resident_convnorm", "resident_osa"])
def test_missing_scale_raises(which):
    """An active scale dict without this module's key raises, as in JAX; it
    never falls back to a dynamic scale."""
    from faster_orefsdet_tpu_torch.models.vovnet import OSAModule

    x = torch.zeros(1, 8, 8, 8)
    mod = {"quantconv": lambda: layers.QuantConv(8, 8, 3, padding=1),
           "resident_convnorm": lambda: layers.ConvNorm(8, 8, 3, resident=True),
           "resident_osa": lambda: OSAModule(8, 8, 16, 3, resident=True)}[which]()
    layers.assign_scale_keys(mod, "backbone/m")
    match = {"quantconv": "no calibrated activation scale for conv 'backbone/m'",
             "resident_convnorm": "no calibrated activation scale for conv 'backbone/m/conv'",
             "resident_osa": "no calibrated input scale for OSA 'backbone/m'"}[which]
    with quant.static_act_scales({"backbone/other": 1.0}), pytest.raises(ValueError, match=match), torch.no_grad():
        mod(x)


# ---------------------------------------------------------------- the quantized backbone + FPN
PRESETS = ("serving_vovnet_int8", "serving_vovnet_int8_static", "serving_vovnet_int8_resident")


@pytest.fixture(scope="module")
def weights():
    params = convert_torch_checkpoint(make_torch_state_dict(seed=3))
    return params, from_jax_params(jax.tree.map(np.asarray, params))


def test_quantized_detector_loads_the_float_state_dict(weights):
    """QuantConv has nn.Conv2d's parameters: every quantized preset builds a
    detector whose state_dict has the float one's keys and shapes, and it
    loads the converted checkpoint strictly."""
    _, sd = weights
    ref = CenterNet2Detector(get_config("serving_vovnet_fast")).state_dict()
    for name in PRESETS:
        model = CenterNet2Detector(get_config(name))
        assert {k: v.shape for k, v in model.state_dict().items()} == {k: v.shape for k, v in ref.items()}
        model.load_state_dict(sd, strict=True)
        keys = {m.scale_key for m in model.modules() if hasattr(m, "scale_key")}
        assert "backbone/stem1/conv" in keys and "fpn/lateral3" in keys


@pytest.mark.parametrize("name", PRESETS)
def test_quantized_features_match_jax(weights, name):
    """Backbone + FPN in f32 at a 64x96 canvas (batch 2), with the port's
    calibration on the same canvases for the static presets, against the
    JAX package's op-by-op forward: the first conv's int8 input and int32
    output exactly; each level within LEVEL_TOL of its largest value."""
    params, sd = weights
    jcfg = jax_get_config(name).replace(compute_dtype="float32")
    cfg = get_config(name).replace(compute_dtype="float32")
    x = _x(20, (2, 64, 96, 3))
    jmodel = jinf.make_detector(jcfg)
    scales = None
    if cfg.quantize != "int8":
        scales = calibrate_act_scales(cfg, sd, _nchw(x), device="cpu")
    with jq.static_act_scales(scales), jax.disable_jit():
        ref = jmodel.apply({"params": params}, jnp.asarray(x), method=jmodel.features)
    model = tinf.make_detector(cfg, sd, device="cpu")
    seen = []
    orig = quant.int8_conv2d

    def tap(xq, wq, stride, padding):
        acc = orig(xq, wq, stride, padding)
        seen.append((xq, acc))
        return acc

    mp = pytest.MonkeyPatch()
    mp.setattr(quant, "int8_conv2d", tap)
    try:
        with quant.static_act_scales(scales), torch.inference_mode():
            got = model.features(_nchw(x))
    finally:
        mp.undo()
    assert len(seen) == 25
    # the stem's first conv on the JAX side: its own quantize and product
    # (int8_resident folds the input's per-tensor scale into the weights)
    k = params["backbone"]["stem1"]["conv"]["kernel"]
    xb = jnp.asarray(x)
    if scales is not None:
        s = scales["backbone/stem1/conv"]
        jxq = jq.quantize_static(xb, s)
    else:
        jxq, s = jq.quantize_symmetric(xb, axes=None if cfg.quantize == "int8_resident" else (1, 2, 3))
    w = k * jnp.asarray(s, jnp.float32) if cfg.quantize == "int8_resident" else k
    jwq = jq.quantize_symmetric(w, axes=(0, 1, 2))[0]
    _equal_nchw(seen[0][0], jxq)
    _equal_nchw(seen[0][1], _jax_acc(jxq, jwq, 2, 1))
    for level in ("p3", "p4", "p5"):
        r = np.asarray(ref[level])
        diff = np.abs(np.moveaxis(got[level].numpy(), 1, -1) - r).max()
        assert diff <= LEVEL_TOL * np.abs(r).max(), (level, diff / np.abs(r).max())


# ---------------------------------------------------------------- calibration
STATIC_PRESETS = ("serving_vovnet_int8_static", "serving_vovnet_int8_resident")


@pytest.mark.parametrize("name", STATIC_PRESETS)
def test_calibration_matches_jax(weights, name, tmp_path):
    """The same keys as the JAX package's calibration (its module paths: 25
    under either preset) and values within CALIB_RTOL before the first float
    reduction and CALIB_FLIP_RTOL after it, over 3 canvases in chunks of 2
    (the tail chunk padded by repetition on both sides); a scales file
    written by either package is read by the other."""
    params, sd = weights
    x = _x(21, (3, 64, 96, 3))
    jcfg = jax_get_config(name).replace(compute_dtype="float32")
    cfg = get_config(name).replace(compute_dtype="float32")
    got = calibrate_act_scales(cfg, sd, _nchw(x), max_batch=2, device="cpu")
    with jax.disable_jit():
        ref = jcalib.calibrate_act_scales(jcfg, params, jnp.asarray(x), max_batch=2)
    assert sorted(got) == sorted(ref) and len(got) == 25
    for k in ref:
        early = k.startswith(("backbone/stem", "backbone/stage2_"))
        assert got[k] == pytest.approx(ref[k], rel=CALIB_RTOL if early else CALIB_FLIP_RTOL), k
    if name.endswith("resident"):
        assert {"backbone/stem1/conv", "backbone/stem1", "backbone/stage3_block0",
                "backbone/stage2_block0/layer2", "fpn/output5"} <= set(got)
    else:
        assert {"backbone/stem1/conv", "backbone/stage2_block0/concat/conv", "fpn/lateral3"} <= set(got)
    save_act_scales(str(tmp_path / "port.json"), got)
    jcalib.save_act_scales(str(tmp_path / "jax_of_port.json"), got)  # byte for byte the JAX package's file
    assert jcalib.load_act_scales(str(tmp_path / "port.json")) == got
    jcalib.save_act_scales(str(tmp_path / "jax.json"), ref)
    assert load_act_scales(str(tmp_path / "jax.json")) == ref
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax_of_port.json").read_text()


def test_calibration_chunk_is_capture_safe(weights):
    """The calibration pass's chunk body (the backbone and FPN under
    record_act_amax): no host sync, no data-sized op, no host copy
    (``test_torch_pinned``'s CaptureSafety), so a CUDA graph could hold it;
    its abs-maxes are the pass's scales on that chunk."""
    _, sd = weights
    x = _nchw(_x(21, (3, 64, 96, 3)))
    for name in STATIC_PRESETS:
        cfg = get_config(name).replace(compute_dtype="float32")
        model = tinf.make_detector(cfg, sd, device="cpu")
        with torch.inference_mode():
            assert refusals(lambda c: torch.stack(list(quant_calib.chunk_amax(model, c).values())), x[:2]) == [], name
            amax = quant_calib.chunk_amax(model, x[:2])
        scales = calibrate_act_scales(cfg, sd, x[:2], max_batch=2, device="cpu")
        assert list(amax) == list(scales), name
        assert all(scales[k] == max(float(v) / 127.0, 1e-8) for k, v in amax.items()), name


def test_calibration_refusals_match_jax(weights):
    params, sd = weights
    x = _x(22, (1, 64, 64, 3))
    for jcfg, cfg, match in ((jax_get_config("serving_vovnet_fast"), get_config("serving_vovnet_fast"),
                              "needs a quantized config"),):
        with pytest.raises(ValueError, match=match):
            jcalib.calibrate_act_scales(jcfg, params, jnp.asarray(x))
        with pytest.raises(ValueError, match=match):
            calibrate_act_scales(cfg, sd, _nchw(x), device="cpu")
    with pytest.raises(ValueError, match="no calibration images"):
        calibrate_act_scales(get_config(STATIC_PRESETS[0]), sd, torch.zeros(0, 3, 64, 64), device="cpu")
