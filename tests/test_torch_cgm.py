"""The CGM kernel's plain twin (and its CPU dispatch) against the JAX
package's fused Pallas kernel in interpret mode and its XLA composition.
f32 throughout; 256-term sums in another order, hence rtol = atol = 1e-5.
Taps with a leading class axis stack the classes' results class-major.
The CUDA kernel is held against the same plain twin on the card by
chip_smoke.py."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.ops.correlation import cgm_correlate as jax_cgm_correlate
from faster_orefsdet_tpu.ops.pallas_cgm import cgm_correlate_fused as jax_fused
from faster_orefsdet_tpu_torch.ops import cgm_cuda
from faster_orefsdet_tpu_torch.ops.correlation import cgm_correlate

import torch_budget  # noqa: F401 (the suite's torch thread budget)

C = 128


def _inputs(seed, b, h, w):
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, h, w, C), dtype=np.float32)
    k1 = g.standard_normal((C,), dtype=np.float32)
    k13 = g.standard_normal((3, C), dtype=np.float32)
    k31 = g.standard_normal((3, C), dtype=np.float32)
    w3 = (g.standard_normal((2 * C, C)) / np.sqrt(2 * C)).astype(np.float32)
    b3 = (0.1 * g.standard_normal((C,))).astype(np.float32)
    return q, k1, k13, k31, w3, b3


# p3/p4/p5 of a 96x128 canvas, and p3 of the 320x448 serving canvas
@pytest.mark.parametrize("h,w", [(12, 16), (6, 8), (3, 4), (40, 56)])
@pytest.mark.parametrize("b", [1, 3])
def test_plain_twin_matches_jax(b, h, w):
    q, k1, k13, k31, w3, b3 = _inputs(h * w + b, b, h, w)
    # the port takes nn.Linear's weight [C, 2C] as stored: w3 [2C, C] transposed
    t = [torch.from_numpy(a) for a in (q, k1, k13, k31, np.ascontiguousarray(w3.T), b3)]
    got = cgm_cuda.cgm_correlate_fused(*t).numpy()  # CPU tensors: the plain twin
    np.testing.assert_array_equal(got, cgm_cuda.cgm_fused_plain(*t).numpy())

    j = [jnp.asarray(a) for a in (k1, k13, k31, w3, b3)]
    pallas = np.stack([np.asarray(jax_fused(jnp.asarray(q[i]), *j, interpret=True)) for i in range(b)])
    corr = jax_cgm_correlate(jnp.asarray(q), *j[:3])
    xla = np.asarray(jnp.maximum(jnp.concatenate([corr, jnp.asarray(q)], -1) @ j[3] + j[4], 0.0))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_correlation_chain_matches_jax():
    q, k1, k13, k31, _, _ = _inputs(3, 2, 9, 11)
    got = cgm_correlate(*(torch.from_numpy(a) for a in (q, k1, k13, k31))).numpy()
    ref = np.asarray(jax_cgm_correlate(*(jnp.asarray(a) for a in (q, k1, k13, k31))))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_bf16_input_is_widened_exactly():
    """bf16 in, bf16 out: the f32 result of the widened input, rounded once."""
    q, k1, k13, k31, w3, b3 = _inputs(4, 1, 6, 8)
    qb = torch.from_numpy(q).bfloat16()
    rest = [torch.from_numpy(a) for a in (k1, k13, k31, np.ascontiguousarray(w3.T), b3)]
    got = cgm_cuda.cgm_correlate_fused(qb, *rest)
    assert got.dtype == torch.bfloat16
    ref = cgm_cuda.cgm_fused_plain(qb.float(), *rest)
    assert ref.dtype == torch.float32
    torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)
    f32 = cgm_cuda.cgm_correlate_fused(qb, *rest, out_dtype=torch.float32)
    torch.testing.assert_close(f32, ref, rtol=0, atol=0)


def _class_inputs(seed, n, b, h, w, c):
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, h, w, c), dtype=np.float32)
    k1 = g.standard_normal((n, c), dtype=np.float32)
    k13 = g.standard_normal((n, 3, c), dtype=np.float32)
    k31 = g.standard_normal((n, 3, c), dtype=np.float32)
    w3 = (g.standard_normal((c, 2 * c)) / np.sqrt(2 * c)).astype(np.float32)
    b3 = (0.1 * g.standard_normal((c,))).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k1, k13, k31, w3, b3)]


@pytest.mark.parametrize("c", [64, 160])
@pytest.mark.parametrize("n", [1, 3])
def test_class_axis_stacks_single_class_calls(n, c):
    """Taps with a leading class axis give the N single-class results
    stacked class-major (row c*B + i: class c, image i), bit for bit."""
    q, k1, k13, k31, w3, b3 = _class_inputs(n * c, n, 2, 5, 7, c)
    ref = torch.cat([cgm_cuda.cgm_fused_plain(q, k1[i], k13[i], k31[i], w3, b3) for i in range(n)])
    for fn in (cgm_cuda.cgm_fused_plain, cgm_cuda.cgm_correlate_fused):
        got = fn(q, k1, k13, k31, w3, b3)
        assert got.shape == (n * 2, 5, 7, c)
        assert torch.equal(got, ref)
    got = cgm_cuda.cgm_correlate_fused(q.bfloat16(), k1, k13, k31, w3, b3)
    assert torch.equal(got, torch.cat([cgm_cuda.cgm_fused_plain(q.bfloat16(), k1[i], k13[i], k31[i], w3, b3)
                                       for i in range(n)]))


def test_class_axis_reaches_the_kernel(monkeypatch):
    """On the CUDA path (the library stubbed, as there is no card) taps with
    a class axis are one launch that is told the class count, with an output
    of N*B rows; taps whose class axes disagree are refused."""
    calls = []

    class Lib:
        @staticmethod
        def cgm_forward(*args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(cgm_cuda._native, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    q, k1, k13, k31, w3, b3 = _class_inputs(0, 3, 2, 4, 6, 160)
    before = cgm_cuda.counter.launches
    out = cgm_cuda.cgm_correlate_fused(q, k1, k13, k31, w3, b3)
    assert out.shape == (6, 4, 6, 160) and cgm_cuda.counter.launches == before + 1
    assert calls[-1][9:14] == (2, 4, 6, 160, 3)  # B, H, W, C, n_cls
    out = cgm_cuda.cgm_correlate_fused(q, k1[0], k13[0], k31[0], w3, b3)
    assert out.shape == (2, 4, 6, 160) and calls[-1][13] == 1
    with pytest.raises(ValueError, match="k13 must be float32"):
        cgm_cuda.cgm_correlate_fused(q, k1, k13[:2], k31, w3, b3)
    with pytest.raises(ValueError, match="k1 must be"):
        cgm_cuda.cgm_correlate_fused(q, k1[None], k13[None], k31[None], w3, b3)
