"""The CGM kernel's plain twin (and its CPU dispatch) against the JAX
package's fused Pallas kernel in interpret mode and its XLA composition.
f32 throughout; 256-term sums in another order, hence rtol = atol = 1e-5.
The CUDA kernel is held against the same plain twin on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.ops.correlation import cgm_correlate as jax_cgm_correlate
from faster_orefsdet_tpu.ops.pallas_cgm import cgm_correlate_fused as jax_fused
from faster_orefsdet_tpu_torch.ops import cgm_cuda
from faster_orefsdet_tpu_torch.ops.correlation import cgm_correlate

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
