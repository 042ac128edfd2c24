"""The port's `ops` and `models` packages export the JAX package's names;
importing `ops` loads no kernel wrapper; the two depthwise correlations
equal the JAX package's (f32, CPU, 1e-6 relative)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faster_orefsdet_tpu.models as jax_models
import faster_orefsdet_tpu.ops as jax_ops
from faster_orefsdet_tpu.ops import correlation as jax_corr
import faster_orefsdet_tpu_torch.models as models
import faster_orefsdet_tpu_torch.ops as ops

import torch_budget  # noqa: F401 (the suite's torch thread budget)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("pkg,jax_pkg", [(ops, jax_ops), (models, jax_models)], ids=["ops", "models"])
def test_exports_match_jax(pkg, jax_pkg):
    assert pkg.__all__ == jax_pkg.__all__
    for name in jax_pkg.__all__:
        assert callable(getattr(pkg, name)) or isinstance(getattr(pkg, name), dict), name


def test_ops_import_loads_no_kernel_wrapper():
    code = textwrap.dedent(
        """
        import sys
        from faster_orefsdet_tpu_torch.ops import nms_mask, cgm_correlate, depthwise_correlate_1x1
        from faster_orefsdet_tpu_torch.ops import *
        loaded = sorted(m for m in sys.modules if m.startswith("faster_orefsdet_tpu_torch.ops."))
        print(",".join(loaded))
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.strip().split(",")
    assert "faster_orefsdet_tpu_torch.ops.nms" in loaded
    for wrapper in ("cgm_cuda", "nms_cuda", "roi_align_cuda", "_native"):
        assert f"faster_orefsdet_tpu_torch.ops.{wrapper}" not in loaded


def _maps(seed, lead=(2,), h=7, w=9, c=24):
    g = np.random.default_rng(seed)
    q = g.standard_normal((*lead, h, w, c), dtype=np.float32)
    return q, g.standard_normal((c,), dtype=np.float32), g.standard_normal((3, c), dtype=np.float32), \
        g.standard_normal((3, c), dtype=np.float32)


@pytest.mark.parametrize("lead", [(2,), (3, 2)], ids=["batch", "class_batch"])
def test_depthwise_correlate_1x1_matches_jax(lead):
    q, k, _, _ = _maps(1, lead)
    got = ops.depthwise_correlate_1x1(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    ref = np.asarray(jax_corr.depthwise_correlate_1x1(jnp.asarray(q), jnp.asarray(k)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("lead", [(2,), (3, 2)], ids=["batch", "class_batch"])
def test_depthwise_correlate_1x3_3x1_matches_jax(lead):
    q, _, k13, k31 = _maps(2, lead)
    got = ops.depthwise_correlate_1x3_3x1(*(torch.from_numpy(a) for a in (q, k13, k31))).numpy()
    ref = np.asarray(jax_corr.depthwise_correlate_1x3_3x1(*(jnp.asarray(a) for a in (q, k13, k31))))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
