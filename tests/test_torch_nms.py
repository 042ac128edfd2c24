"""The port's NMS (plain fixpoint, sequential oracle, and the [B, K] kernel
wrapper on CPU tensors) against the JAX package's ops.nms, with exact keep
masks. The CUDA kernel itself is held against the same plain fixpoint on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_orefsdet_tpu.ops import nms as jnms
from faster_orefsdet_tpu_torch.ops import nms as tnms
from faster_orefsdet_tpu_torch.ops import nms_cuda

import torch_budget  # noqa: F401 (the suite's torch thread budget)


def _scene(rng, k, n_valid, spread=200.0, size=40.0):
    centers = rng.uniform(0, spread, (k, 2)).astype(np.float32)
    wh = rng.uniform(8.0, size, (k, 2)).astype(np.float32)
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], axis=1)
    scores = rng.uniform(0.01, 1.0, (k,)).astype(np.float32)
    valid = np.zeros((k,), bool)
    valid[:n_valid] = True
    return boxes, scores, valid


def _chain(rng, k):
    xs = np.linspace(0, 400, k).astype(np.float32)
    boxes = np.stack([xs, np.zeros(k, np.float32), xs + 50, np.full(k, 50.0, np.float32)], 1)
    return boxes, rng.uniform(0.01, 1.0, (k,)).astype(np.float32), np.ones((k,), bool)


def _ties(rng, k):
    boxes, _, valid = _scene(rng, k, k, spread=120.0)
    scores = rng.choice(np.asarray([0.2, 0.5, 0.5, 0.9], np.float32), k)
    valid[rng.uniform(size=k) < 0.2] = False
    return boxes, scores, valid


def _jax(boxes, scores, valid, thr):
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr)
    return np.asarray(jnms.nms_mask(*args)), np.asarray(jnms.nms_mask_sequential(*args))


def _port(boxes, scores, valid, thr):
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr)
    return tnms.nms_mask(*args).numpy(), tnms.nms_mask_sequential(*args).numpy()


def _check(boxes, scores, valid, thr):
    fix, seq = _jax(boxes, scores, valid, thr)
    pfix, pseq = _port(boxes, scores, valid, thr)
    np.testing.assert_array_equal(pfix, fix)
    np.testing.assert_array_equal(pseq, seq)
    np.testing.assert_array_equal(pfix, pseq)
    wrapped = nms_cuda.nms_mask(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                                torch.from_numpy(valid)[None], thr)
    np.testing.assert_array_equal(wrapped[0].numpy(), fix)


@pytest.mark.parametrize("k,n_valid,thr", [
    (64, 64, 0.5), (252, 200, 0.6), (256, 170, 0.5), (512, 512, 0.3), (1024, 1000, 0.6),
    (100, 80, 0.5), (652, 600, 0.6), (1700, 1500, 0.6), (1792, 1792, 0.6),
])
def test_random_scenes(k, n_valid, thr):
    _check(*_scene(np.random.default_rng(k + n_valid), k, n_valid), thr)


@pytest.mark.parametrize("k,thr", [(256, 0.4), (1024, 0.6)])
def test_dense_chain(k, thr):
    _check(*_chain(np.random.default_rng(7), k), thr)


@pytest.mark.parametrize("k", [64, 512])
def test_exact_score_ties_and_invalid_rows(k):
    _check(*_ties(np.random.default_rng(k), k), 0.5)


def _edge_scene(kind, k):
    rng = np.random.default_rng(k)
    boxes, scores, valid = _scene(rng, k, k, spread=120.0)
    if kind == "ascending":  # the rank scatter reverses the input
        scores = np.sort(scores)
    elif kind == "equal":  # every rank decided by the index alone
        scores = np.full(k, 0.5, np.float32)
    return boxes, scores, valid


# the CUDA kernel works in chunks of 64 ranks: one box, a chunk and one over
@pytest.mark.parametrize("kind,k", [
    ("ascending", 200), ("ascending", 65), ("equal", 200), ("equal", 65), ("random", 1), ("random", 65),
])
def test_rank_order_edges(kind, k):
    _check(*_edge_scene(kind, k), 0.5)


def test_batch_with_different_valid_counts():
    rng = np.random.default_rng(11)
    k = 256
    scenes = [_scene(rng, k, n) for n in (256, 130, 1, 0)] + [_chain(rng, k), _ties(rng, k)]
    boxes = np.stack([s[0] for s in scenes])
    scores = np.stack([s[1] for s in scenes])
    valid = np.stack([s[2] for s in scenes])
    got = nms_cuda.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(valid), 0.6).numpy()
    for i in range(len(scenes)):
        fix, seq = _jax(boxes[i], scores[i], valid[i], 0.6)
        np.testing.assert_array_equal(got[i], fix, err_msg=f"image {i}")
        np.testing.assert_array_equal(got[i], seq, err_msg=f"image {i}")


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_keep_top_scores_keeps_ties(k):
    scores = np.asarray([0.9, 0.5, 0.5, 0.5, 0.1, 0.7, 0.5, 0.3], np.float32)
    valid = np.asarray([1, 1, 1, 0, 1, 1, 1, 1], bool)
    ref = np.asarray(jnms.keep_top_scores(jnp.asarray(scores), jnp.asarray(valid), k))
    got = tnms.keep_top_scores(torch.from_numpy(scores), torch.from_numpy(valid), k).numpy()
    np.testing.assert_array_equal(got, ref)
    got_b = tnms.keep_top_scores(torch.from_numpy(scores)[None].repeat(2, 1),
                                 torch.from_numpy(valid)[None].repeat(2, 1), k).numpy()
    np.testing.assert_array_equal(got_b, np.stack([ref, ref]))
