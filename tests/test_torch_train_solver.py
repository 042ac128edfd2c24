"""The port's solver against the JAX package's: the LR schedules at the
milestone edges, and three SGD steps with momentum, clipping (by value and
per-tensor norm), weight decay and the head/norm groups against optax on
the same gradients (within 1e-6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faster_orefsdet_tpu import solver as jsolver
from faster_orefsdet_tpu.config import SolverConfig as JaxSolverConfig
from faster_orefsdet_tpu_torch import solver
from faster_orefsdet_tpu_torch.config import SolverConfig

import torch_budget  # noqa: F401 (the suite's torch thread budget)

COUNTS = (0, 250, 499, 500, 10000, 10999, 11000, 11999)


@pytest.mark.parametrize("name", ["WarmupMultiStepLR", "WarmupCosineLR"])
@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedules_match_jax(name, method):
    kw = dict(lr_scheduler_name=name, warmup_method=method)
    scfg = SolverConfig(**kw)
    got = solver.build_schedule(scfg)
    ref = jsolver.build_schedule(JaxSolverConfig(**kw))
    # the JAX schedule runs in f32, so its cosine near the end of the run is
    # off by up to 3e-11 (1.3e-11 at 11999, where the LR is 1.7e-11): held
    # within 1e-6 relative or 1e-7 of the base LR; the port's, in f64,
    # equals d2's closed form
    for c in COUNTS:
        np.testing.assert_allclose(got(c), float(ref(c)), rtol=1e-6, atol=1e-7 * scfg.base_lr, err_msg=f"count {c}")
        warm = 1.0 if c >= scfg.warmup_iters else (
            scfg.warmup_factor if method == "constant"
            else scfg.warmup_factor * (1 - c / scfg.warmup_iters) + c / scfg.warmup_iters)
        decay = (0.5 * (1 + np.cos(np.pi * c / scfg.max_iter)) if name == "WarmupCosineLR"
                 else scfg.gamma ** sum(c >= m for m in scfg.steps))
        np.testing.assert_allclose(got(c), scfg.base_lr * warm * decay, rtol=1e-12)
    with pytest.raises(ValueError, match="Unknown LR scheduler"):
        solver.build_schedule(SolverConfig(lr_scheduler_name="StepLR"))


class _Tiny(torch.nn.Module):
    """Parameters named as the detector's, one per optimizer group (and a
    frozen one)."""

    def __init__(self, g):
        super().__init__()

        def p(*shape):
            return torch.nn.Parameter(torch.from_numpy(g.standard_normal(shape).astype(np.float32)))

        self.backbone = torch.nn.Module()
        self.backbone.stem1 = torch.nn.Module()
        self.backbone.stem1.weight = p(3, 4)
        self.backbone.stage4_block0 = torch.nn.Module()
        self.backbone.stage4_block0.weight = p(5, 6)
        self.head = torch.nn.Module()
        self.head.bbox_tower0_gn = torch.nn.Module()
        self.head.bbox_tower0_gn.scale = p(7)
        self.roi = torch.nn.Module()
        self.roi.stage0_cls = torch.nn.Module()
        self.roi.stage0_cls.weight = p(2, 8)


@pytest.mark.parametrize("clip", [("value", 0.5), ("norm", 2.0), ("none", 0.0)])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_steps_match_optax(clip, nesterov):
    clip_type, clip_value = clip
    cfg = SolverConfig(base_lr=0.1, warmup_iters=2, weight_decay=1e-2, weight_decay_norm=0.0, head_lr_factor=2.0,
                       clip_gradients=clip_type != "none", clip_type=clip_type if clip_type != "none" else "value",
                       clip_value=clip_value, nesterov=nesterov, steps=(1,), gamma=0.5)
    jcfg = JaxSolverConfig(**dataclasses.asdict(cfg))
    g = np.random.default_rng(0)
    model = _Tiny(g)
    model.backbone.stem1.weight.requires_grad_(False)
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    labels = solver.param_labels(model)
    assert labels == {"backbone.stem1.weight": "frozen", "backbone.stage4_block0.weight": "base",
                      "head.bbox_tower0_gn.scale": "norm", "roi.stage0_cls.weight": "head"}

    # the JAX optimizer over the same leaves, labelled by its own rules
    jtree = {"backbone": {"stem1": {"kernel": params["backbone.stem1.weight"]},
                          "stage4_block0": {"kernel": params["backbone.stage4_block0.weight"]}},
             "head": {"bbox_tower0_gn": {"scale": params["head.bbox_tower0_gn.scale"]}},
             "roi": {"stage0_cls": {"kernel": params["roi.stage0_cls.weight"]}}}
    jtree = jax.tree.map(jnp.asarray, jtree)
    tx = jsolver.build_optimizer(jcfg, jtree)
    opt_state = tx.init(jtree)
    opt = solver.build_optimizer(cfg, model)
    assert sorted(gr["name"] for gr in opt.param_groups) == ["base", "head", "norm"]
    schedule = solver.build_schedule(cfg)
    for step in range(3):
        grads = {n: (3.0 * g.standard_normal(v.shape)).astype(np.float32) for n, v in params.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy()) if p.requires_grad else None
        solver.optimizer_step(opt, cfg, schedule, step)
        jgrads = {"backbone": {"stem1": {"kernel": grads["backbone.stem1.weight"]},
                               "stage4_block0": {"kernel": grads["backbone.stage4_block0.weight"]}},
                  "head": {"bbox_tower0_gn": {"scale": grads["head.bbox_tower0_gn.scale"]}},
                  "roi": {"stage0_cls": {"kernel": grads["roi.stage0_cls.weight"]}}}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, jgrads), opt_state, jtree)
        jtree = optax.apply_updates(jtree, updates)
    got = dict(model.named_parameters())
    for path, name in ((("backbone", "stem1", "kernel"), "backbone.stem1.weight"),
                       (("backbone", "stage4_block0", "kernel"), "backbone.stage4_block0.weight"),
                       (("head", "bbox_tower0_gn", "scale"), "head.bbox_tower0_gn.scale"),
                       (("roi", "stage0_cls", "kernel"), "roi.stage0_cls.weight")):
        ref = jtree[path[0]][path[1]][path[2]]
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6, err_msg=name)
    # the frozen parameter never moved; the others did
    np.testing.assert_array_equal(got["backbone.stem1.weight"].detach().numpy(), params["backbone.stem1.weight"])
    assert not np.allclose(got["roi.stage0_cls.weight"].detach().numpy(), params["roi.stage0_cls.weight"])


def test_norm_clip_matches_torch_per_tensor():
    g = np.random.default_rng(1)
    for norm_type in (2.0, 1.5, float("inf")):
        cfg = SolverConfig(clip_type="norm", clip_value=1.0, norm_type=norm_type)
        ps = [torch.nn.Parameter(torch.zeros(s)) for s in ((7, 5), (11,), (2, 3, 4))]
        refs = []
        for p, scale in zip(ps, (3.0, 0.01, 10.0)):
            p.grad = torch.from_numpy((scale * g.standard_normal(tuple(p.shape))).astype(np.float32))
            q = torch.nn.Parameter(torch.zeros(p.shape))
            q.grad = p.grad.clone()
            torch.nn.utils.clip_grad_norm_([q], 1.0, norm_type=norm_type)
            refs.append(q.grad)
        solver.clip_gradients(ps, cfg)
        for p, ref in zip(ps, refs):
            np.testing.assert_allclose(p.grad.numpy(), ref.numpy(), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="Unknown gradient clip type"):
        solver.clip_gradients(ps, SolverConfig(clip_type="full_model"))
