"""The port's data-parallel fine-tuning (``faster_orefsdet_tpu_torch/parallel``)
on the CPU, two gloo ranks spawned once for the module, against the JAX
package and against the port's single-process step:

- the gradients of the rank's rows of a batch, averaged over the ranks,
  against the JAX package's ``loss_fn`` under ``shard_map`` on a 2-device
  CPU mesh with its gradients ``pmean``'d (dropout off, injected ROIs); the
  two halves of the batch have different positive counts, so the
  all-reduced count matters (GRAD_TOL of each tensor's largest |grad|,
  LOSS_RTOL for the mean losses: test_torch_train_step.py's);
- 3 steps of two ranks against one process over the same global batches,
  dropout off and ROI sampling on, with the JAX package's DP tolerances
  (tests/test_parallel_dp.py): metrics rtol 5e-4 / atol 1e-5, params rtol
  1e-4 / atol 1e-6; the two ranks' weights equal bit for bit after every
  step;
- checkpoints written by the ranks resume in one process, and one process's
  resume in the ranks (continuation metrics at the metric tolerances);
- the running BatchNorm statistics of finetune_dla (tiny BiFPN) averaged
  over the ranks: bit for bit the mean of what each rank's rows give alone;
- ``build_pinned_dp_train_step`` (the step a CUDA graph holds on the
  card; eager steps here) over the same batches from the same state as
  the eager DP step: metrics and weights bit for bit every step, dropout
  off over the trajectory and on over two batches (generators equal too);
  its captured body (loss with the positive-count all-reduce, backward,
  the flat all-reduce, clip and SGD) run under ``test_torch_pinned``'s
  ``CaptureSafety`` with no op refused; on the card in a gloo group it
  refuses (the device stubbed);
- outside a group the DP step and the pinned one equal ``build_train_step``
  bit for bit;
- the small pieces: ``make_mesh``'s refusal, ``shard_batch``, the
  dropout seeds, ``centernet_losses(reg_norm=)`` against the JAX
  package's."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from faster_orefsdet_tpu.config import get_config as jax_get_config
from faster_orefsdet_tpu.models import centernet as jcn
from faster_orefsdet_tpu.parallel import make_mesh as jax_make_mesh
from faster_orefsdet_tpu.pipelines.inference import make_detector as jax_make_detector
from faster_orefsdet_tpu.pipelines.train_step import TrainBatch as JaxBatch
from faster_orefsdet_tpu.pipelines.train_step import loss_fn as jax_loss_fn
from faster_orefsdet_tpu.utils.torch_convert import convert_torch_checkpoint
from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.models import centernet
from faster_orefsdet_tpu_torch.ops.heatmap import render_targets
from faster_orefsdet_tpu_torch.parallel import build_dp_train_step, make_mesh, replicate_state, shard_batch
from faster_orefsdet_tpu_torch.parallel.mesh import spawn_ranks
from faster_orefsdet_tpu_torch.ops import nms_cuda
from faster_orefsdet_tpu_torch.parallel.train_dp import all_reduce_mean, build_pinned_dp_train_step, dropout_seed
from faster_orefsdet_tpu_torch.pipelines.train_step import (
    Replica, TrainState, build_train_state, build_train_step, loss_fn, make_train_model,
)
from faster_orefsdet_tpu_torch.utils import checkpoint
from faster_orefsdet_tpu_torch.utils.params import from_jax_params, init_params, is_batch_stat
from test_torch_dla import dla_cfg
from test_torch_parity import make_torch_state_dict
from test_torch_pinned import _opaque, refusals
from test_torch_train_ops import CANVAS, STRIDES, close, t, targets_pair  # noqa: F401 (a fixture)
from test_torch_train_step import GRAD_TOL, LOSS_RTOL, make_inputs, port_batch, small
import torch_budget  # noqa: F401 (the suite's torch thread budget)

WORLD = 2
METRIC_RTOL, METRIC_ATOL = 5e-4, 1e-5  # tests/test_parallel_dp.py's
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
TRAJECTORY_SEEDS = (11, 12, 13)  # a global batch of 2 a step
CONTINUE_SEED, BN_SEED = 14, 21
RANKS_TIMEOUT_S = 600


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for v in tensors:
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _rank_job(rank, world, device, job):
    """Everything the ranks run, in one spawn (see the module docstring)."""
    out = {}
    cfg = small(get_config("finetune_vovnet"))

    # ---- the loss of the rank's rows, its gradients averaged over the ranks
    x = make_inputs()
    mine = slice(rank, rank + 1)
    model = make_train_model(cfg, job["sd"], device=device)
    total, losses = loss_fn(model, shard_batch(port_batch(x), rank, world), deterministic=True,
                            injected_rois=(torch.from_numpy(x["rois"][mine]), torch.from_numpy(x["roi_valid"][mine])),
                            dp=Replica(rank, world, torch.Generator()))
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    values = torch.stack([total.detach(), *(v.detach() for v in losses.values())])
    all_reduce_mean([*grads.values(), values], world)
    out["grad_digest"] = _digest(grads.values())
    if rank == 0:
        out["grads"] = {n: g.numpy() for n, g in grads.items()}
        out["losses"] = dict(zip(["total_loss", *losses], values.tolist()))

    # ---- the trajectory over the global batches
    state = build_train_state(cfg, job["sd"], device=device)
    replicate_state(state)
    step = build_dp_train_step(cfg, deterministic=True)
    out["traj"], out["digests"] = [], []
    for seed in TRAJECTORY_SEEDS:
        out["traj"].append(_metrics(step(state, shard_batch(port_batch(make_inputs(seed=seed)), rank, world))))
        out["digests"].append(_digest(state.model.state_dict().values()))
    if rank == 0:
        out["params"] = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}
        checkpoint.save_checkpoint(job["dp_dir"], state)

    # ---- the pinned step from the same state over the same batches
    pinned = build_train_state(cfg, job["sd"], device=device)
    replicate_state(pinned)
    pstep = build_pinned_dp_train_step(cfg, deterministic=True)
    out["pinned_traj"], out["pinned_digests"] = [], []
    for seed in TRAJECTORY_SEEDS:
        out["pinned_traj"].append(_metrics(pstep(pinned, shard_batch(port_batch(make_inputs(seed=seed)), rank, world))))
        out["pinned_digests"].append(_digest(pinned.model.state_dict().values()))
    # dropout on: each rank's own draws at (seed, rank, step)
    out["dropout"] = {}
    for name, build in (("eager", build_dp_train_step), ("pinned", build_pinned_dp_train_step)):
        dstate = build_train_state(cfg, job["sd"], device=device)
        replicate_state(dstate)
        fn = build(cfg)
        rows = [_metrics(fn(dstate, shard_batch(port_batch(make_inputs(seed=seed)), rank, world)))
                for seed in TRAJECTORY_SEEDS[:2]]
        out["dropout"][name] = (rows, _digest(dstate.model.state_dict().values()),
                                dstate.generator.get_state().numpy().tobytes())
    # the body the card captures, one step of it under CaptureSafety
    body, rows = fn.body, shard_batch(port_batch(make_inputs(seed=CONTINUE_SEED)), rank, world)

    def body_step():
        body.prepare(dstate)
        dstate.optimizer.zero_grad(set_to_none=True)
        body.run(dstate, rows)

    mp = pytest.MonkeyPatch()
    mp.setattr(nms_cuda, "nms_mask_plain", _opaque(nms_cuda.nms_mask_plain))  # one launch on the card
    try:
        out["refused"] = refusals(body_step)
    finally:
        mp.undo()
    # a CUDA state in this gloo group: refused before any work
    mp.setattr(TrainState, "device", property(lambda self: torch.device("cuda", rank)))
    try:
        build_pinned_dp_train_step(cfg)(dstate, rows)
    except ValueError as e:
        out["gloo_refusal"] = str(e)
    finally:
        mp.undo()

    # ---- a single-process checkpoint resumed by the ranks
    resumed = checkpoint.resume_or_load(job["sd_dir"], build_train_state(cfg, job["sd"], device=device, seed=99))
    replicate_state(resumed)
    out["resumed_step"] = resumed.step
    out["continued"] = _metrics(step(resumed, shard_batch(port_batch(make_inputs(seed=CONTINUE_SEED)), rank, world)))

    # ---- the running BatchNorm statistics of finetune_dla: a DP step, and
    # the rank's rows alone through the single-process step
    dcfg = dla_cfg(get_config)
    rows = shard_batch(port_batch(make_inputs(seed=BN_SEED)), rank, world)
    for name, build in (("bn_dp", build_dp_train_step), ("bn_alone", build_train_step)):
        dstate = build_train_state(dcfg, job["dla_sd"], device=device)
        build(dcfg, deterministic=True)(dstate, rows)
        out[name] = {k: v.numpy().copy() for k, v in dstate.model.state_dict().items() if is_batch_stat(k)}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The single-process run over the global batches (and its checkpoint),
    then the two ranks."""
    root = tmp_path_factory.mktemp("dp")
    cfg = small(get_config("finetune_vovnet"))
    sd = from_jax_params(jax.tree.map(np.asarray, convert_torch_checkpoint(make_torch_state_dict(seed=5))))
    single = build_train_state(cfg, sd, device="cpu")
    step = build_train_step(cfg, deterministic=True)
    traj = [_metrics(step(single, port_batch(make_inputs(seed=seed)))) for seed in TRAJECTORY_SEEDS]
    checkpoint.save_checkpoint(str(root / "sd"), single)
    job = dict(sd=sd, dla_sd=init_params(dla_cfg(get_config), seed=3), dp_dir=str(root / "dp"),
               sd_dir=str(root / "sd"))
    ranks = spawn_ranks(_rank_job, WORLD, (job,), init_method=f"file://{root / 'store'}", device="cpu",
                        timeout=RANKS_TIMEOUT_S)
    return dict(cfg=cfg, sd=sd, job=job, ranks=ranks, traj=traj,
                params={k: v.numpy() for k, v in single.model.state_dict().items()})


@pytest.fixture(scope="module")
def jax_dp_grads():
    """The JAX package's loss_fn on a 2-device mesh (shard_map, axis_name),
    its gradients and losses pmean'd."""
    jcfg = small(jax_get_config("finetune_vovnet"))
    params = convert_torch_checkpoint(make_torch_state_dict(seed=5))
    x = make_inputs()
    model = jax_make_detector(jcfg)
    jbatch = JaxBatch(jnp.asarray(x["images"]), jnp.asarray(x["hw"]), jnp.asarray(x["gt"]),
                      jnp.zeros(x["gt"].shape[:2], jnp.int32), jnp.asarray(x["valid"]), jnp.asarray(x["sup"]),
                      jnp.asarray(x["sup_boxes"]))

    def per_replica(p, batch, rois, roi_valid):
        (total, losses), grads = jax.value_and_grad(
            lambda q: jax_loss_fn(q, batch, model, jcfg, jax.random.PRNGKey(0), "data", deterministic=True,
                                  injected_rois=(rois, roi_valid)), has_aux=True)(p)
        return jax.lax.pmean(grads, "data"), jax.lax.pmean({"total_loss": total, **losses}, "data")

    fn = jax.jit(shard_map(per_replica, mesh=jax_make_mesh(WORLD), in_specs=(P(), P("data"), P("data"), P("data")),
                           out_specs=(P(), P()), check_vma=False))
    grads, losses = fn(params, jbatch, jnp.asarray(x["rois"]), jnp.asarray(x["roi_valid"]))
    return from_jax_params(jax.tree.map(np.asarray, grads)), {k: float(v) for k, v in losses.items()}


def test_halves_have_different_positive_counts():
    """The gradient test's batch: the all-reduced positive count differs
    from each rank's own."""
    x = make_inputs()
    cn = get_config("finetune_vovnet").centernet
    tg = render_targets(torch.from_numpy(x["gt"]), torch.from_numpy(x["valid"]), CANVAS, STRIDES,
                        cn.sizes_of_interest, hm_min_overlap=cn.hm_min_overlap, min_radius=cn.min_radius)
    counts = tg.pos_mask.sum(-1).tolist()
    assert counts[0] != counts[1] and min(counts) > 0, counts


def test_dp_gradients_match_jax_shard_map(run, jax_dp_grads):
    jgrads, jlosses = jax_dp_grads
    r0, r1 = run["ranks"]
    assert r0["grad_digest"] == r1["grad_digest"]
    assert set(r0["losses"]) == set(jlosses)
    for k, ref in jlosses.items():
        np.testing.assert_allclose(r0["losses"][k], ref, rtol=LOSS_RTOL, err_msg=k)
    assert len(r0["grads"]) > 60  # every trainable tensor
    for name, got in r0["grads"].items():
        ref = jgrads[name].numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        assert err <= GRAD_TOL * scale, f"{name}: max err {err:.3e}, largest |grad| {scale:.3e}"


def test_two_ranks_follow_one_process(run):
    r0, r1 = run["ranks"]
    for i, (m1, m0, mr1) in enumerate(zip(run["traj"], r0["traj"], r1["traj"])):
        assert m0 == mr1, f"step {i}: the ranks' metrics differ"
        assert m1.keys() == m0.keys()
        for k in m1:
            np.testing.assert_allclose(m0[k], m1[k], rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=f"step {i} {k}")
    assert r0["digests"] == r1["digests"]  # the replicas equal bit for bit after every step
    assert len(set(r0["digests"])) == len(TRAJECTORY_SEEDS)
    moved = 0
    for k, ref in run["params"].items():
        np.testing.assert_allclose(r0["params"][k], ref, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
        moved += int(not np.array_equal(ref, run["sd"][k].numpy()))
    assert moved > 40


def test_pinned_step_equals_the_eager_step(run):
    """build_pinned_dp_train_step against build_dp_train_step from the same
    state over the same batches on both ranks: dropout off over the
    trajectory, on over two batches (it changes the losses), every metric
    and the weights after every step bit for bit, the generators equal, the
    replicas equal."""
    r0, r1 = run["ranks"]
    for r in (r0, r1):
        assert r["pinned_traj"] == r["traj"]
        assert r["pinned_digests"] == r["digests"]
        assert r["dropout"]["pinned"] == r["dropout"]["eager"]
        assert r["dropout"]["eager"][0][0] != r["traj"][0]
    assert r0["pinned_digests"] == r1["pinned_digests"]
    assert r0["dropout"]["pinned"][1:] == r1["dropout"]["pinned"][1:]


def test_pinned_body_is_capture_safe(run):
    """The step body a CUDA graph holds on the card, with its collectives,
    has no host sync, no data-sized op and no host copy on either rank."""
    assert [r["refused"] for r in run["ranks"]] == [[], []]


def test_pinned_step_refuses_gloo_on_the_card(run):
    for r in run["ranks"]:
        assert "needs NCCL" in r["gloo_refusal"] and "'gloo'" in r["gloo_refusal"], r["gloo_refusal"]


def test_checkpoints_cross_topologies(run):
    """A checkpoint of the ranks resumes in one process with their weights;
    the one process's resumes in the ranks; both continue alike on the same
    batch."""
    cfg, r0, r1 = run["cfg"], *run["ranks"]
    state = checkpoint.resume_or_load(run["job"]["dp_dir"], build_train_state(cfg, run["sd"], device="cpu", seed=99))
    assert state.step == len(TRAJECTORY_SEEDS)
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), r0["params"][k], err_msg=k)
    m = _metrics(build_train_step(cfg, deterministic=True)(state, port_batch(make_inputs(seed=CONTINUE_SEED))))
    assert r0["resumed_step"] == r1["resumed_step"] == len(TRAJECTORY_SEEDS)
    assert r0["continued"] == r1["continued"]
    for k, v in m.items():
        np.testing.assert_allclose(r0["continued"][k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)


def test_batchnorm_statistics_are_averaged(run):
    """finetune_dla's running statistics after a step of two ranks: on both
    ranks the mean of what each rank's rows alone give (the same forward, so
    bit for bit), and those differ."""
    r0, r1 = run["ranks"]
    assert len(r0["bn_dp"]) > 50
    differ = 0
    for k, got in r0["bn_dp"].items():
        np.testing.assert_array_equal(r1["bn_dp"][k], got, err_msg=k)
        np.testing.assert_array_equal(got, (r0["bn_alone"][k] + r1["bn_alone"][k]) / 2, err_msg=k)
        differ += int(not np.allclose(r0["bn_alone"][k], r1["bn_alone"][k]))
    assert differ > 50  # the mean is neither rank's own


def test_world_one_equals_build_train_step():
    """Outside a process group the DP step is build_train_step, bit for bit,
    dropout and ROI sampling on."""
    cfg = small(get_config("finetune_vovnet"))
    sd = init_params(cfg, seed=1)
    a, b = build_train_state(cfg, sd, device="cpu"), build_train_state(cfg, sd, device="cpu")
    step_a, step_b = build_train_step(cfg), build_dp_train_step(cfg)
    for seed in (1, 2):
        batch = port_batch(make_inputs(seed=seed))
        ma, mb = step_a(a, batch), step_b(b, batch)
        assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state()) and a.step == b.step == 2


def test_pinned_world_one_equals_build_train_step():
    """Outside a process group the pinned DP step (eager steps on the CPU)
    is build_train_step, bit for bit, dropout and ROI sampling on."""
    cfg = small(get_config("finetune_vovnet"))
    sd = init_params(cfg, seed=1)
    a, b = build_train_state(cfg, sd, device="cpu"), build_train_state(cfg, sd, device="cpu")
    step_a, step_b = build_train_step(cfg), build_pinned_dp_train_step(cfg)
    for seed in (1, 2):
        batch = port_batch(make_inputs(seed=seed))
        ma, mb = step_a(a, batch), step_b(b, batch)
        assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state()) and a.step == b.step == 2
    assert not step_b.graphs and step_b.kernel_launches() == {"cgm": 0, "nms": 0, "roi": 0}


def test_make_mesh(monkeypatch):
    assert make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    assert make_mesh(0, device="cpu").size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="Refusing to silently truncate"):
        make_mesh(3)
    with pytest.raises(ValueError, match="num_devices=-1"):
        make_mesh(-1, device="cpu")


def test_shard_batch_and_dropout_seeds():
    batch = port_batch(make_inputs(seed=3, b=2))
    halves = [shard_batch(batch, r, 2) for r in range(2)]
    for i, name in enumerate(batch._fields):
        assert torch.equal(torch.cat([h[i] for h in halves]), batch[i]), name
        assert halves[0][i].shape[0] == 1, name
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        shard_batch(batch, 0, 3)
    seeds = {dropout_seed(0, rank, step) for rank in range(4) for step in range(4)}
    assert len(seeds) == 16 and dropout_seed(0, 1, 2) == dropout_seed(0, 1, 2)


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "per_image"])
def test_centernet_losses_reg_norm_matches_jax(targets_pair, scalar):  # noqa: F811
    """centernet_losses with reg_norm (a cross-replica count) against the
    JAX package's, image by image."""
    gtb, valid, tg, refs = targets_pair
    g = np.random.default_rng(9)
    cfg = get_config().centernet
    shapes = [(CANVAS[0] // s, CANVAS[1] // s) for s in STRIDES]
    hms = [(2 * g.standard_normal((2, 1, h, w)) - 2).astype(np.float32) for h, w in shapes]
    regs = [g.uniform(0, 6, (2, 4, h, w)).astype(np.float32) for h, w in shapes]
    hw = np.asarray([[90.0, 120.0], [64.0, 100.0]], np.float32)
    cval = centernet._level_valid_mask(CANVAS, STRIDES, t(hw))
    norms = np.asarray([37.5, 37.5] if scalar else [21.0, 44.0], np.float32)
    got = centernet.centernet_losses([t(h) for h in hms], [t(r) for r in regs], tg, cfg, cval,
                                     num_pos_avg=torch.tensor(3.5),
                                     reg_norm=torch.tensor(norms[0]) if scalar else t(norms))
    default = centernet.centernet_losses([t(h) for h in hms], [t(r) for r in regs], tg, cfg, cval,
                                         num_pos_avg=torch.tensor(3.5))
    assert not torch.allclose(got["loss_centernet_loc"], default["loss_centernet_loc"])
    for i in range(2):
        jcval = jcn._level_valid_mask(CANVAS, STRIDES, jnp.asarray(hw[i]))
        ref = jcn.centernet_losses([jnp.asarray(h[i].transpose(1, 2, 0)) for h in hms],
                                   [jnp.asarray(r[i].transpose(1, 2, 0)) for r in regs], refs[i],
                                   jax_get_config().centernet, jcval, num_pos_avg=jnp.asarray(3.5),
                                   reg_norm=jnp.asarray(norms[i]))
        for k, v in ref.items():
            close(got[k][i], v, rtol=1e-5, atol=1e-6)
