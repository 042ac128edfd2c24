"""Fine-tuning and evaluation from the command line (counterpart of
``faster_orefsdet_tpu/cli/train.py``).

Usage:
  python -m faster_orefsdet_tpu_torch.cli.train \\
      --config finetune_vovnet | --config-file configs/fsod/finetune_dla.yaml \\
      --train-json datasets/coco/annotations/instances_train2017.json \\
      --train-images datasets/coco/train2017 \\
      --support-index datasets/coco/support_index.json \\
      [--eval-only --test-json ... --test-images ...] [--eval-period N] \\
      [--resume] [--init-npz model_final.npz] [--max-iter N] \\
      [--steps-per-dispatch K] [--num-devices N] [--output-dir DIR] \\
      [--device cuda|cpu] [fs.support_shot=25 ...]

Builds the config (a named preset, or a detectron2-style yaml with its
_BASE_ chain; plus key=value overrides), then either evaluates the weights
on the test set or trains with periodic checkpoints under
``<output_dir>/checkpoints``, metrics in ``<output_dir>/metrics.jsonl`` and
the final weights as ``<output_dir>/model_final.npz`` (the JAX package's
format, so either package reads it), with a trainable-BatchNorm model's
running statistics in ``batch_stats.npz`` beside it. --init-npz reads such
files, the JAX package's included. Runs on the card unless --device cpu;
images are read with cv2.

Every step goes through the K-step train function: on the card, after two
eager warm-up steps per batch shape, each step is a replay of one CUDA
graph of the whole step (the same updates as single eager steps), whatever
K is. --steps-per-dispatch K sets the chunk of steps taken per call: metrics
are logged as per-chunk means, and evaluation and checkpoints fire at the
first chunk end that crosses their period (period 1000 and K 8 save at
1004): pick K dividing the periods for the exact cadence.

--num-devices N > 1 trains data-parallel (``parallel.train_dp``, the
reference's DDP launch): N processes, rank r on cuda:r over NCCL (or N
ranks on the CPU over gloo with --device cpu), each taking its
ims_per_batch / N rows of every batch of the same seeded loader; one step
per batch (no --steps-per-dispatch), on the cards after two eager warm-up
steps a replay of one CUDA graph of the whole step, NCCL's all-reduces
captured in it (``parallel.train_dp.build_pinned_dp_train_step``), on the
CPU an eager step; rank 0 logs, evaluates and checkpoints. Checkpoints
move between a data-parallel run and a single-card one both ways. With
--eval-only, N > 1 evaluates in one process over N cards
(``parallel.eval_dp.evaluate_sharded``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="finetune_vovnet")
    p.add_argument("--config-file", help="detectron2-style yaml with _BASE_ inheritance (configs/fsod/*.yaml); "
                                          "overrides --config")
    p.add_argument("--train-json")
    p.add_argument("--train-images")
    p.add_argument("--test-json")
    p.add_argument("--test-images")
    p.add_argument("--support-index", help="support crop index json (data.coco.save_support_index)")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true", help="continue from the newest checkpoint of the output dir")
    p.add_argument("--init-npz", help="initial weights: a params .npz of either package")
    p.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel ranks, one process each (0 = every visible card; 1 with --device cpu)")
    p.add_argument("--eval-batch", type=int, default=8, help="eval images per request")
    p.add_argument("--max-iter", type=int, default=0, help="override solver.max_iter")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K train steps per call: the logging, eval and checkpoint chunk")
    p.add_argument("--eval-period", type=int, default=None,
                   help="evaluate on --test-json every N iterations and at the end (default: the config's "
                        "eval_period; 0 = off)")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs="*", help="config overrides key=value")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace):
    """The run's config: the named preset or the yaml, the key=value
    overrides and --output-dir (created)."""
    from ..config import apply_overrides, get_config

    if args.config_file:
        from ..config_yaml import load_yaml_config

        cfg = load_yaml_config(args.config_file)
    else:
        cfg = get_config(args.config)
    cfg = apply_overrides(cfg, args.opts)
    if args.output_dir:
        cfg = cfg.replace(output_dir=args.output_dir)
    os.makedirs(cfg.output_dir, exist_ok=True)
    return cfg


def initial_params(args: argparse.Namespace, cfg):
    """--init-npz's weights, or seeded random ones."""
    from ..models.detector import CenterNet2Detector
    from ..utils.checkpoint import load_params_npz
    from ..utils.params import init_params, is_batch_stat

    if not args.init_npz:
        return init_params(cfg, seed=cfg.seed)
    # running statistics from batch_stats.npz beside the file; without one
    # they keep their initial values, as the JAX package's CLI does
    initial = {k: v for k, v in CenterNet2Detector(cfg).state_dict().items() if is_batch_stat(k)}
    return {**initial, **load_params_npz(args.init_npz, batch_stats=bool(initial))}


def num_devices(args: argparse.Namespace) -> int:
    """--num-devices, where 0 means every visible card (one on the CPU)."""
    import torch

    if args.num_devices:
        return args.num_devices
    return 1 if torch.device(args.device).type == "cpu" else max(torch.cuda.device_count(), 1)


def main(argv: Optional[Sequence[str]] = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    cfg = build_config(args)
    n_dev = num_devices(args)

    if args.eval_only:
        from ..data.coco import load_coco_json, load_support_index
        from ..pipelines.evaluate import encode_support_set, evaluate

        params = initial_params(args, cfg)
        records = load_coco_json(args.test_json, args.test_images)
        entries = load_support_index(args.support_index) if args.support_index else []
        cache = encode_support_set(cfg, params, entries, device=args.device)
        if n_dev > 1:
            from ..parallel import make_mesh
            from ..parallel.eval_dp import evaluate_sharded

            results = evaluate_sharded(cfg, params, cache, records, make_mesh(n_dev, args.device))
        else:
            results = evaluate(cfg, params, cache, records, batch_size=max(1, args.eval_batch), device=args.device)
        print({k: round(v, 3) for k, v in results.items()})
        return results

    if n_dev == 1:
        return train(args, cfg, args.device)
    # data parallel: one process per rank (the reference's NCCL launch)
    if cfg.solver.ims_per_batch % n_dev:
        raise SystemExit(f"ims_per_batch {cfg.solver.ims_per_batch} must divide over {n_dev} devices")
    if args.steps_per_dispatch > 1:
        raise SystemExit("--steps-per-dispatch composes with single-device only")
    from ..parallel.mesh import make_mesh, spawn_ranks

    make_mesh(n_dev, args.device)  # refuses more cards than are visible
    store = tempfile.mkdtemp(prefix="dist_store_", dir=cfg.output_dir)
    try:
        spawn_ranks(_train_rank, n_dev, (argv,), init_method=f"file://{os.path.join(store, 'store')}",
                    device=args.device)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _train_rank(rank: int, world: int, device, argv: Sequence[str]) -> None:
    """One rank of a data-parallel run (``main`` spawns them)."""
    args = parse_args(argv)
    train(args, build_config(args), device, rank, world)


def train(args: argparse.Namespace, cfg, device, rank: int = 0, world: int = 1) -> None:
    """The training loop on `device`: the whole run at world 1, else rank
    `rank` of a process group of `world`. Every rank runs the same seeded
    loader and takes its rows of each batch; rank 0 alone logs, evaluates,
    checkpoints and writes the final weights."""
    from ..data.coco import load_coco_json, load_support_index, split_per_class
    from ..data.loader import train_canvas, train_loader
    from ..data.mapper import EpisodicMapper, SupportSampler
    from ..pipelines.evaluate import encode_support_set, evaluate
    from ..pipelines.train_step import build_train_state, build_train_step_scan, run_scan_chunk
    from ..utils.checkpoint import resume_or_load, save_checkpoint, save_params_npz
    from ..utils.events import EventLogger, drain_device_metrics

    lead = rank == 0
    support_entries = load_support_index(args.support_index) if args.support_index else []
    records = split_per_class(load_coco_json(args.train_json, args.train_images))
    mapper = EpisodicMapper(cfg, SupportSampler(support_entries), canvas_hw=train_canvas(records, cfg))
    state = build_train_state(cfg, initial_params(args, cfg), device=device)
    ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
    if args.resume:
        resume_or_load(ckpt_dir, state)
    k = max(1, args.steps_per_dispatch)
    if world > 1:
        from ..parallel import replicate_state, shard_batch
        from ..parallel.train_dp import build_pinned_dp_train_step

        replicate_state(state)  # after the resume: every rank continues from rank 0's state
        dp_step = build_pinned_dp_train_step(cfg)  # graph replays on the cards, eager steps on the CPU

        def take(kk):
            return dp_step(state, shard_batch(next(loader), rank, world))
    else:
        step_k = build_train_step_scan(cfg)

        def take(kk):  # a chunk of kk steps, logged as its mean
            return {name: v.mean() for name, v in run_scan_chunk(step_k, state, loader, kk).items()}

    eval_period = args.eval_period if args.eval_period is not None else cfg.eval_period
    eval_records = None
    if eval_period > 0:
        if not args.test_json:
            raise SystemExit("--eval-period needs --test-json/--test-images")
        eval_records = load_coco_json(args.test_json, args.test_images)

    def run_eval(weights):
        cache = encode_support_set(cfg, weights, support_entries, device=device)
        return evaluate(cfg, weights, cache, eval_records, batch_size=max(1, args.eval_batch), device=device)

    logger = EventLogger(cfg.output_dir) if lead else None
    max_iter = args.max_iter or cfg.solver.max_iter

    def crossed(period, it0, it1):
        """Whether the steps it0 < step <= it1 reach a multiple of period, or the end."""
        return period > 0 and (it1 // period > it0 // period or it1 == max_iter)

    loader = train_loader(records, mapper, cfg.solver.ims_per_batch, seed=cfg.seed, device=device)
    pending = []  # (last step, device metrics, steps): read back once per logging window
    it = state.step
    try:
        while it < max_iter:
            kk = min(k, max_iter - it)
            metrics = take(kk)
            it1 = it + kk
            if lead:
                pending.append((it1 - 1, metrics, kk))
                if eval_records is not None and crossed(eval_period, it, it1):
                    # before the flush, so that at max_iter the results join the last row
                    t_eval = time.perf_counter()
                    results = run_eval(state.model.state_dict())
                    print(f"eval @{it1}: " + str({name: round(v, 3) for name, v in results.items()}))
                    logger.log(it1, {f"eval/{name}": v for name, v in results.items()}, count=0)
                    logger.exclude_wall(time.perf_counter() - t_eval)
                if sum(c for _, _, c in pending) >= logger.period or it1 == max_iter:
                    drained = drain_device_metrics([(s, m) for s, m, _ in pending])
                    for (s, m), (_, _, c) in zip(drained, pending):
                        logger.log(s, m, count=c)
                    # an explicit flush: chunk ends can miss every multiple of the period
                    logger.flush(it1)
                    pending = []
                if crossed(cfg.solver.checkpoint_period, it, it1):
                    save_checkpoint(ckpt_dir, state)
            it = it1
    finally:
        loader.close()
    if not lead:
        return
    logger.flush(max_iter)
    # the running statistics, if any, go to batch_stats.npz beside it
    save_params_npz(os.path.join(cfg.output_dir, "model_final.npz"), state.model.state_dict())
    print(f"training done: {max_iter} iters; params saved to {cfg.output_dir}/model_final.npz")


if __name__ == "__main__":
    main()
