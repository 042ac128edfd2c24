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
      [--steps-per-dispatch K] [--output-dir DIR] [--device cuda|cpu] \\
      [fs.support_shot=25 ...]

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
"""

from __future__ import annotations

import argparse
import os
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


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)

    from ..config import apply_overrides, get_config
    from ..data.coco import load_coco_json, load_support_index, split_per_class
    from ..data.loader import train_canvas, train_loader
    from ..data.mapper import EpisodicMapper, SupportSampler
    from ..pipelines.evaluate import encode_support_set, evaluate
    from ..models.detector import CenterNet2Detector
    from ..pipelines.train_step import build_train_state, build_train_step_scan, run_scan_chunk
    from ..utils.checkpoint import load_params_npz, resume_or_load, save_checkpoint, save_params_npz
    from ..utils.events import EventLogger, drain_device_metrics
    from ..utils.params import init_params, is_batch_stat

    if args.config_file:
        from ..config_yaml import load_yaml_config

        cfg = load_yaml_config(args.config_file)
    else:
        cfg = get_config(args.config)
    cfg = apply_overrides(cfg, args.opts)
    if args.output_dir:
        cfg = cfg.replace(output_dir=args.output_dir)
    os.makedirs(cfg.output_dir, exist_ok=True)
    if args.init_npz:
        # running statistics from batch_stats.npz beside the file; without
        # one they keep their initial values, as the JAX package's CLI does
        initial = {k: v for k, v in CenterNet2Detector(cfg).state_dict().items() if is_batch_stat(k)}
        params = {**initial, **load_params_npz(args.init_npz, batch_stats=bool(initial))}
    else:
        params = init_params(cfg, seed=cfg.seed)
    support_entries = load_support_index(args.support_index) if args.support_index else []

    def run_eval(weights, records):
        cache = encode_support_set(cfg, weights, support_entries, device=args.device)
        return evaluate(cfg, weights, cache, records, batch_size=max(1, args.eval_batch), device=args.device)

    if args.eval_only:
        results = run_eval(params, load_coco_json(args.test_json, args.test_images))
        print({k: round(v, 3) for k, v in results.items()})
        return results

    # ---- training
    records = split_per_class(load_coco_json(args.train_json, args.train_images))
    mapper = EpisodicMapper(cfg, SupportSampler(support_entries), canvas_hw=train_canvas(records, cfg))
    state = build_train_state(cfg, params, device=args.device)
    ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
    if args.resume:
        resume_or_load(ckpt_dir, state)
    k = max(1, args.steps_per_dispatch)
    step_k = build_train_step_scan(cfg)

    eval_period = args.eval_period if args.eval_period is not None else cfg.eval_period
    eval_records = None
    if eval_period > 0:
        if not args.test_json:
            raise SystemExit("--eval-period needs --test-json/--test-images")
        eval_records = load_coco_json(args.test_json, args.test_images)

    logger = EventLogger(cfg.output_dir)
    max_iter = args.max_iter or cfg.solver.max_iter

    def crossed(period, it0, it1):
        """Whether the steps it0 < step <= it1 reach a multiple of period, or the end."""
        return period > 0 and (it1 // period > it0 // period or it1 == max_iter)

    loader = train_loader(records, mapper, cfg.solver.ims_per_batch, seed=cfg.seed, device=args.device)
    pending = []  # (last step, device metrics, steps): read back once per logging window
    it = state.step
    try:
        while it < max_iter:
            kk = min(k, max_iter - it)
            # a chunk of kk steps, logged as its mean
            metrics = {name: v.mean() for name, v in run_scan_chunk(step_k, state, loader, kk).items()}
            it1 = it + kk
            pending.append((it1 - 1, metrics, kk))
            if eval_records is not None and crossed(eval_period, it, it1):
                # before the flush, so that at max_iter the results join the last row
                t_eval = time.perf_counter()
                results = run_eval(state.model.state_dict(), eval_records)
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
    logger.flush(max_iter)
    # the running statistics, if any, go to batch_stats.npz beside it
    save_params_npz(os.path.join(cfg.output_dir, "model_final.npz"), state.model.state_dict())
    print(f"training done: {max_iter} iters; params saved to {cfg.output_dir}/model_final.npz")


if __name__ == "__main__":
    main()
