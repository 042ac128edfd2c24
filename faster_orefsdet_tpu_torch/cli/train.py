"""Fine-tuning and evaluation from the command line (counterpart of
``faster_orefsdet_tpu/cli/train.py``).

Usage:
  python -m faster_orefsdet_tpu_torch.cli.train \\
      --config finetune_vovnet \\
      --train-json datasets/coco/annotations/instances_train2017.json \\
      --train-images datasets/coco/train2017 \\
      --support-index datasets/coco/support_index.json \\
      [--eval-only --test-json ... --test-images ...] [--eval-period N] \\
      [--resume] [--init-npz model_final.npz] [--max-iter N] \\
      [--output-dir DIR] [--device cuda|cpu] [fs.support_shot=25 ...]

Builds the config (plus key=value overrides), then either evaluates the
weights on the test set or trains with periodic checkpoints under
``<output_dir>/checkpoints``, metrics in ``<output_dir>/metrics.jsonl`` and
the final weights as ``<output_dir>/model_final.npz`` (the JAX package's
format, so either package reads it). --init-npz reads such a file, the JAX
package's included. Runs on the card unless --device cpu; images are read
with cv2.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="finetune_vovnet")
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
    from ..pipelines.train_step import build_train_state, build_train_step
    from ..utils.checkpoint import load_params_npz, resume_or_load, save_checkpoint, save_params_npz
    from ..utils.events import EventLogger, drain_device_metrics
    from ..utils.params import init_params

    cfg = apply_overrides(get_config(args.config), args.opts)
    if args.output_dir:
        cfg = cfg.replace(output_dir=args.output_dir)
    os.makedirs(cfg.output_dir, exist_ok=True)
    params = load_params_npz(args.init_npz) if args.init_npz else init_params(cfg, seed=cfg.seed)
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
    step_fn = build_train_step(cfg)

    eval_period = args.eval_period if args.eval_period is not None else cfg.eval_period
    eval_records = None
    if eval_period > 0:
        if not args.test_json:
            raise SystemExit("--eval-period needs --test-json/--test-images")
        eval_records = load_coco_json(args.test_json, args.test_images)

    logger = EventLogger(cfg.output_dir)
    max_iter = args.max_iter or cfg.solver.max_iter

    def crossed(period, it1):
        return period > 0 and (it1 % period == 0 or it1 == max_iter)

    loader = train_loader(records, mapper, cfg.solver.ims_per_batch, seed=cfg.seed, device=args.device)
    pending = []  # (step, device metrics): read back once per logging window
    try:
        for it in range(state.step, max_iter):
            pending.append((it, step_fn(state, next(loader))))
            it1 = it + 1
            if eval_records is not None and crossed(eval_period, it1):
                # before the flush, so that at max_iter the results join the last row
                t_eval = time.perf_counter()
                results = run_eval(state.model.state_dict(), eval_records)
                print(f"eval @{it1}: " + str({k: round(v, 3) for k, v in results.items()}))
                logger.log(it1, {f"eval/{k}": v for k, v in results.items()}, count=0)
                logger.exclude_wall(time.perf_counter() - t_eval)
            if len(pending) >= logger.period or it1 == max_iter:
                for s, m in drain_device_metrics(pending):
                    logger.log(s, m)
                logger.flush(it1)
                pending = []
            if crossed(cfg.solver.checkpoint_period, it1):
                save_checkpoint(ckpt_dir, state)
    finally:
        loader.close()
    logger.flush(max_iter)
    save_params_npz(os.path.join(cfg.output_dir, "model_final.npz"), state.model.state_dict())
    print(f"training done: {max_iter} iters; params saved to {cfg.output_dir}/model_final.npz")


if __name__ == "__main__":
    main()
