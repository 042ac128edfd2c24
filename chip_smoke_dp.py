#!/usr/bin/env python3
"""Phase 18 of chip_smoke.py (data parallel) alone, with the set-up it
needs, for a quick check on a machine with several cards:

    python3 chip_smoke_dp.py [--kernels]

It prints the card's name and power limit, builds the kernels, runs
phase 3 (each kernel against its plain twin) on every visible card with
--kernels, makes phase 4's 25-shot serving_vovnet cache, then runs phase
18 over min(cards, 4) cards: sharded serving and eval; training with the
pinned data-parallel step at world 1 on cuda:0 against
build_train_step_scan (and that step's time, the yardstick), two gloo
ranks on cuda:0 (the pinned step refused, the eager one run) and, with two
cards or more, one NCCL rank a card, each replaying one CUDA graph of the
step with NCCL's all-reduces captured, held against the eager ranks and
one process, its step ms with the batches on the card and with the
loader's pulls inside. Each result is a JSON line; any failed check exits
non-zero. The whole run is `python3 chip_smoke.py`.
"""

import argparse
import os
import subprocess
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kernels", action="store_true", help="also run phase 3 on every visible card")
    args = p.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_dp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from faster_orefsdet_tpu_torch.config import serving_vovnet
    from faster_orefsdet_tpu_torch.ops import _native, cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.ops.nms import batched_nms_mask, nms_mask
    from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache
    from faster_orefsdet_tpu_torch.utils.params import init_params

    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, torch.cuda.device_count(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _native.build()
    cs.emit(build_s=time.time() - t0)
    if args.kernels:
        for dev in range(torch.cuda.device_count()):
            with torch.cuda.device(dev):
                cs.phase_kernels(torch, np, cgm_cuda, nms_cuda, nms_mask, batched_nms_mask)
            cs.emit(kernels_on=dev, s=time.time() - t0)
    cfg = serving_vovnet()
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    sup_imgs, sup_boxes = cs.support_inputs(torch, np, cfg, 25, rng)
    cache = build_support_cache(cfg, params, sup_imgs, sup_boxes)
    frames = rng.integers(0, 256, (8, 3, *cs.FRAME_HW), dtype=np.uint8)
    launches = cs.phase_dp(torch, np, cfg, params, cache, torch.from_numpy(frames), smi)
    cs.emit(dp_launches=launches, total_s=time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
