#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (faster_orefsdet_tpu_torch) on one card.

    python3 chip_smoke.py [--ab-baseline DIR]

Phases, each of which stops the run with a non-zero exit when it fails:

1. card: prints `nvidia-smi --query-gpu=name,power.limit` and turns TF32 off
   for the comparison phases;
2. build: compiles the CUDA kernels of faster_orefsdet_tpu_torch/csrc with nvcc;
3. kernels: the CGM kernel against its plain twin at the p3/p4/p5 shapes of a
   320x448 canvas (batch 1 and 8) and at ragged tile edges (1x1, 3x5, 7x33 at
   batch 3), and at 64, 160 and 256 channels at the three levels (batch 1
   and 8), with the taps of 3 and 9 classes (a class axis) at 64, 128, 160
   and 256 channels at batch 1's levels, and at 1, 100, 130, 390 and 520
   channels at 7x33 (batch 3; one and two classes), bf16 and f32 q: its
   f32 result within |err| <= CGM_ATOL + CGM_RTOL*|ref| and within phase
   19's dot-product bound of the f64 result, its result in q's dtype that f32
   result rounded once, bit for bit. The NMS kernel against the plain fixpoint, bit for bit, at K in
   {1, 63, 64, 65, 256, 512, 1000, 1024, 1792, 2048, 2049, 2304, 4096, 8192}
   on batches of 10 scenes (random, dense chains, score ties, invalid
   padding, ascending scores, all scores equal), at K in {256, 1024} on each
   scene alone (batch 1), at K = 16384 on one scene (past K = 2304 against
   the plain fixpoint on the card only: the CPU's takes too long), and the
   class-aware NMS at the multiclass sites' K = 768 and 2304 (3 and 9
   classes of 256, class-offset boxes) against its plain version;
4. main path: seeded init_params under serving_vovnet (bf16), a 25-shot support
   cache from 256x256 crops (the build's ms, the first and 3 more: it stays
   eager, one call a cache), then 3 batch-1 requests (build_inference_fn) and
   2 batch-8 uint8 requests (build_batched_inference_fn) on 320x448 canvases
   with image_hw (320, 427). Every image must give finite packed [100, 7]
   detections, and both kernels' launch counters must have advanced by the
   expected count;
5. card vs CPU: the same weights and inputs in f32 through the port on the card
   and on the CPU (plain twins), the support caches compared and the
   detections greedy-matched (>= 85% at IoU >= 0.95, |dscore| <= 1e-3, the
   top 10 of each side matched: "phase 5's criteria" below);
6. raw frames: preprocess_device on 8 uint8 480x640 frames, card vs CPU
   within 2e-3 on the 0-255 scale; build_serving_fn on them: the 320x448
   canvas, finite packed detections inside the frame, 3 + 2 launches;
7. pinned: build_pinned_inference_fn (CUDA-graph replay) on phase 4's
   batch-1 f32 and batch-8 uint8 inputs against the eager builders, by
   phase 5's criteria with |dscore| <= 1e-5 (the count of bit-identical
   values printed); two held results must not alias. The wrappers' counters
   advance at capture, so this path's launches are each graph's captured
   launches times its replays;
8. multiclass: nine 25-shot caches stacked, build_multiclass_inference_fn at
   batch 1: 3 CGM launches (one a level, the nine classes' taps stacked)
   and 2 NMS launches (decode on [9, 1024], across classes on [1, 2304]);
   the CGM kernel within phase 19's bound and the NMS kernel bit for bit
   against the plain fixpoint on the inputs that request gave them at each
   site (and the class-aware call against its plain version); card vs CPU in f32 by phase
   5's criteria within each class; one class stacked against
   build_inference_fn;
9. async: 16 VGA frames through AsyncPredictor(depth=3), without and with 2
   readback workers, each result against that frame's own pinned call;
10. eval: `evaluate` on 16 synthetic frames (filled ellipses on noise, the
   ground truth their boxes) at batch 1 and 8, every AP value finite (the
   weights are random: the values check the loop, not the detector),
   through its pinned function: one graph captured (3 CGM and 2 NMS
   launches), every request a replay; its `fps` beside the eager builders'
   images/s on the same timing loop (`eager_fps`);
11. timing: each kernel at the main path's shapes, on the device only (50
   calls captured in a CUDA graph, the replay timed with CUDA events; L2
   warm) and as enqueued from the host (events around 50 calls), its plain
   twin (events), and K2 alone at the training decode's site ([1, 2048] at
   IoU 0.9, random scenes), K2 past 2048 ranks (the nine-class request's
   [1, 2304] on the inputs phase 8 recorded, [1, 4096] on random scenes),
   K2 at the fast presets' ROI site ([8, 64] at IoU 0.9, random scenes),
   K1 at 160 channels (f32 q, batch 1 and 8), K1 at the nine-class
   request's site on phase 8's inputs (one launch a level against nine, one
   a class) and K2 at [1, 16384] on a random scene; K3 (the ROIAlign gather)
   at the three serving shapes ("timing": "roi_align" lines: VoVNet [8, 256]
   x 8x8 x 128 bf16 over p3-p5, DLA [8, 256] x 7x7 x 160 f32, the baseline
   [8, 100] x 14x14 x 1024 f32; proposal-like boxes on NCHW maps), each
   result first held against the plain version run on the CPU (the card
   test's limits), its bound the output, the maps once and their copy to
   channel-last (read and write) at the memory rate; then end to end in bf16
   with the library's default TF32 settings: the eager and the pinned path
   at batch 1 and 8, and the nine-class request;
12. profile: the same batch-1 and batch-8 requests, eager and pinned, under
   torch.profiler: device busy time, idle share, launches, each of the
   port's own kernels' device time and launches, each stage's device span
   (eager only: a replay has no stages) and the top kernels; for the pinned
   path also one replay's device time by CUDA events, and the profiler's
   count of each own kernel per replay must equal the graph's captured
   launches (a profile that missed kernel records is taken again, three
   attempts at most);
   (Launch counts everywhere are K1's, K2's and K3's, `kernels(cgm, nms,
   roi)`: K3 once a request on every CenterNet2 and baseline serving path,
   twice a support-cache build; the training steps pool through the dense
   composition and count none);
13. train: finetune_vovnet at full width (f32, 24 shots at 256x256, 128
   ROIs) on 16 synthetic 480x640 frames made in memory, through the mapper
   and train_loader onto the 448x608 canvas: 3 + 20 train steps from
   init_params, every loss finite, 0 CGM and 1 NMS launch a step, the median
   step time (host clock, each step ending in a sync, after the 3), queries
   per second and peak memory; the NMS kernel bit for bit against the plain
   fixpoint on the [1, 2048] set that a step's decode gives it, and its
   device time there; one step card vs CPU (same weights, batch and ROIs,
   no dropout, TF32 off): each loss within 1e-3 relative, each gradient
   within 1e-3 of its tensor's largest |grad|; 30 steps on one batch at a
   constant LR of 1e-4 without warmup: the mean of the last 5 losses at
   most 0.75 x the first; a profile of the step as in phase 12;
14. train graphed: finetune_vovnet through build_train_step_scan (K steps
   per call, each a replay of one CUDA graph of the whole step after 2 eager
   warm-up steps): 9 steps (warm-up 2, then chunks of 4 and 3) from one seed
   against 9 eager steps on the same stored batches, dropout on: under
   cudnn.deterministic every loss, weight and momentum buffer bit for bit
   and the generator's state equal; under the library's defaults (cuDNN
   may sum with atomics) the worst loss and tensor difference at most 3x
   the largest between three eager runs; 0 CGM and 1 NMS launch a step (captured
   launches times replays); then 12 chunks of K = 4 fed by train_loader:
   the median step time with the batches pulled before the clock and with
   the pulls inside, beside phase 13's eager median, peak memory, a profile
   of a chunk (device busy, idle share, kernel events a step) and the
   loader's own batches per second;
15. finetune_dla: DLA-34 + BiFPN (160 channels, 4 repeats) with trainable
   BatchNorm, 9 shots, 7x7 pooler, at full width on phase 13's frames: 3 +
   10 eager steps (every loss finite, every running mean and variance moved
   and finite, 0 CGM and 1 NMS launch a step); the NMS kernel bit for bit on
   a step's own decode set; one step card vs CPU (no dropout, TF32 off),
   each loss, gradient and updated running statistic as its worst |diff|
   over its tensor's largest: in f64 within 1e-3, in f32 within 1e-3 or 3x
   the CPU's own f32 vs f64 where that is larger (a random DLA in batch
   statistics mode amplifies rounding, on any device);
   2 warm-up steps and a chunk of 4 against 6 eager steps bit for bit under
   cudnn.deterministic (running statistics included); `evaluate` on 8 synthetic frames with the
   trained state (finite AP, 2 NMS launches an image, the kernel bit for
   bit at the decode's [1, 1024] and the ROI's [1, 256] sites at IoU 0.9);
   the eager and graphed step times;
16. workflow: a seeded checkpoint in the reference's key layout written as
   a .pth, converted (load_torch_pth, convert_torch_checkpoint) and saved
   as the params npz (round trip equal); cli/build_support on a synthetic
   COCO set held in memory (12 VGA scenes); cli/demo under serving_vovnet
   at full width with --params on 8 VGA frames by image glob (3 CGM and 2
   NMS launches an image), on 16 frames as a video by --frame-batch 8
   (pinned raw-frame serving: one graph captured, then replays), by
   --parallel (against the glob run at |dscore| <= 1e-5) and with --debug
   on 2 frames (finite overlays from the same forward pass: 3 CGM and 2
   NMS launches an image); the glob and the video runs in f32 card
   vs CPU by phase 5's criteria; visualize_features on one frame in f32,
   every map finite and within 1e-3 of its largest card vs CPU; and
   finetune_dla with use_pallas_cgm (the CGM kernel at 160 channels) on 2
   frames: 3 CGM launches an image, card vs CPU by phase 5's criteria, and
   each K3 call's result against the plain version on its own inputs (the
   card test's limits);
17. quantized serving: serving_vovnet_int8, _int8_static and
   _int8_resident at full width (one float tree from init_params, each
   preset's own 25-shot cache), the static two calibrated on 8 synthetic
   VGA frames (the count of scales and the seconds printed). An eager
   batch-1 and batch-8 request, counted: 3 CGM and 2 NMS launches and 25
   int8 GEMMs a request, the NMS kernel bit for bit on each request's own
   decode and ROI ([B, 64]) inputs, and every distinct int8 conv of the
   batch-8 request with the card's int32 accumulator equal to the CPU's on
   the same int8 operands; the pinned function against eager at |dscore|
   <= 1e-5 (graphs of 3 CGM and 2 NMS launches); card vs CPU in f32 on
   phase 5's image with the card's cache: phase 5's criteria on the card's
   int8 grids, each weight's int8 grid equal, and the CPU on its own grids
   reported (float ops in the last bits can flip an int8 rounding); then
   request times (batch 1 and 8, eager and pinned), a profile of the pinned
   batch-8 request (device busy, idle share) and its int8 work piece by
   piece (GEMMs, im2col, the quantize and dequant passes, each a CUDA-graph
   replay on the request's own operands); serving_vovnet_fast in bf16 timed
   and profiled the same way as the yardstick;
18. data parallel over n = min(cards, 4) cards: make_mesh(cards + 1)
   refused; make_sharded_serving (a pinned replica a card) on phase 6's 8
   VGA frames (serving_vovnet): each card's share bit for bit against card
   0's pinned replay of the same frames (at n = 1 the whole batch; at n > 1
   the batch in f32 against one card's eager batch of 8 by phase 5's
   criteria is printed, not held: it measures the batch's effect on
   cuDNN); a graph of 3 CGM and 2 NMS launches a card, one replay each;
   images/s (host clock, each call ending in a sync) pinned at n cards and
   at one, at 8 frames a call and at 8 frames a card, and through eager
   replicas at n and at one (a line says so where one card is visible);
   evaluate_sharded on phase 10's 16 frames, 8 / n a card, against
   evaluate at batch 8 / n, both pinned (the same batches: the AP table
   equal; one graph a card, every request a replay); finetune_vovnet data-parallel
   training at full width (TF32 off, cuDNN deterministic, its default
   backward differing run to run, ROI sampling on), 8 steps a run: first
   build_pinned_dp_train_step at world 1 on this card (dropout on) against
   build_train_step_scan, every metric and weight bit for bit, 1 NMS launch
   a step, a checkpoint of step 4 resumed in place between replays and the
   later steps taken again bit for bit, then build_train_step_scan's step
   timed (the one-process graphed yardstick); two ranks on cuda:0 over
   gloo with a global batch of 2 (the pinned step refused there, the
   eager one run) and, with two cards or more, one NCCL rank a card with a
   global batch of n (else a line says why not), each rank a spawned
   process: eager and pinned runs without dropout, every metric within
   1e-3 of one process over the same global batches at each of the first
   4 steps (the worst over all 8 printed) and within 1e-3 at every step of
   one process whose convolutions and linear layers each run on one rank's
   rows at a time (a product over the global batch differs from one over a
   rank's rows in the last bits, which flips near-tied proposals in the
   ROI sample as the weights move apart; the two one-process runs against
   each other printed, the witness); the [B, K] of the NMS launch captured
   into each rank's graph and the world-1 graph recorded and printed; two
   eager runs and a pinned one with dropout, the pinned held bit for bit
   to the eager (or within 3x the two eager runs' difference where they
   differ), the pinned without dropout likewise; the ranks' weights bit for
   bit equal after every step of every run; 0 CGM and 1 NMS launch a step
   a rank (eager counted; pinned: warm-ups and captured x replays); each
   rank's eager step ms, graphed step ms with the batches on the card and
   with its loader's pulls inside, the loader's own batches/s, the ms of
   the all-reduce of a flat buffer the size of the step's, global images/s
   against the yardstick's;
19. the ResNet-50 family at full width, f32 weights (TF32 off for the
   comparisons, TF32 convs for the timings): finetune_R_50_C4_1x (ResNet-50
   + FPN, 9 shots, 4x4 pooler) served with use_pallas_cgm at 320x448, an
   eager batch-1 and batch-8 request counted (3 CGM and 2 NMS launches a
   request), each K1 call held against its plain twin and each K2 call bit
   for bit on the request's own inputs, the pinned function against eager
   at |dscore| <= 1e-5, card vs CPU by phase 5's criteria, request times
   eager and pinned; trained at 448x608 on phase 13's frames: 2 + 4 eager
   steps (0 CGM, 1 NMS launch a step, K2 bit for bit on a step's own
   [1, 2048] decode set), one step card vs CPU by phase 13's criteria,
   graphed (2 warm-up steps and a chunk of 2) against 4 eager steps bit for
   bit under cudnn.deterministic, eager and graphed step ms, queries/s,
   peak memory; mnv3_fpn (serving_vovnet with MobileNetV3-small) at batch 1,
   3 CGM and 2 NMS launches, card vs CPU by phase 5's criteria; the
   AttentionRPN baseline from Base-FSOD-C4.yaml: a 10-shot cache from 240
   crops on 256x256 canvases card vs CPU (rtol 1e-3, atol 2e-4), a request
   on a VGA frame resized to the yaml's test size (600x800 on a 608x800
   canvas) with 2 NMS launches (the RPN's [1, 1000] at IoU 0.7, the final
   class-aware [1, 100] at 0.5), each bit for bit on the request's own
   inputs, card vs CPU by phase 5's criteria, the request's ms; one training
   step (baseline_loss_fn + backward) card vs CPU with the same anchor draws
   (a CPU generator) and injected ROIs, each loss within 1e-3 relative and
   each gradient within 1e-3 of its tensor's largest, then 2 + 3 steps with
   sgd_update (1 NMS launch a step, K2 bit for bit on a step's own [1, 2000]
   set), step ms and peak memory. Each new K2 site is timed as phase 11
   times its rows ("timing": "nms" lines named by site);
20. the one-stage CenterNet over P3-P7 (finetune_vovnet with fpn.top_levels=2,
   strides 8-128, size_divisibility 128, f32, TF32 off) at full width on six
   synthetic VGA frames on 384x512 canvases, at 1 and 9 classes: one NMS
   launch a request (the class-aware NMS over [1, 2020] and [1, 3540], the
   register and the wide sweep), each call bit for bit on the request's own
   inputs, card vs CPU per frame by phase 5's criteria within each class,
   K2's rows timed as phase 11 times its rows, request ms at batch 1 in bf16
   and f32; a 320x448 canvas refused at P7; the six other VoVNet specs, V-19-eSE
   with FPN P3-P7, Res2Net-50, RegNetX-400MF and RegNetY-400MF at 384x512,
   DLASeg-34 at 512x512 (random offsets and masks), CoT and CBAM at 128
   channels on a P3 map, each card vs CPU within 1e-4 of its largest
   output (or 3x the CPU's own f32 vs f64, printed beside it), eager ms and
   peak memory; the federated loss card vs CPU; a torch.profiler trace,
   the flops of a one-stage request, measure_model(serving_vovnet),
   device_memory; the C++ COCO matcher built with g++ on the machine, and
   coco_ap with it equal to the numpy twin's on phase 10's eval set;
21. pinned entry points, the counterparts of the JAX package's jitted
   serving builders, against their eager builders under the library's
   defaults: build_pinned_serving_fn on phase 6's 8 VGA frames at batch 1
   and 8, build_pinned_multiclass_inference_fn on phase 8's nine-class
   request, build_pinned_onestage_inference_fn at 1 and 9 classes in f32
   and bf16 on two of phase 20's 384x512 canvases, and
   build_pinned_baseline_inference_fn on phase 19's 608x800 canvas: each
   by phase 5's criteria at |dscore| <= 1e-5; each graph's captured K1, K2
   and K3 launches equal to an eager request's (3, 2 and 1 on the raw-frame
   and nine-class paths, 0, 1 and 0 one-stage, 0, 2 and 1 the baseline),
   and no pooler call routed to the dense composition; K2 bit for bit, K1
   within phase 19's bound and K3 against its plain version run on the CPU
   (the card test's limits) on the eager requests' own inputs; request ms
   at the median, eager and pinned, a line each (`"pinned_entry_ms"`).

With --ab-baseline DIR, after phase 21 an "ab" line per kernel row against
an earlier build's cgm.cu and nms.cu in DIR, timed in turns (earlier, this,
this, earlier) on the same inputs with the outputs compared: K1 at 160 and
128 channels, batch 1 and 8; K2 on the inputs the nine-class request ([1,
2304], phase 8) and the one-stage nine-class request ([1, 3540], phase 20)
gave it, at [1, 3540], [1, 4096] and [1, 16384] random, and at [8, 1024],
[8, 256] and [1, 2048].

Each result is one JSON line. The line before the last holds the kernels'
table (with each kernel's graph sites of phase 21 and phase 18's data-
parallel train step, their captured launches and replays); the last line
is {"ok": true, "device": {...}}. Run without the
repository beside it, or without a CUDA device, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

# published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet); a
# card set to a lower power limit (printed in phase 1) reaches less
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_INT8_OPS = 1979e12     # int8 on the tensor cores, dense
PEAK_F32_FLOPS = 67e12      # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 on the tensor cores, dense
CGM_RTOL = CGM_ATOL = 1e-4  # f32 (3xTF32 on the card), 256-term sums in another order
MATCH_IOU, MATCH_FRACTION, MATCH_DSCORE = 0.95, 0.85, 1e-3
MATCH_PAD = 1e-2  # pixels: the width given to a box clipped to a line when it is matched
PINNED_DSCORE = 1e-5  # the same kernels on the same inputs, eager or replayed
DSA_FOLD_REL = 1e-4  # the DSA head's fold against its chain, of each output's range: f32 sums reassociated
PREPROCESS_ATOL = 2e-3  # 0-255 scale: the resize's f32 matrix products summed in another order
ASYNC_ATOL = 1e-4  # frame coordinates and scores: the same graph on the same canvas
CANVAS_HW, IMAGE_HW = (320, 448), (320.0, 427.0)
FRAME_HW = (480, 640)  # a VGA camera frame: resized to 320x427 on the 320x448 canvas
POST_NMS_TOPK = 256  # serving_vovnet's post_nms_topk_test
MULTICLASS_CLASSES = 9
MULTICLASS_SEEDS = tuple(range(10, 10 + MULTICLASS_CLASSES))
MULTICLASS_K = MULTICLASS_CLASSES * POST_NMS_TOPK  # the multiclass request's cross-class NMS: 2304
NMS_WIDE_K = (2049, 2304, 4096, 8192)  # the sweep past 2048 ranks (phase 3, batches of 10 scenes)
NMS_LARGEST_K = 16384  # 64 classes of 256, one scene
WIDE_NMS_K = 4096  # phase 11's K2 row on random scenes past 2048 ranks (16 classes of 256)
NMS_CPU_K = 2304  # up to this K phase 3 also holds K2 against the plain fixpoint on the CPU
CGM_OTHER_WIDTHS = (64, 160, 256)  # K1 off its tuned 128 channels
# widths off the 16-byte rows (1, 130, 390) and the 16-deep steps (100, 130),
# and past what one slice of W3 holds whole (390, 520: the depth streamed)
CGM_RAGGED_WIDTHS = (1, 100, 130, 390, 520)
CGM_CLASSES = (3, 9)  # K1 with taps for several classes (the multiclass request's 9), beside phase 3's one
DLA_CHANNELS = 160  # finetune_dla's BiFPN width: K1's site with use_pallas_cgm
ASYNC_FRAMES, EVAL_FRAMES, EVAL_SHOTS = 16, 16, 5
AP_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@100")
LEVELS_HW = [(CANVAS_HW[0] // s, CANVAS_HW[1] // s) for s in (8, 16, 32)]
C = 128
PROFILE_ITERS = 10
PROFILE_ATTEMPTS = 3
SUPPORT_BUILD_REPS = 3  # phase 4: the 25-shot cache built again this often, each timed
# phase 13, fine-tuning finetune_vovnet at full width on synthetic VGA frames
TRAIN_CONFIG, TRAIN_FRAMES, TRAIN_CANVAS = "finetune_vovnet", 16, (448, 608)
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
TRAIN_NMS_K = 2048  # max(2048, post_nms_topk_train): the training decode's NMS set
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-3, 1e-3  # card vs CPU in f32, TF32 off; grads of each tensor's largest |grad|
# at LR 1e-3 the loss from random weights swung up to 3x its start (PERF.md, fine-tuning findings)
LEARN_STEPS, LEARN_LR, LEARN_WINDOW, LEARN_RATIO = 30, 1e-4, 5, 0.75
# phase 14, finetune_vovnet K steps per call (CUDA-graph replays of the step)
GRAPH_K, GRAPH_EQ_CHUNKS, GRAPH_TIMED_CHUNKS = 4, (2, 4, 3), 6  # the warm-up steps, then chunks of K
LOADER_BATCHES = 12
# under cuDNN's defaults graphed vs eager may differ by at most this many
# times the largest difference between EAGER_RUNS eager runs (atomics in
# the backward algorithms)
DEFAULTS_FACTOR, EAGER_RUNS = 3.0, 3
# phase 15, finetune_dla at full width
DLA_CONFIG, DLA_WARMUP, DLA_STEPS, DLA_EVAL_FRAMES = "finetune_dla", 3, 10, 8  # 8 frames, a shot from each
DLA_EQ_CHUNKS, DLA_TIMED_CHUNKS = (2, 4), 3
# phase 16, the workflow: .pth -> npz -> support crops -> demo -> feature maps
WORKFLOW_CONFIG = "serving_vovnet"
WORKFLOW_COCO_IMAGES = 12  # synthetic VGA scenes with 1-6 ores each: the support crops' COCO set
WORKFLOW_GLOB, WORKFLOW_VIDEO, WORKFLOW_FRAME_BATCH = 8, 16, 8
WORKFLOW_MAP_TOL = 1e-3  # feature maps card vs CPU in f32, of each map's largest
NMS_TIE = 1e-5  # IoU: a pair this close to the ROI NMS threshold is a tie that f32 rounding decides either way
NMS_TIES_MAX = 1  # such ties that one card-vs-CPU comparison of a video may show
DLA_TOL = 1e-3  # card vs CPU: each loss, gradient and running statistic, of its tensor's largest |value|
DLA_F32_FACTOR = 3.0  # f32 card vs CPU: at most this many times the CPU's own f32 vs f64, where above DLA_TOL
# phase 17, the quantized serving presets at full width
QUANT_PRESETS = ("serving_vovnet_int8", "serving_vovnet_int8_static", "serving_vovnet_int8_resident")
QUANT_YARDSTICK = "serving_vovnet_fast"  # the int8 presets are this preset plus W8A8
QUANT_CALIB_FRAMES = 8
QUANT_GEMMS = 25  # the int8 convs of a request: 3 stem, 4 stages x (3 + concat), 6 FPN
FAST_ROI_K = 64  # serving_vovnet_fast's post_nms_topk_test: K2's ROI site at [B, 64]
# phase 18, data parallel
DP_MAX_CARDS = 4  # the widest mesh phase 18 drives
DP_SERVE_BATCH, DP_SERVE_ITERS = 8, 20  # phase 6's VGA frames, one sharded call each
DP_TRAIN_STEPS = 8  # the pinned step: 2 eager warm-ups, then the capture and 6 replays
# ranks vs one process, held at TRAIN_LOSS_RTOL over the first 4 steps (the phase's earlier run length),
# and after them at every step where each rank's ROI sample is the one process's for its image. A
# product over the global batch and one over a rank's rows differ in the last bits, which in time
# flips a near-tied proposal into or out of the ROI sample (four NCCL ranks: 1.45e-3 of loss_cls_stage0
# at step 6); a step where a sample differs is reported with it. Two samples agree where their class
# targets are equal and their boxes within ROI_SAMPLE_TOL_PX (distinct proposals lie pixels apart)
DP_REFERENCE_STEPS = 4
ROI_SAMPLE_TOL_PX = 0.1
DP_RESUME_STEP = 4  # the world-1 pinned run resumes a checkpoint of this step in place, between replays
DP_TIMED_STEPS = 20  # the graphed steps timed a way (the batches on the card; the loader's pulls inside)
DP_ALLREDUCE_ITERS = 20
DP_RANKS_TIMEOUT_S = 300
# phase 19, the ResNet-50 family
R50_CONFIG = "finetune_R_50_C4_1x"
R50_WARMUP, R50_STEPS, R50_EQ_CHUNKS = 2, 4, (2, 2)  # eager steps; graphed vs eager: warm-up 2, then a chunk of 2
BASELINE_YAML = "configs/fsod/Base-FSOD-C4.yaml"
BASELINE_SHORT, BASELINE_MAX = 600, 1000  # the yaml's MIN_SIZE_TEST, MAX_SIZE_TEST: VGA -> 600x800, canvas 608x800
BASELINE_STEPS = (2, 3)  # warm-up and timed steps
BASELINE_LR = 1e-4  # the yaml's BASE_LR
# the baseline's biases that a softmax or a mean over tokens cancels: their
# gradients are 0 up to rounding, measured against their layer's weight
BASELINE_ZERO_GRAD = ("rpn_enhance.channel_k.bias", "rcnn_enhance.channel_k.bias", "channel_attention.ch_wq.bias",
                      "relation_head.adapt_k.bias", "relation_head.adapt_q.bias")
# the train step's named ranges; the last two are torch.optim's own. Autograd
# launches the backward's kernels from its own thread, outside "backward".
TRAIN_STAGES = ("features", "refine_support", "correlate", "proposal_head", "targets", "decode_proposals",
                "roi_sampling", "roi_stage", "backward", "optimizer", "Optimizer.step#SGD.step",
                "Optimizer.zero_grad#SGD.zero_grad")
# phase 20, the one-stage CenterNet over P3-P7, the rest of the zoo, fed loss, profiling, the native matcher
ONESTAGE_CONFIG, ONESTAGE_FRAMES, ONESTAGE_CLASSES = "finetune_vovnet", 6, (1, 9)
ONESTAGE_LEVELS, ONESTAGE_STRIDES = ("p3", "p4", "p5", "p6", "p7"), (8, 16, 32, 64, 128)
PINNED_ONESTAGE_FRAMES = 2  # phase 21: pinned against eager on two of phase 20's frames a configuration
# phase 20, CenterNet-S4 over DLA-34-DCN as the benchmark's one-stage cell serves it: finetune_dla with these
# overrides, eight VGA frames a request on the 608x832 canvas (the stride-4 map 152x208)
ONESTAGE_DLA_OVERRIDES = (
    "backbone_name=dla_seg", "centernet.num_classes=80", "centernet.in_features=('dla2',)",
    "centernet.fpn_strides=(4,)", "centernet.sizes_of_interest=((0, 1000000),)", "centernet.only_proposal=False",
    "centernet.with_agn_hm=False", "centernet.more_pos=True", "centernet.nms_thresh_test=0.6",
    "centernet.post_nms_topk_test=100", "input.min_size_test=608", "input.max_size_test=900",
    "input.pixel_mean=(123.675, 116.28, 103.53)", "input.pixel_std=(58.395, 57.12, 57.375)", "input.format=RGB")
ONESTAGE_DLA_BATCH, ONESTAGE_DLA_CANVAS = 8, (608, 832)
# a body's deformable convs and their samples, B * Ho * Wo * 9 summed: 5 blocks on the 152x208 map, the rest coarser
ONESTAGE_DLA_DEFORM = (16, 15_400_944)
ZOO_INPUT_HW, DLASEG_INPUT_HW, ZOO_ATTENTION_CHANNELS = (384, 512), (512, 512), 128
ZOO_TOL = 1e-4  # card vs CPU in f32, of each output's largest |value| (or DLA_F32_FACTOR x the witness)
REGNET_Y_400MF = dict(w_a=27.89, w_0=48, w_m=2.09, depth=16, group_width=8, se_ratio=0.25)
FED_CLASSES, FED_LOSS_RTOL = 100, 1e-5  # the loss: a sum of 6400 f32 terms in another order
STAGES = ("features", "correlate", "proposal_head", "decode_proposals", "roi_stage", "roi_inference")
OWN_KERNELS = ("cgm_kernel", "nms_rank_kernel", "nms_mask_kernel", "nms_sweep_kernel", "roi_align_kernel")


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def enqueue_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time of fn() in ms over `iters` back-to-back calls, CUDA events
    around the calls: the host's work of each call lies inside the window,
    so where it takes longer than the kernel this reads the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of fn() in ms with no host work in the window: `iters`
    calls captured once in a CUDA graph (after a warm-up on a side stream),
    each replay timed with CUDA events and divided by `iters`; the median of
    `reps` replays. fn must launch on the current stream and never sync."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def profile_requests(torch, request, wall_ms: float, stages=STAGES) -> dict:
    """PROFILE_ITERS requests under torch.profiler, per request: device busy
    ms (the sum of kernel times; the path runs on one stream, so kernels do
    not overlap), the idle share of the median wall time `wall_ms` measured
    without the profiler, kernel launches, this port's own kernels' ms, each
    stage's device span (first kernel start to last kernel end, idle gaps
    included; the profiler slows the host; `stages` names the ranges) and
    the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt, names=("self_device_time_total", "self_cuda_time_total")):
        return next((float(getattr(evt, n)) for n in names if hasattr(evt, n)), 0.0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ITERS):
            request()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_card if e.key not in stages]
    spans = {e.key: device_us(e, ("device_time_total", "cuda_time_total")) / PROFILE_ITERS / 1e3
             for e in on_card if e.key in stages}
    busy = sum(device_us(e) for e in kernels) / PROFILE_ITERS / 1e3
    own = {n: [e for e in kernels if n in e.key] for n in OWN_KERNELS}
    own_ms = {n: [sum(device_us(e) for e in es) / PROFILE_ITERS / 1e3,
                  sum(e.count for e in es) / PROFILE_ITERS] for n, es in own.items()}
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    return {
        "wall_ms_median": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "kernel_launches_per_request": sum(e.count for e in kernels) / PROFILE_ITERS,
        "own_kernels_ms": sum(v[0] for v in own_ms.values()),
        "own_kernel_ms_and_launches_per_request": own_ms, "stage_device_span_ms": spans,
        "top_kernels_ms": [[e.key[:70], device_us(e) / PROFILE_ITERS / 1e3, e.count // PROFILE_ITERS]
                           for e in top],
    }


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> dict:
    """Least time for the work: the larger of bytes over the memory rate and
    the operations' time, `tc_flops` (a matrix product) at the TF32 tensor-core
    rate plus `flops` (elementwise and compare work) at the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = tc_flops / PEAK_TF32_FLOPS + flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "operations" if t_ops > t_bytes else "bytes"}


# ------------------------------------------------------------------ inputs
def cgm_inputs(torch, g, b, h, w, dtype, c=C, n_cls=0):
    """K1's inputs: one set of taps, or n_cls sets (a class axis) where n_cls > 0."""
    dev = "cuda"
    lead = (n_cls,) if n_cls else ()
    q = torch.randn(b, h, w, c, device=dev, generator=g).to(dtype)
    k1 = torch.randn(*lead, c, device=dev, generator=g)
    k13 = torch.randn(*lead, 3, c, device=dev, generator=g)
    k31 = torch.randn(*lead, 3, c, device=dev, generator=g)
    w3 = torch.randn(c, 2 * c, device=dev, generator=g) / (2 * c) ** 0.5  # nn.Linear's [out, in]
    b3 = 0.1 * torch.randn(c, device=dev, generator=g)
    return q, k1, k13, k31, w3, b3


def nms_scenes(np, k, rng):
    """Ten [K] scenes: random, random all valid, dense chain, score ties,
    invalid tail padding, invalid rows scattered, no valid row, one valid row
    (drawn from `rng`), then ascending scores (the rank order reverses the
    input) and all scores equal (drawn from a generator of their own, so
    that the first eight are those of earlier runs)."""

    def scene(n_valid, spread=200.0, size=40.0, rng=rng):
        centers = rng.uniform(0, spread, (k, 2))
        wh = rng.uniform(8.0, size, (k, 2))
        boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 1)
        valid = np.zeros(k, bool)
        valid[:n_valid] = True
        return boxes, rng.uniform(0.01, 1.0, k), valid

    xs = np.linspace(0, 400, k)
    chain = (np.stack([xs, np.zeros(k), xs + 50, np.full(k, 50.0)], 1), rng.uniform(0.01, 1.0, k),
             np.ones(k, bool))
    tb, _, tv = scene(k, spread=120.0)
    ties = (tb, rng.choice(np.asarray([0.2, 0.5, 0.5, 0.9]), k), tv)
    sb, ss, _ = scene(k)
    scattered = (sb, ss, rng.uniform(size=k) < 0.7)
    scenes = [scene(int(0.9 * k)), scene(k), chain, ties, scene(k // 2), scattered, scene(0), scene(1)]
    edge_rng = np.random.default_rng(k)
    ab, as_, av = scene(k, rng=edge_rng)
    eb, _, ev = scene(k, spread=120.0, rng=edge_rng)
    scenes += [(ab, np.sort(as_), av), (eb, np.full(k, 0.5), ev)]
    boxes = np.stack([s[0] for s in scenes]).astype(np.float32)
    scores = np.stack([s[1] for s in scenes]).astype(np.float32)
    valid = np.stack([s[2] for s in scenes])
    return boxes, scores, valid


def match(np, got, ref, max_dscore, by_class=False) -> dict:
    """Phase 5's criteria on one image's detections (numpy dicts): the same
    number valid, >= MATCH_FRACTION of them greedy-matched at IoU >=
    MATCH_IOU with |dscore| <= max_dscore, each side's top 10 matched. With
    by_class, boxes of different classes never match (each class is shifted
    to a region of its own) and each class keeps the same count."""
    gv, rv = got["valid"], ref["valid"]
    gb, gs, rb, rs = got["boxes"][gv], got["scores"][gv], ref["boxes"][rv], ref["scores"][rv]
    if by_class:
        gb = gb + 1e4 * got["classes"][gv][:, None]
        rb = rb + 1e4 * ref["classes"][rv][:, None]
    pairs, dscore, used_g, used_r = greedy_match(np, gb, gs, rb, rs, MATCH_IOU)
    top_g = set(np.argsort(-gs, kind="mergesort")[:10].tolist())
    top_r = set(np.argsort(-rs, kind="mergesort")[:10].tolist())
    top10 = top_g <= used_g and top_r <= used_r
    ok = gv.sum() == rv.sum() > 0 and len(pairs) >= MATCH_FRACTION * rv.sum() and dscore <= max_dscore and top10
    if by_class:
        counts = [np.bincount(d["classes"][d["valid"]], minlength=8).tolist() for d in (got, ref)]
        ok = ok and counts[0] == counts[1]
    return {"valid": [int(gv.sum()), int(rv.sum())], "matched": len(pairs), "max_dscore": dscore,
            "top10_matched": top10, "ok": bool(ok)}


def box_iou(np, got_b, ref_b):
    a1 = (got_b[:, 2] - got_b[:, 0]) * (got_b[:, 3] - got_b[:, 1])
    a2 = (ref_b[:, 2] - ref_b[:, 0]) * (ref_b[:, 3] - ref_b[:, 1])
    lt = np.maximum(got_b[:, None, :2], ref_b[None, :, :2])
    rb = np.minimum(got_b[:, None, 2:], ref_b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return np.where(inter > 0, inter / np.maximum(a1[:, None] + a2[None] - inter, 1e-12), 0.0)


def greedy_match(np, got_b, got_s, ref_b, ref_s, iou_min):
    """Greedy one-to-one matching by descending IoU >= iou_min; among pairs
    of equal IoU (a random model's detections can repeat a box, clipped to
    the image) the closer scores first. A box clipped to a line has no area:
    a pair with one is compared with both boxes widened by MATCH_PAD pixels
    on each side, so that two lines match when their coordinates agree."""
    iou = box_iou(np, got_b, ref_b)
    flat = lambda b: (b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])  # noqa: E731
    pad = np.asarray([-MATCH_PAD, -MATCH_PAD, MATCH_PAD, MATCH_PAD])
    iou = np.where(flat(got_b)[:, None] | flat(ref_b)[None, :], box_iou(np, got_b + pad, ref_b + pad), iou)
    pairs, used_g, used_r = [], set(), set()
    dscores = np.abs(np.asarray(got_s, np.float64)[:, None] - np.asarray(ref_s, np.float64)[None, :])
    for j, r in zip(*np.unravel_index(np.lexsort((dscores.ravel(), -iou.ravel())), iou.shape)):
        if iou[j, r] < iou_min:
            break
        if j in used_g or r in used_r:
            continue
        used_g.add(int(j))
        used_r.add(int(r))
        pairs.append((int(j), int(r)))
    dscore = max((abs(float(got_s[j]) - float(ref_s[r])) for j, r in pairs), default=0.0)
    return pairs, dscore, used_g, used_r


# ------------------------------------------------------------------ phases
def phase_kernels(torch, np, cgm_cuda, nms_cuda, nms_plain, nms_batched_plain):
    g = torch.Generator(device="cuda").manual_seed(0)
    cgm_err, cgm_mismatches = 0.0, 0
    # the main path's levels at batch 1 and 8, and ragged tile edges at batch
    # 3, at C = 128; then the other widths at the main path's levels; then
    # taps for several classes at batch 1's levels, and ragged widths
    shapes = [(1, b, h, w, C) for b in (1, 8) for (h, w) in LEVELS_HW]
    shapes += [(1, 3, 1, 1, C), (1, 3, 3, 5, C), (1, 3, 7, 33, C)]
    shapes += [(1, b, h, w, c) for c in CGM_OTHER_WIDTHS for b in (1, 8) for (h, w) in LEVELS_HW]
    shapes += [(n, 1, h, w, c) for n in CGM_CLASSES for c in (C,) + CGM_OTHER_WIDTHS for (h, w) in LEVELS_HW]
    shapes += [(n, 3, 7, 33, c) for n in (1, 2) for c in CGM_RAGGED_WIDTHS]  # n = 1: taps without a class axis
    for (n, b, h, w, c) in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            args = cgm_inputs(torch, g, b, h, w, dtype, c, n_cls=n if n > 1 else 0)
            out32 = cgm_cuda.cgm_correlate_fused(*args, out_dtype=torch.float32)
            out = cgm_cuda.cgm_correlate_fused(*args)  # in q's dtype, as the main path calls it
            torch.cuda.synchronize()
            ref = cgm_cuda.cgm_fused_plain(*args, out_dtype=torch.float32)
            err = (out32 - ref).abs()
            bad = int((err > CGM_ATOL + CGM_RTOL * ref.abs()).sum())
            # the q-dtype output is the same f32 result rounded once (a bf16
            # rounding of two f32 values 1e-6 apart can differ by one ulp, so
            # the tolerance is held on the f32 result)
            rounded = int((out != out32.to(dtype)).sum())
            # and phase 19's bound: within a dot product's error of the f64 result
            ref64, terms = cgm_f64(torch, *args)
            over = int(((out32.double() - ref64).abs() > CGM_ATOL + CGM_RTOL * terms).sum())
            cgm_err, cgm_mismatches = max(cgm_err, float(err.max())), cgm_mismatches + bad + rounded + over
            emit(check="cgm", classes=n, batch=b, hw=[h, w], channels=c, q_dtype=str(dtype)[6:],
                 max_abs_err=float(err.max()), out_of_tolerance=bad, out_of_bound=over, out_dtype=str(out.dtype)[6:],
                 rounding_mismatches=rounded)
            if bad or rounded or over or out.dtype != dtype or out.shape != (n * b, h, w, c) \
                    or not torch.isfinite(out32).all():
                raise AssertionError(f"CGM kernel disagrees with its plain twin at {n} classes, {b}x{h}x{w}x{c}")
    rng = np.random.default_rng(0)
    nms_mismatches, nms_err = 0, 0.0
    for k in (1, 63, 64, 65, 256, 512, 1000, 1024, 1792, 2048) + NMS_WIDE_K:
        boxes, scores, valid = nms_scenes(np, k, rng)
        # the whole batch of 10 scenes, and at the main path's K (decode 1024,
        # ROI 256) each scene alone, as a batch-1 request launches it
        n = len(scores)
        slices = [slice(0, n)] + ([slice(i, i + 1) for i in range(n)] if k in (256, 1024) else [])
        for thr in (0.6, 0.9):
            for s in slices:
                cpu = (torch.from_numpy(boxes[s]), torch.from_numpy(scores[s]), torch.from_numpy(valid[s]))
                dev = tuple(t.cuda() for t in cpu)
                keep = nms_cuda.nms_mask(*dev, thr)
                torch.cuda.synchronize()
                # past NMS_CPU_K the CPU's fixpoint takes too long: the plain version runs on the card only
                ref_cpu = nms_plain(*cpu, thr) if k <= NMS_CPU_K else None
                diff, err = compare_masks(torch, keep, nms_plain(*dev, thr), ref_cpu)
                nms_mismatches, nms_err = nms_mismatches + diff, max(nms_err, err)
                emit(check="nms", batch=int(keep.shape[0]), scenes=[s.start, s.stop], k=k, thr=thr,
                     kept=int(keep.sum()), mismatches=diff, plain_on_cpu=ref_cpu is not None)
                if diff:
                    raise AssertionError(f"NMS kernel differs from the plain fixpoint at K={k}")
    # K = 16384 (64 classes of 256) on the first scene: 32 MiB of mask
    k = NMS_LARGEST_K
    boxes, scores, valid = nms_scenes(np, k, np.random.default_rng(k))
    dev = tuple(torch.from_numpy(a[:1]).cuda() for a in (boxes, scores, valid))
    for thr in (0.6, 0.9):
        keep = nms_cuda.nms_mask(*dev, thr)
        torch.cuda.synchronize()
        diff, err = compare_masks(torch, keep, nms_plain(*dev, thr), None)
        nms_mismatches, nms_err = nms_mismatches + diff, max(nms_err, err)
        emit(check="nms", batch=1, scenes=[0, 1], k=k, thr=thr, kept=int(keep.sum()), mismatches=diff,
             plain_on_cpu=False)
        if diff:
            raise AssertionError(f"NMS kernel differs from the plain fixpoint at K={k}")
    # the multiclass sites: classes of 256 (class-major, as the multiclass
    # path lays them out) through the class-offset trick, whose boxes reach
    # about n_classes times the scenes' extent
    for n_cls in (3, MULTICLASS_CLASSES):
        k = n_cls * POST_NMS_TOPK
        boxes, scores, valid = nms_scenes(np, k, np.random.default_rng(k))
        classes = np.broadcast_to(np.arange(k) // POST_NMS_TOPK, scores.shape).astype(np.int32)
        for thr in (0.6, 0.9):
            cpu = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (boxes, scores, classes, valid))
            dev = tuple(t.cuda() for t in cpu)
            keep = nms_cuda.batched_nms_mask(*dev, thr)
            torch.cuda.synchronize()
            diff, err = compare_masks(torch, keep, nms_batched_plain(*dev, thr), nms_batched_plain(*cpu, thr))
            nms_mismatches, nms_err = nms_mismatches + diff, max(nms_err, err)
            emit(check="nms_class_offset", batch=int(keep.shape[0]), k=k, classes=n_cls, thr=thr,
                 kept=int(keep.sum()), mismatches=diff)
            if diff:
                raise AssertionError(f"class-aware NMS differs from the plain fixpoint at K={k}")
    return cgm_err, cgm_mismatches, nms_err, nms_mismatches


def compare_masks(torch, keep, ref_card, ref_cpu):
    """Mismatches and max |err| of a kernel's keep mask against the plain
    fixpoint's on the same tensors on the card and, unless ref_cpu is None,
    on their CPU copies."""
    diff = int((keep != ref_card).sum())
    err = float((keep.float() - ref_card.float()).abs().max())
    if ref_cpu is not None:
        diff += int((keep.cpu() != ref_cpu).sum())
        err = max(err, float((keep.cpu().float() - ref_cpu.float()).abs().max()))
    return diff, err


def support_inputs(torch, np, cfg, shots, rng):
    crop = cfg.fs.support_crop_size
    canvas = -(-crop // 32) * 32
    u8 = rng.integers(0, 256, (shots, 3, canvas, canvas), dtype=np.uint8)
    mean = np.asarray(cfg.input.pixel_mean, np.float32)[:, None, None]
    std = np.asarray(cfg.input.pixel_std, np.float32)[:, None, None]
    imgs = (u8.astype(np.float32) - mean) / std
    imgs[:, :, crop:, :] = 0.0
    imgs[:, :, :, crop:] = 0.0
    x1y1 = rng.uniform(0, 60, (shots, 2))
    wh = rng.uniform(80, crop - 70, (shots, 2))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, crop - 1.0)], 1).astype(np.float32)
    return torch.from_numpy(imgs), torch.from_numpy(boxes)


def kernels(cgm: int = 0, nms: int = 0, roi: int = 0) -> dict:
    """Launches of K1, K2 and K3, as `count_launches` and the pinned
    functions' graphs give them."""
    return {"cgm": cgm, "nms": nms, "roi": roi}


def count_launches(cgm_cuda, nms_cuda, run) -> dict:
    """The kernel launches that run() makes (K1, K2 and K3), by the wrappers'
    counters set to 0 just before it and read just after."""
    import torch

    from faster_orefsdet_tpu_torch.ops import roi_align_cuda

    cgm_cuda.counter.launches = 0
    nms_cuda.counter.launches = 0
    roi_align_cuda.counter.launches = 0
    run()
    torch.cuda.synchronize()
    return kernels(cgm_cuda.counter.launches, nms_cuda.counter.launches, roi_align_cuda.counter.launches)


def synthetic_frames(np, n, seed):
    """n VGA frames [480, 640, 3] uint8 (BGR), drawn with numpy: a noisy
    gray background with filled ellipses, one small, one medium and one
    large (by COCO's area ranges) and up to three more, and their boxes as
    the ground truth (xyxy)."""
    rng = np.random.default_rng(seed)
    h, w = FRAME_HW
    yy, xx = np.mgrid[0:h, 0:w]
    frames, boxes = [], []
    for _ in range(n):
        img = rng.normal(110, 12, (h, w, 3))
        frame_boxes = []
        semi_axes = [(6, 14), (20, 40), (55, 90)] + [(6, 90)] * int(rng.integers(0, 4))
        for lo, hi in semi_axes:
            a, b = rng.uniform(lo, hi, 2)
            cx, cy = rng.uniform(a + 2, w - a - 2), rng.uniform(b + 2, h - b - 2)
            img[((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 <= 1.0] = rng.uniform(35, 75)
            frame_boxes.append((cx - a, cy - b, cx + a, cy + b))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        boxes.append(frame_boxes)
    return frames, boxes


def phase_raw_frames(torch, np, cfg, params, cache, frames_u8):
    """preprocess_device on the card against the CPU, then build_serving_fn
    on the same VGA frames."""
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.pipelines.inference import build_serving_fn, pack_detections
    from faster_orefsdet_tpu_torch.pipelines.preprocess import preprocess_device, resize_shortest_edge_size

    out_hw = resize_shortest_edge_size(*FRAME_HW, cfg.input.min_size_test, cfg.input.max_size_test)
    # mean 0 and std 1: the comparison holds on the 0-255 scale, before normalization
    card = preprocess_device(frames_u8.cuda(), out_hw, CANVAS_HW, (0.0,) * 3, (1.0,) * 3)
    cpu = preprocess_device(frames_u8, out_hw, CANVAS_HW, (0.0,) * 3, (1.0,) * 3)
    diff = float((card.cpu() - cpu).abs().max())
    emit(raw_frames={"preprocess_device": {"frames": list(frames_u8.shape), "resized": list(out_hw),
                                           "canvas": list(card.shape[-2:]), "max_abs_diff_0_255": diff}})
    if diff > PREPROCESS_ATOL or tuple(card.shape[-2:]) != CANVAS_HW:
        raise AssertionError(f"preprocess_device: card vs CPU differ by {diff}")

    serve_raw, canvas_hw = build_serving_fn(cfg, params, FRAME_HW)
    frames = frames_u8.cuda()
    out = {}
    launches = count_launches(cgm_cuda, nms_cuda, lambda: out.update(p=pack_detections(serve_raw(cache, frames))))
    p = out["p"]
    valid = p[..., 6] > 0.5
    boxes = p[..., :4][valid]
    inside = bool((boxes >= 0).all() and (boxes[:, 0::2] <= FRAME_HW[1] + 1e-2).all()
                  and (boxes[:, 1::2] <= FRAME_HW[0] + 1e-2).all())
    emit(raw_frames={"serving": {"canvas": list(canvas_hw), "packed": list(p.shape), "launches": launches,
                                 "valid_per_frame": valid.sum(-1).tolist(), "boxes_inside_frame": inside}})
    if (tuple(canvas_hw) != CANVAS_HW or tuple(p.shape) != (len(frames), 100, 7) or not torch.isfinite(p).all()
            or not inside or (valid.sum(-1) < 1).any()):
        raise AssertionError("raw-frame serving gave a wrong result")
    if launches != kernels(3, 2, 1):
        raise AssertionError(f"kernel launch counts {launches} on the raw-frame path")
    return launches


def phase_pinned(torch, np, cfg, params, cache, serve1, serve8, singles, u8, hw8):
    """build_pinned_inference_fn against the eager builders on the main
    path's inputs, and two held results that must not alias."""
    from faster_orefsdet_tpu_torch.pipelines.inference import (
        build_pinned_inference_fn, pack_detections, unpack_detections_np,
    )

    pinned = build_pinned_inference_fn(cfg, params, cache, packed=True)
    eager = [pack_detections(serve1(cache, singles[i], IMAGE_HW)) for i in range(3)]
    eager += [pack_detections(serve8(cache, u8[i], hw8)) for i in range(2)]
    got = [pinned(singles[i], IMAGE_HW) for i in range(3)] + [pinned(u8[i], hw8) for i in range(2)]
    torch.cuda.synchronize()
    identical = sum(int((a == b).sum()) for a, b in zip(got, eager))
    total = sum(a.numel() for a in got)
    checks = []
    for a, b in zip(got, eager):
        ga, gb = unpack_detections_np(a.reshape(-1, 100, 7)), unpack_detections_np(b.reshape(-1, 100, 7))
        for i in range(len(ga["valid"])):
            checks.append(match(np, {k: v[i] for k, v in ga.items()}, {k: v[i] for k, v in gb.items()},
                                PINNED_DSCORE))
    first, second = pinned(singles[0], IMAGE_HW), pinned(singles[1], IMAGE_HW)
    torch.cuda.synchronize()
    no_alias = (first.data_ptr() != second.data_ptr() and torch.equal(first, got[0])
                and torch.equal(second, got[1]) and not torch.equal(first, second))
    graphs = {f"{list(k[0][0])} {str(k[0][1])[6:]}": {"captured_launches": g.launches, "replays": g.replays}
              for k, g in pinned.graphs.items()}  # keyed by the (shape, dtype) of each input, images first
    emit(pinned={"images_checked": len(checks), "all_matched": all(c["ok"] for c in checks),
                 "max_dscore": max(c["max_dscore"] for c in checks), "bit_identical_values": identical,
                 "values": total, "held_results_do_not_alias": no_alias, "graphs": graphs,
                 "replay_launches": pinned.kernel_launches()})
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"pinned and eager detections do not match: {checks}")
    if not no_alias:
        raise AssertionError("two held pinned results alias or changed")
    if any(g.launches != kernels(3, 2, 1) for g in pinned.graphs.values()):
        raise AssertionError(f"pinned graphs captured {graphs}")
    return pinned.kernel_launches()


def phase_multiclass(torch, np, cfg, params, serve1, singles, img32):
    """Three 25-shot caches stacked; the multiclass request's launches; card
    vs CPU in f32; one class stacked against build_inference_fn."""
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.pipelines.inference import (
        build_multiclass_inference_fn, pack_detections, unpack_detections_np,
    )
    from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache, stack_support_caches

    caches = [build_support_cache(cfg, params, *support_inputs(torch, np, cfg, 25, np.random.default_rng(s)))
              for s in MULTICLASS_SEEDS]
    mcache = stack_support_caches(caches)
    multi = build_multiclass_inference_fn(cfg, params)
    out, seen, cgm_seen = {}, {}, []
    # the counted run records what K1 and K2 get, so that the cross-class
    # site's launches and inputs are this run's own
    launches = count_launches(cgm_cuda, nms_cuda, lambda: seen.update(record_nms_calls(
        torch, lambda: cgm_seen.extend(record_cgm_calls(
            torch, lambda: out.update(p=pack_detections(multi(mcache, singles[0], IMAGE_HW))))))))
    p = out["p"]
    classes = p[:, 5][p[:, 6] > 0.5]
    ok_out = bool(tuple(p.shape) == (100, 7) and torch.isfinite(p).all() and len(classes) > 0
                  and classes.min() >= 0 and classes.max() < len(caches))

    cfg32 = cfg.replace(compute_dtype="float32")
    dets = {}
    for d in ("cuda", "cpu"):
        mc = stack_support_caches([
            build_support_cache(cfg32, params, *support_inputs(torch, np, cfg32, 5, np.random.default_rng(s)),
                                device=d) for s in MULTICLASS_SEEDS])
        det = build_multiclass_inference_fn(cfg32, params, device=d)(mc, img32, IMAGE_HW)
        dets[d] = unpack_detections_np(pack_detections(det))
    card_vs_cpu = match(np, dets["cuda"], dets["cpu"], MATCH_DSCORE, by_class=True)
    one = unpack_detections_np(pack_detections(multi(stack_support_caches(caches[:1]), singles[0], IMAGE_HW)))
    single = unpack_detections_np(pack_detections(serve1(caches[0], singles[0], IMAGE_HW)))
    one_class = match(np, one, single, PINNED_DSCORE)
    nms_checks, nms_err = check_nms_calls(torch, seen)
    cgm_checks, cgm_err, cgm_bad = check_cgm_calls(torch, cgm_seen)
    cross = [args for args in seen["kernel"] if list(args[0].shape[:2]) == [1, MULTICLASS_K]]
    emit(multiclass={"classes": len(caches), "launches": launches,
                     "valid_per_class": np.bincount(classes.long().cpu().numpy(), minlength=len(caches)).tolist(),
                     "card_vs_cpu_f32": card_vs_cpu, "one_class_vs_build_inference_fn": one_class,
                     "nms_on_the_request_inputs": nms_checks, "cgm_on_the_request_inputs": cgm_checks})
    if not ok_out:
        raise AssertionError(f"multiclass detections are not finite [100, 7] with classes 0..{len(caches) - 1}")
    # one K1 launch a level over the classes' stacked taps, as the JAX
    # package's vmapped Pallas call
    if launches != kernels(3, 2, 1) or [c["classes"] for c in cgm_checks] != [len(caches)] * 3 or cgm_bad:
        raise AssertionError(f"kernel launch counts {launches} on the multiclass path, K1 calls {cgm_checks}")
    if not (card_vs_cpu["ok"] and one_class["ok"]):
        raise AssertionError("multiclass detections do not match")
    sites = [c["shape"] for c in nms_checks if c["site"] == "kernel"]
    if sites != [[len(caches), 1024], [1, MULTICLASS_K]] or any(c["mismatches"] for c in nms_checks):
        raise AssertionError(f"the NMS kernel on the multiclass request's own inputs: {nms_checks}")
    # K2 at the cross-class site: its launches in the counted run, and the
    # inputs of the first (class-offset boxes, scores, valid, threshold);
    # K1's calls, one a level
    return multi, mcache, launches, nms_err, {"launches": len(cross), "args": cross[0], "cgm_calls": cgm_seen,
                                              "cgm_err": cgm_err}


def nms_checks_on_request(torch, request):
    """The NMS kernel held bit for bit against the plain fixpoint on the
    inputs a request (a multiclass request, a train step's decode) gives it:
    record_nms_calls, then check_nms_calls. Returns the checks, the largest
    |err| and the recorded calls by site."""
    seen = record_nms_calls(torch, request)
    checks, worst = check_nms_calls(torch, seen)
    return checks, worst, seen


def record_nms_calls(torch, request):
    """Runs request() once with the wrappers' entries recording copies of
    their arguments (every kernel launch, and the class-aware call across
    classes); returns the recorded calls by site. The recording launches
    nothing, so request() may be a counted run."""
    from faster_orefsdet_tpu_torch.ops import nms_cuda

    launch, batched = nms_cuda._launch, nms_cuda.batched_nms_mask
    seen = {"kernel": [], "batched": []}

    def recorder(site, fn):
        def wrapped(*args):
            seen[site].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return fn(*args)
        return wrapped

    nms_cuda._launch, nms_cuda.batched_nms_mask = recorder("kernel", launch), recorder("batched", batched)
    try:
        request()
        torch.cuda.synchronize()
    finally:
        nms_cuda._launch, nms_cuda.batched_nms_mask = launch, batched
    return seen


def record_captured_nms_shapes(torch, request):
    """Runs request() with K2's launch entry recording the [B, K] of each
    launch made while a CUDA graph is being captured (the launches that its
    replays repeat); returns them. Eager launches are not recorded, and the
    recording launches nothing."""
    from faster_orefsdet_tpu_torch.ops import nms_cuda

    launch, shapes = nms_cuda._launch, []

    def wrapped(boxes, *rest):
        if torch.cuda.is_current_stream_capturing():
            shapes.append(list(boxes.shape[:2]))
        return launch(boxes, *rest)

    nms_cuda._launch = wrapped
    try:
        request()
    finally:
        nms_cuda._launch = launch
    return shapes


def record_roi_samples(torch, request):
    """Runs request() with the train step's ROI sampler recording what it
    returns at each call (device copies, read back after request()):
    returns [(boxes [B, R, 4], class targets [B, R])] as numpy arrays, a
    step each."""
    from faster_orefsdet_tpu_torch.pipelines import train_step

    sample, seen = train_step.subsample_proposals, []

    def wrapped(*args, **kwargs):
        out = sample(*args, **kwargs)
        seen.append((out[0].detach().clone(), out[1].clone()))
        return out

    train_step.subsample_proposals = wrapped
    try:
        request()
    finally:
        train_step.subsample_proposals = sample
    return [(b.cpu().numpy(), c.cpu().numpy()) for b, c in seen]


def roi_sample_flips(np, rows, reference) -> list:
    """For each step, the images whose ROI sample in `rows` (a rank's
    [(boxes, classes)] each, or one process's) is not the one in
    `reference` (one process's over the global batch): class targets
    unequal or a box beyond ROI_SAMPLE_TOL_PX. Returns a list a step."""
    out = []
    for step, (ref_boxes, ref_cls) in enumerate(reference):
        boxes = np.concatenate([r[step][0] for r in rows])
        cls = np.concatenate([r[step][1] for r in rows])
        out.append([i for i in range(len(ref_cls)) if not (
            np.array_equal(cls[i], ref_cls[i]) and np.abs(boxes[i] - ref_boxes[i]).max() <= ROI_SAMPLE_TOL_PX)])
    return out


def check_nms_calls(torch, seen):
    """Each recorded call runs again through the kernel and through the
    plain version, on the same card tensors and on their CPU copies. These
    extra launches are outside any counted run. Returns the checks and the
    largest |err|."""
    from faster_orefsdet_tpu_torch.ops import nms, nms_cuda

    pairs = {"kernel": (nms_cuda.nms_mask, nms.nms_mask), "batched": (nms_cuda.batched_nms_mask, nms.batched_nms_mask)}
    checks, worst = [], 0.0
    for site, calls in seen.items():
        kernel_fn, plain_fn = pairs[site]
        for args in calls:
            tensors, thr = args[:-1], args[-1]
            keep = kernel_fn(*tensors, thr)
            torch.cuda.synchronize()
            diff, err = compare_masks(torch, keep, plain_fn(*tensors, thr), plain_fn(*(t.cpu() for t in tensors), thr))
            worst = max(worst, err)
            checks.append({"site": site, "shape": list(keep.shape), "thr": thr, "kept": int(keep.sum()),
                           "mismatches": diff})
    return checks, worst


def phase_async(torch, np, cfg, params, cache, frames, smi):
    """AsyncPredictor(depth=3) with and without readback workers: each
    result is that frame's own pinned call, in order."""
    from faster_orefsdet_tpu_torch.pipelines.async_predictor import AsyncPredictor
    from faster_orefsdet_tpu_torch.pipelines.preprocess import preprocess_host

    inp = cfg.input
    for workers in (0, 2):
        pred = AsyncPredictor(cfg, params, cache, depth=3, readback_workers=workers)
        t0 = time.perf_counter()
        results = list(pred.run(frames))
        first_s = time.perf_counter() - t0  # the first pass captures the graph
        t0 = time.perf_counter()
        again = list(pred.run(frames))
        steady_s = time.perf_counter() - t0
        worst = {"boxes": 0.0, "scores": 0.0}
        same_count = len(results) == len(frames)
        for f, r, r2 in zip(frames, results, again):
            canvas, hw, (sy, sx) = preprocess_host(f, inp.min_size_test, inp.max_size_test, CANVAS_HW,
                                                   inp.pixel_mean, inp.pixel_std)
            p = pred._pinned(canvas.cuda(), torch.tensor([float(hw[0]), float(hw[1])])).cpu().numpy()
            valid = p[:, 6] > 0.5
            ref = {"boxes": p[valid, :4] * np.asarray([sx, sy, sx, sy]), "scores": p[valid, 4]}
            for got in (r, r2):
                same_count = same_count and len(got["scores"]) == len(ref["scores"]) > 0
                if len(got["scores"]) == len(ref["scores"]):
                    for k in worst:
                        worst[k] = max(worst[k], float(np.abs(got[k] - ref[k]).max(initial=0.0)))
        emit(**{"async": {"frames": len(frames), "depth": 3, "readback_workers": workers,
                          "in_order_and_matched": same_count, "max_abs_diff": worst,
                          "first_pass_frames_per_s": len(frames) / first_s,
                          "frames_per_s": len(frames) / steady_s, "card": smi}})
        if not same_count or worst["boxes"] > ASYNC_ATOL or worst["scores"] > ASYNC_ATOL:
            raise AssertionError(f"async results differ from their pinned calls ({workers} readback workers)")


def eval_data(np, cfg, n_frames, shots, seed=5):
    """n synthetic VGA frames as eval records, a support crop around each
    of the first `shots` frames' large ellipse, and the in-memory store
    that `imread` reads: (records, entries, store)."""
    from faster_orefsdet_tpu_torch.data.coco import Annotation, ImageRecord, SupportEntry

    frames, gt_boxes = synthetic_frames(np, n_frames, seed=seed)
    store = {f"frame{i}": f for i, f in enumerate(frames)}
    records = [ImageRecord(f"frame{i}", i + 1, *FRAME_HW,
                           [Annotation(i * 100 + j, tuple(float(v) for v in b), 1) for j, b in enumerate(boxes)])
               for i, boxes in enumerate(gt_boxes)]
    crop = cfg.fs.support_crop_size
    entries = []
    for i in range(shots):  # a crop around each frame's large ellipse
        x1, y1, x2, y2 = gt_boxes[i][2]
        ox = int(np.clip((x1 + x2) / 2 - crop / 2, 0, FRAME_HW[1] - crop))
        oy = int(np.clip((y1 + y2) / 2 - crop / 2, 0, FRAME_HW[0] - crop))
        store[f"crop{i}"] = frames[i][oy:oy + crop, ox:ox + crop]
        box = np.clip(np.asarray([x1 - ox, y1 - oy, x2 - ox, y2 - oy]), 0, crop - 1).tolist()
        entries.append(SupportEntry(i, i + 1, 1, f"crop{i}", tuple(box)))
    return records, entries, store


def pinned_built(module, name, run):
    """Runs run() with `module`.`name` (a pinned builder as an entry point
    imported it) keeping each pinned function it builds; returns them, so
    that their graphs' replayed launches can be read."""
    builder, built = getattr(module, name), []

    def keeping(*args, **kwargs):
        fn = builder(*args, **kwargs)
        built.append(fn)
        return fn

    setattr(module, name, keeping)
    try:
        run()
    finally:
        setattr(module, name, builder)
    return built


def eager_eval_fps(torch, np, cfg, params, cache, records, batch, imread):
    """`evaluate`'s timing loop (host clock around a request and the
    read-back of its detections, the first request left out, a batch's
    time divided by its size) on the eager builders that `evaluate` ran to
    PR 11: the eager images/s beside the pinned `fps`."""
    from faster_orefsdet_tpu_torch.data.loader import eval_canvas, eval_loader
    from faster_orefsdet_tpu_torch.pipelines.inference import build_batched_inference_fn, build_inference_fn

    items = list(eval_loader(records, cfg, eval_canvas(records, cfg), raw_uint8=batch > 1, imread=imread))
    if batch > 1:
        infer = build_batched_inference_fn(cfg, params)
        requests = []
        for i in range(0, len(items), batch):
            buf = items[i:i + batch]
            buf += [buf[0]] * (batch - len(buf))
            canvases = torch.stack([b[1] for b in buf])
            hws = torch.tensor([list(b[2]) for b in buf], dtype=torch.float32)
            requests.append(lambda c=canvases, h=hws: infer(cache, c, h))
    else:
        infer = build_inference_fn(cfg, params)
        requests = [lambda c=canvas, h=hw: infer(cache, c, h) for _, canvas, hw, _ in items]
    times = []
    for request in requests:
        t0 = time.perf_counter()
        det = request()
        _ = [getattr(det, f).cpu().numpy() for f in ("boxes", "scores", "valid")]
        times.append((time.perf_counter() - t0) / batch)
    return 1.0 / float(np.mean(times[1:]))


def phase_eval(torch, np, cfg, params, smi):
    """evaluate on synthetic frames at batch 1 and 8 (frames and support
    crops held in memory, read through `imread`) through its pinned
    function: one signature captured (its warm-ups and both captures
    counted), every request a replay; its fps beside the eager builders' on
    the same loop."""
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.pipelines import evaluate as evaluate_module
    from faster_orefsdet_tpu_torch.pipelines.evaluate import encode_support_set, evaluate
    from faster_orefsdet_tpu_torch.pipelines.graphs import CAPTURES, WARMUP_CALLS

    records, entries, store = eval_data(np, cfg, EVAL_FRAMES, EVAL_SHOTS)
    cache = encode_support_set(cfg, params, entries, shot=EVAL_SHOTS, imread=store.get)
    for bs in (1, 8):
        res = {}
        built = []
        counted = count_launches(cgm_cuda, nms_cuda, lambda: built.extend(pinned_built(
            evaluate_module, "build_pinned_inference_fn",
            lambda: res.update(evaluate(cfg, params, cache, records, batch_size=bs, imread=store.get)))))
        requests = -(-len(records) // bs)
        replayed = built[0].kernel_launches()
        graphs = [g.launches for g in built[0].graphs.values()]
        eager_fps = eager_eval_fps(torch, np, cfg, params, cache, records, bs, store.get)
        emit(eval={"batch": bs, "frames": len(records), **res, "eager_fps": eager_fps,
                   "pinned_fps_over_eager": res["fps"] / eager_fps, "graphs_captured_launches": graphs,
                   "counted_launches": counted, "replayed_launches": replayed, "card": smi,
                   "note": "random weights: the AP values check the loop, not the detector"})
        if not all(np.isfinite(res[k]) for k in AP_KEYS):
            raise AssertionError(f"eval at batch {bs}: an AP value is not finite")
        if (len(built) != 1 or graphs != [kernels(3, 2, 1)] or replayed != kernels(3 * requests, 2 * requests, requests)
                or counted != kernels(3 * (WARMUP_CALLS + CAPTURES), 2 * (WARMUP_CALLS + CAPTURES),
                                      WARMUP_CALLS + CAPTURES)):
            raise AssertionError(f"eval at batch {bs}: not one graph replayed a request ({graphs}, counted {counted}, "
                                 f"replayed {replayed})")


def train_rois(torch, np, batch, n: int, seed: int):
    """A fixed ROI set [1, n, 4] for the first image of `batch`: its valid gt
    boxes, jittered copies of them, and random boxes inside the image."""
    rng = np.random.default_rng(seed)
    gt = batch.gt_boxes[0][batch.gt_valid[0]].cpu().numpy()
    h, w = batch.image_hw[0].tolist()
    jit = np.repeat(gt, 4, axis=0) + rng.uniform(-8, 8, (4 * len(gt), 4))
    xy = rng.uniform(0, [w - 40, h - 40], (n, 2))
    rand = np.concatenate([xy, xy + rng.uniform(16, 160, (n, 2))], 1)
    rois = np.concatenate([gt, jit, rand])[:n]
    rois[:, 0::2] = rois[:, 0::2].clip(0, w)
    rois[:, 1::2] = rois[:, 1::2].clip(0, h)
    rois[:, 2:] = np.maximum(rois[:, 2:], rois[:, :2] + 4)
    return torch.from_numpy(rois.astype(np.float32))[None], torch.ones(1, n, dtype=torch.bool)


def eager_steps(torch, np, cfg, params, records, mapper, n_warmup: int, n_steps: int):
    """n_warmup + n_steps build_train_step steps from init weights, fed by
    train_loader, with the kernels' launches counted: (state, step, step ms
    after the warm-up (host clock, each step ending in a sync), the metrics
    rows, the batches, the launches, peak GB)."""
    from faster_orefsdet_tpu_torch.data.loader import train_loader
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_state, build_train_step
    from faster_orefsdet_tpu_torch.utils.events import drain_device_metrics

    state, step = build_train_state(cfg, params), build_train_step(cfg)
    times, window, batches = [], [], []
    loader = train_loader(records, mapper, cfg.solver.ims_per_batch, seed=0)
    try:
        def run():
            for i in range(n_warmup + n_steps):
                batch = next(loader)
                batches.append(batch)
                torch.cuda.synchronize()
                t = time.perf_counter()
                window.append((i, step(state, batch)))
                torch.cuda.synchronize()
                if i >= n_warmup:
                    times.append((time.perf_counter() - t) * 1e3)

        torch.cuda.reset_peak_memory_stats()
        launches = count_launches(cgm_cuda, nms_cuda, run)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        loader.close()
    rows = [m for _, m in drain_device_metrics(window)]
    return state, step, times, rows, batches, launches, peak


def train_nms_site(torch, cfg, state, batch):
    """The NMS kernel bit for bit on the [1, TRAIN_NMS_K] set that a step's
    decode gives it, and its device time there: (checks, max |err|, site)."""
    from faster_orefsdet_tpu_torch.ops import nms_cuda
    from faster_orefsdet_tpu_torch.ops.nms import nms_mask as nms_plain
    from faster_orefsdet_tpu_torch.pipelines.train_step import loss_fn

    with torch.no_grad():
        checks, nms_err, seen = nms_checks_on_request(torch, lambda: loss_fn(state.model, batch, state.generator))
    thr = cfg.centernet.nms_thresh_train
    if ([c["shape"] for c in checks if c["site"] == "kernel"] != [[1, TRAIN_NMS_K]] or seen["batched"]
            or any(c["thr"] != thr or c["mismatches"] for c in checks)):
        raise AssertionError(f"the NMS kernel on {cfg.backbone_name}'s training decode inputs: {checks}")
    boxes, scores, valid = seen["kernel"][0][:3]
    n_valid = int(valid.sum())
    # the work this data needs: IoU per pair of valid boxes, rank compares over the set
    site = {"shape": [1, TRAIN_NMS_K], "thr": thr, "valid": n_valid,
            "ms": graph_ms(torch, lambda: nms_cuda.nms_mask(boxes, scores, valid, thr)),
            "plain_ms": enqueue_ms(torch, lambda: nms_plain(boxes, scores, valid, thr), 10),  # syncs: no graph
            **bound(TRAIN_NMS_K * (16 + 4 + 1 + 1), n_valid * (n_valid - 1) // 2 * 13 + TRAIN_NMS_K ** 2 * 3),
            "inputs": "the training decode's own"}
    return checks, nms_err, site


def phase_train(torch, np, smi):
    """Fine-tuning of finetune_vovnet at full width: synthetic VGA frames
    (in memory) through the mapper and train_loader, TRAIN_WARMUP +
    TRAIN_STEPS train steps from init_params with the launches counted; the
    NMS kernel on the training decode's own inputs; one step card vs CPU;
    the loss on a fixed batch at a constant LR; a profile of the step."""
    from faster_orefsdet_tpu_torch.config import get_config
    from faster_orefsdet_tpu_torch.pipelines.train_step import (
        build_train_state, build_train_step, loss_fn, make_train_model,
    )
    from faster_orefsdet_tpu_torch.utils.params import init_params

    cfg = get_config(TRAIN_CONFIG)
    t_phase = t0 = time.perf_counter()
    records, mapper = train_data(cfg)
    setup_s = time.perf_counter() - t0
    params = init_params(cfg, seed=0)
    torch.backends.cudnn.allow_tf32 = True  # the library defaults, as phase 11 serves
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    # ---- steps, with the kernels' launches counted
    state, step, times, rows, batches, launches, peak = eager_steps(torch, np, cfg, params, records, mapper,
                                                                    TRAIN_WARMUP, TRAIN_STEPS)
    n_steps = len(rows)
    finite = all(np.isfinite(v) for m in rows for v in m.values())
    med = statistics.median(times)
    batch = batches[0]
    emit(train={"config": TRAIN_CONFIG, "canvas": list(TRAIN_CANVAS), "frames": list(FRAME_HW),
                "shots": cfg.fs.support_shot,
                "rois": cfg.roi.batch_size_per_image, "steps": n_steps, "warmup_steps": TRAIN_WARMUP,
                "step_ms_median": med, "step_ms_min": min(times), "step_ms_max": max(times),
                "queries_per_s": 1e3 * cfg.solver.ims_per_batch / med, "peak_mem_gb": peak, "launches": launches,
                "launches_per_step": {k: v / n_steps for k, v in launches.items()},
                "total_loss_trace": [m["total_loss"] for m in rows], "all_finite": finite,
                "data_setup_s": setup_s, "card": smi})
    if not finite:
        raise AssertionError(f"a train step gave a non-finite loss: {rows}")
    if launches != kernels(0, n_steps):
        raise AssertionError(f"kernel launches {launches} over {n_steps} train steps (expected 0 CGM, 1 NMS a step)")
    out.update(launches=launches, steps=n_steps, step_ms=med)

    # ---- the NMS kernel on the training decode's own inputs
    checks, nms_err, site = train_nms_site(torch, cfg, state, batch)
    site["launches_per_step"] = launches["nms"] / n_steps
    emit(train_nms=dict(checks=checks, **site, card=smi))
    out.update(nms_err=nms_err, nms_mismatches=sum(c["mismatches"] for c in checks), nms_site=site)

    # ---- one step card vs CPU: same weights, batch and ROIs, no dropout, f32 without TF32
    rois = train_rois(torch, np, batch, cfg.roi.batch_size_per_image, seed=13)

    def step_on(dev, dtype):
        model = make_train_model(cfg, params, device=dev).to(dtype)
        total, losses = loss_fn(model, batch.to(dev), deterministic=True, injected_rois=tuple(r.to(dev) for r in rois))
        total.backward()
        return model, losses

    train_card_vs_cpu(torch, step_on, "train_card_vs_cpu")

    # ---- learning: a fixed batch, no warmup, a constant LR
    lcfg = cfg.replace(solver=dataclasses.replace(cfg.solver, warmup_iters=0, steps=(), base_lr=LEARN_LR))
    lstate, lstep = build_train_state(lcfg, params), build_train_step(lcfg)
    trace, fixed_ms = [], []
    for _ in range(LEARN_STEPS):  # timed as above: without the loader's thread at work
        torch.cuda.synchronize()
        t = time.perf_counter()
        trace.append(lstep(lstate, batch)["total_loss"])
        torch.cuda.synchronize()
        fixed_ms.append((time.perf_counter() - t) * 1e3)
    trace = torch.stack(trace).tolist()
    late = statistics.mean(trace[-LEARN_WINDOW:])
    falls = late <= LEARN_RATIO * trace[0]
    emit(train_learning={"steps": LEARN_STEPS, "lr": LEARN_LR, "trace": trace, "last_mean": late,
                         "threshold": f"mean of the last {LEARN_WINDOW} <= {LEARN_RATIO} x the first", "falls": falls,
                         "fixed_batch_step_ms_median": statistics.median(fixed_ms[TRAIN_WARMUP:]), "card": smi})
    if not falls:
        raise AssertionError(f"the loss did not fall on a fixed batch: {trace}")

    # ---- where a step's time goes
    prof = profile_requests(torch, lambda: step(state, batch), med, stages=TRAIN_STAGES)
    emit(profile={"path": "train", "batch": cfg.solver.ims_per_batch, **prof, "card": smi})
    emit(train_phase_s=time.perf_counter() - t_phase)
    return out


def train_card_vs_cpu(torch, step_on, key: str, zero_grad=(), witness: bool = False) -> dict:
    """One step card vs CPU, TF32 off: step_on(device, dtype) -> (model
    after backward, {loss: scalar}). Each loss within TRAIN_LOSS_RTOL
    relative, each gradient within TRAIN_GRAD_TOL of its tensor's largest
    |grad|. A gradient that is 0 by construction (a bias that a softmax or a
    mean cancels, named in `zero_grad`) is measured against the largest
    |grad| of its layer's weight instead. witness=True: a quantity beyond its
    tolerance is held instead at DLA_F32_FACTOR x the CPU's own f32 against
    its f64 (phase 15's witness), where that is larger: a deep random
    ResNet's gradients are sums that cancel, and f32 rounding alone moves
    them on any device."""

    def run(dev, dtype):
        model, losses = step_on(dev, dtype)
        return {**{f"loss/{k}": v.detach().double().cpu() for k, v in losses.items()},
                **{f"grad/{n}": p.grad.double().cpu() for n, p in model.named_parameters() if p.requires_grad}}

    def errs(a, b):
        out = {}
        for k, ref in b.items():
            scale = b[k[:-len("bias")] + "weight"] if k[len("grad/"):] in zero_grad else ref
            out[k] = float((a[k] - ref).abs().max()) / max(float(scale.abs().max()), 1e-30)
        return out

    torch.backends.cudnn.allow_tf32 = False
    try:
        card, cpu = run("cuda", torch.float32), run("cpu", torch.float32)
        e32 = errs(card, cpu)
        limit = {k: TRAIN_LOSS_RTOL if k.startswith("loss/") else TRAIN_GRAD_TOL for k in e32}
        beyond = [k for k in e32 if e32[k] > limit[k]]
        res = {}
        if witness and beyond:
            w = errs(cpu, run("cpu", torch.float64))
            limit.update({k: max(limit[k], DLA_F32_FACTOR * w[k]) for k in beyond})
            res["beyond_tol"] = [[k, e32[k], w[k], limit[k]] for k in sorted(beyond, key=lambda k: -e32[k])[:12]]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    worst_loss = max((k for k in e32 if k.startswith("loss/")), key=e32.get)
    worst_grad = max((k for k in e32 if k.startswith("grad/")), key=e32.get)
    res.update({"losses_cuda": {k[5:]: float(v) for k, v in card.items() if k.startswith("loss/")},
                "losses_cpu": {k[5:]: float(v) for k, v in cpu.items() if k.startswith("loss/")},
                "worst_loss_rel_err": e32[worst_loss], "worst_grad_err_of_largest": e32[worst_grad],
                "worst_grad_tensor": worst_grad[5:], "tensors": sum(k.startswith("grad/") for k in e32),
                "rtol": TRAIN_LOSS_RTOL, "grad_tol": TRAIN_GRAD_TOL, "beyond_tol_count": len(beyond),
                "worst_share_of_limit": max(e32[k] / limit[k] for k in e32)})
    emit(**{key: res})
    if res["worst_share_of_limit"] > 1.0:
        raise AssertionError(f"{key}: {res}")
    return res


def train_data(cfg, seed: int = 7):
    """TRAIN_FRAMES synthetic VGA frames in memory, grouped per class, and
    the episodic mapper onto their training canvas."""
    from faster_orefsdet_tpu_torch.data.coco import split_per_class
    from faster_orefsdet_tpu_torch.data.loader import train_canvas
    from faster_orefsdet_tpu_torch.data.mapper import EpisodicMapper, SupportSampler
    from faster_orefsdet_tpu_torch.data.synthetic import make_synthetic_setup

    records, entries, imread = make_synthetic_setup(TRAIN_FRAMES, seed=seed, image_hw=FRAME_HW, root="train")
    records = split_per_class(records)
    canvas = train_canvas(records, cfg)
    if canvas != TRAIN_CANVAS:
        raise AssertionError(f"training canvas {canvas}, expected {TRAIN_CANVAS}")
    return records, EpisodicMapper(cfg, SupportSampler(entries), canvas_hw=canvas, imread=imread)


def take_batches(records, mapper, n: int, seed: int):
    from faster_orefsdet_tpu_torch.data.loader import train_loader

    loader = train_loader(records, mapper, 1, seed=seed)
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def run_eager(torch, cfg, params, batches):
    """build_train_step over the batches from a fresh state: (state, {metric: [n]})."""
    from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_state, build_train_step

    state, step = build_train_state(cfg, params), build_train_step(cfg)
    rows = [step(state, b) for b in batches]
    return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def run_graphed(torch, cfg, params, batches, chunks):
    """build_train_step_scan over the batches in chunks of the given sizes
    from a fresh state: (state, step_k, {metric: [n]})."""
    from faster_orefsdet_tpu_torch.pipelines.train_step import (
        build_train_state, build_train_step_scan, run_scan_chunk,
    )

    state, step_k = build_train_state(cfg, params), build_train_step_scan(cfg)
    it = iter(batches)
    out = [run_scan_chunk(step_k, state, it, kk) for kk in chunks]
    return state, step_k, {k: torch.cat([o[k] for o in out]) for k in out[0]}


def rel_err(x, ref) -> float:
    """The worst |x - ref| over the largest |ref| (a scalar's relative error)."""
    scale = float(ref.abs().max())
    diff = float((x - ref).abs().max())
    return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))


def compare_runs(torch, a, ma, b, mb) -> dict:
    """Two runs' per-step metrics and final states (the model's weights and
    running statistics, the momentum buffers, the generator): bit identity,
    and the worst |diff| of a tensor over its largest |value|."""
    pairs = list(zip(a.model.state_dict().values(), b.model.state_dict().values()))
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        pairs += [(a.optimizer.state[p]["momentum_buffer"], b.optimizer.state[q]["momentum_buffer"])
                  for p, q in zip(ga["params"], gb["params"])]
    worst = max(rel_err(y, x) for x, y in pairs)
    by_step = torch.stack([(ma[k] - mb[k]).abs() / ma[k].abs().clamp(min=1e-30) for k in ma]).amax(0)
    return {"steps": int(ma["total_loss"].numel()), "losses_bit_identical": all(torch.equal(ma[k], mb[k]) for k in ma),
            "worst_loss_rel_err": float(by_step.max()), "loss_rel_err_by_step": by_step.tolist(), "tensors": len(pairs),
            "tensors_bit_identical": all(torch.equal(x, y) for x, y in pairs), "worst_tensor_err_of_largest": worst,
            "generator_equal": torch.equal(a.generator.get_state(), b.generator.get_state()),
            "steps_taken": [a.step, b.step]}


def graphed_vs_eager(torch, cfg, params, batches, chunks, deterministic: bool) -> dict:
    """Eager steps against the K-step function's warm-up steps and replays on
    the same batches from the same state. Under cudnn.deterministic (no
    atomics-based convolution algorithms) the same kernels on the same
    inputs must give the same bits: every loss, weight, running statistic
    and momentum buffer. Under the library's default, cuDNN may pick
    backward algorithms that sum with atomics, so eager runs differ already:
    graphed vs eager must then stay within DEFAULTS_FACTOR x the largest
    difference between EAGER_RUNS eager runs, in the worst loss and in the
    worst tensor (the worst of a diverging run is one noisy draw, so the
    spread is taken over several pairs)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        e_state, e_m = run_eager(torch, cfg, params, batches)
        g_state, step_k, g_m = run_graphed(torch, cfg, params, batches, chunks)
        others = [] if deterministic else [run_eager(torch, cfg, params, batches) for _ in range(EAGER_RUNS - 1)]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    res = compare_runs(torch, e_state, e_m, g_state, g_m)
    res.update(cudnn_deterministic=deterministic, chunks=list(chunks), launches=step_k.kernel_launches(),
               graphs={str(k[0][0]): {"captured_launches": g.launches, "replays": g.replays}
                       for k, g in step_k.graphs.items()})
    if deterministic:
        within = res["losses_bit_identical"] and res["tensors_bit_identical"]
    else:
        keys = ("worst_loss_rel_err", "worst_tensor_err_of_largest")
        pairs = [compare_runs(torch, *a, *b) for a, b in itertools.combinations([(e_state, e_m), *others], 2)]
        res["eager_vs_eager"] = {k: [p[k] for p in pairs] for k in keys}
        spread = {k: max(p[k] for p in pairs) for k in keys}
        res["graphed_share_of_eager_spread"] = {
            k: res[k] / spread[k] if spread[k] > 0 else (0.0 if res[k] == 0 else float("inf")) for k in keys}
        within = all(v <= DEFAULTS_FACTOR for v in res["graphed_share_of_eager_spread"].values())
    finite = all(bool(torch.isfinite(v).all()) for v in g_m.values())
    res["ok"] = bool(res["generator_equal"] and res["steps_taken"][0] == res["steps_taken"][1] == len(batches)
                     and finite and within and res["launches"] == kernels(0, len(batches)))
    return res


def chunk_times(torch, step_k, state, loader, n_chunks: int):
    """n chunks of GRAPH_K steps: each chunk's wall ms over K with its
    batches pulled before the clock starts, and with the pulls inside."""
    from faster_orefsdet_tpu_torch.pipelines.train_step import run_scan_chunk

    step_ms, with_loader_ms = [], []
    for i in range(2 * n_chunks):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i % 2:  # the loader inside the window
            run_scan_chunk(step_k, state, loader, GRAPH_K)
        else:
            batches = [next(loader) for _ in range(GRAPH_K)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_k(state, batches)
        torch.cuda.synchronize()
        (with_loader_ms if i % 2 else step_ms).append((time.perf_counter() - t) * 1e3 / GRAPH_K)
    return step_ms, with_loader_ms


def phase_train_graphed(torch, np, smi, eager_ms: float):
    """finetune_vovnet K steps per call: graphed against eager on stored
    batches (deterministic and default cuDNN), then the graphed step's time,
    launches and profile beside phase 13's eager step, and the loader's own
    rate."""
    from faster_orefsdet_tpu_torch.config import get_config
    from faster_orefsdet_tpu_torch.data.loader import train_loader
    from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_state, build_train_step_scan
    from faster_orefsdet_tpu_torch.utils.params import init_params

    cfg = get_config(TRAIN_CONFIG)
    t_phase = time.perf_counter()
    records, mapper = train_data(cfg)
    params = init_params(cfg, seed=0)
    batches = take_batches(records, mapper, sum(GRAPH_EQ_CHUNKS), seed=3)
    checks = [graphed_vs_eager(torch, cfg, params, batches, GRAPH_EQ_CHUNKS, det) for det in (True, False)]
    for c in checks:
        emit(train_graphed_vs_eager={"config": TRAIN_CONFIG, **c, "card": smi})
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"graphed train steps differ from eager ones: {checks}")

    # ---- time: 2 warm-up steps, the capture, then chunks of K fed by train_loader
    state, step_k = build_train_state(cfg, params), build_train_step_scan(cfg)
    loader = train_loader(records, mapper, cfg.solver.ims_per_batch, seed=0)
    try:
        step_k(state, [next(loader) for _ in range(GRAPH_K)])  # warm-up steps, capture, replays
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = step_k.kernel_launches()
        step_ms, with_loader_ms = chunk_times(torch, step_k, state, loader, GRAPH_TIMED_CHUNKS)
        after = step_k.kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        fixed = [next(loader) for _ in range(GRAPH_K)]
        for _ in range(4):  # the loader alone: drain what it holds, then time it
            next(loader)
        t = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(loader)
        loader_bps = LOADER_BATCHES / (time.perf_counter() - t)
    finally:
        loader.close()
    n = 2 * GRAPH_TIMED_CHUNKS * GRAPH_K
    launches = {k: after[k] - before[k] for k in after}
    med = statistics.median(step_ms)
    prof = profile_requests(torch, lambda: step_k(state, fixed), med * GRAPH_K, stages=())
    per_step = {"device_busy_ms": prof["device_busy_ms"] / GRAPH_K, "idle_share": prof["idle_share"],
                "kernel_events": prof["kernel_launches_per_request"] / GRAPH_K,
                "own_kernel_ms_and_launches": {k: [v[0] / GRAPH_K, v[1] / GRAPH_K]
                                               for k, v in prof["own_kernel_ms_and_launches_per_request"].items()}}
    emit(train_graphed={"config": TRAIN_CONFIG, "k": GRAPH_K, "steps": n, "step_ms_median": med,
                        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
                        "queries_per_s": 1e3 * cfg.solver.ims_per_batch / med,
                        "step_ms_median_with_loader": statistics.median(with_loader_ms),
                        "eager_step_ms_median_phase13": eager_ms, "speedup_over_eager": eager_ms / med,
                        "loader_alone_batches_per_s": loader_bps, "peak_mem_gb": peak, "launches": launches,
                        "launches_per_step": {k: v / n for k, v in launches.items()},
                        "graphs": {str(k[0][0]): {"captured_launches": g.launches, "replays": g.replays}
                                   for k, g in step_k.graphs.items()},
                        "profile_per_step": per_step, "top_kernels_ms_per_chunk": prof["top_kernels_ms"][:6],
                        "card": smi})
    if launches != kernels(0, n):
        raise AssertionError(f"graphed steps launched {launches} over {n} steps (expected 0 CGM, 1 NMS a step)")
    emit(train_graphed_phase_s=time.perf_counter() - t_phase)
    return {"launches": {k: checks[0]["launches"][k] + checks[1]["launches"][k] + launches[k] for k in launches},
            "step_ms": med}


def dla_step_outputs(torch, cfg, params, batch, rois, dtype, dev) -> dict:
    """One finetune_dla loss and backward in `dtype` on `dev` (no dropout,
    the given ROIs): {"loss/<name>", "grad/<parameter>", "stat/<buffer>"
    (the updated running statistics): CPU tensor}."""
    from faster_orefsdet_tpu_torch.pipelines.train_step import loss_fn, make_train_model
    from faster_orefsdet_tpu_torch.utils.params import is_batch_stat

    model = make_train_model(cfg, params, device=dev).to(dtype)
    total, losses = loss_fn(model, batch.to(dev), deterministic=True,
                            injected_rois=tuple(t.to(dev) for t in rois))
    total.backward()
    return {**{f"loss/{k}": v.detach().cpu() for k, v in losses.items()},
            **{f"grad/{n}": p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
            **{f"stat/{k}": v.cpu() for k, v in model.state_dict().items() if is_batch_stat(k)}}


def dla_card_vs_cpu(torch, cfg, params, batch, rois) -> dict:
    """One finetune_dla step on the card and on the CPU from the same
    weights, batch and ROIs, TF32 off, in f64 and in f32; each loss,
    gradient and updated running statistic as its tensor's worst |diff|
    over its largest |value| (rel_err).

    A random DLA in batch-statistics mode amplifies rounding: BatchNorm over
    few positions at the deep levels, and fusion weights whose gradient is a
    sum that cancels to near 0. So the f64 run is held at DLA_TOL, and the
    CPU's own f32 against its f64 (the witness) measures what f32 rounding
    alone does to each quantity: the card's f32 is held against the CPU's
    f32 at DLA_TOL, or DLA_F32_FACTOR x the witness where that is larger."""
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = {(dtype, dev): dla_step_outputs(torch, cfg, params, batch, rois, dtype, dev)
               for dtype in (torch.float64, torch.float32) for dev in ("cuda", "cpu")}
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    f64, f32 = torch.float64, torch.float32
    names = list(got[f64, "cpu"])
    if any(list(v) != names for v in got.values()):
        raise AssertionError("finetune_dla card vs CPU: the runs give different sets of tensors")

    def errs(a, b):
        return {k: rel_err(got[a][k].double(), got[b][k].double()) for k in names}

    e64, e32 = errs((f64, "cuda"), (f64, "cpu")), errs((f32, "cuda"), (f32, "cpu"))
    witness, card_truth = errs((f32, "cpu"), (f64, "cpu")), errs((f32, "cuda"), (f64, "cpu"))
    limit32 = {k: max(DLA_TOL, DLA_F32_FACTOR * witness[k]) for k in names}
    out = {"limit": DLA_TOL, "f32_factor_of_witness": DLA_F32_FACTOR,
           "counts": {kind: sum(k.startswith(kind + "/") for k in names) for kind in ("loss", "grad", "stat")}}
    for kind in ("loss", "grad", "stat"):
        keys = [k for k in names if k.startswith(kind + "/")]
        for label, e in (("f64", e64), ("f32", e32), ("f32_cpu_vs_f64_cpu", witness), ("f32_card_vs_f64_cpu",
                                                                                        card_truth)):
            worst = max(keys, key=e.get)
            out[f"{kind}_worst_{label}"] = [e[worst], worst]
    # the quantities that f32 rounding moves beyond DLA_TOL: card vs CPU in
    # f32, the witness, the card's f32 against the CPU's f64, and the limit
    loose = sorted((k for k in names if max(e32[k], witness[k]) > DLA_TOL), key=lambda k: -e32[k])
    out["f32_beyond_tol"] = [[k, e32[k], witness[k], card_truth[k], limit32[k]] for k in loose[:12]]
    out["f32_beyond_tol_count"] = len(loose)
    out["f32_worst_share_of_limit"] = max(e32[k] / limit32[k] for k in names)
    out["ok"] = bool(max(e64.values()) <= DLA_TOL and all(e32[k] <= limit32[k] for k in names))
    return out


def phase_dla(torch, np, smi):
    """finetune_dla at full width: eager steps with the launches counted and
    the BatchNorm statistics moving, K2 on a step's own decode set, one step
    card vs CPU, graphed against eager, evaluation with K2 held at both
    serving sites, and the eager and graphed step times."""
    from faster_orefsdet_tpu_torch.config import get_config
    from faster_orefsdet_tpu_torch.data.loader import train_loader
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.ops.nms import nms_mask as nms_plain
    from faster_orefsdet_tpu_torch.pipelines import evaluate as evaluate_module
    from faster_orefsdet_tpu_torch.pipelines.evaluate import encode_support_set, evaluate
    from faster_orefsdet_tpu_torch.pipelines.graphs import CAPTURES, WARMUP_CALLS
    from faster_orefsdet_tpu_torch.pipelines.inference import build_inference_fn
    from faster_orefsdet_tpu_torch.pipelines.preprocess import preprocess_host
    from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_step_scan
    from faster_orefsdet_tpu_torch.utils.params import init_params, is_batch_stat

    cfg = get_config(DLA_CONFIG)
    t_phase = time.perf_counter()
    records, mapper = train_data(cfg)
    params = init_params(cfg, seed=0)
    out = {}

    # ---- eager steps, launches counted
    state, step, times, rows, batches, launches, peak = eager_steps(torch, np, cfg, params, records, mapper,
                                                                    DLA_WARMUP, DLA_STEPS)
    n_steps = len(rows)
    finite = all(np.isfinite(v) for m in rows for v in m.values())
    stats = {k: v for k, v in state.model.state_dict().items() if is_batch_stat(k)}
    moved = sum(not torch.equal(v.cpu(), params[k]) for k, v in stats.items())
    stats_finite = all(bool(torch.isfinite(v).all()) for v in stats.values())
    eager_ms = statistics.median(times)
    emit(dla_train={"config": DLA_CONFIG, "canvas": list(TRAIN_CANVAS), "shots": cfg.fs.support_shot,
                    "fpn_channels": cfg.fpn.out_channels, "bifpn_repeats": cfg.fpn.bifpn_repeats,
                    "pooler": cfg.roi.pooler_resolution, "steps": n_steps, "warmup_steps": DLA_WARMUP,
                    "step_ms_median": eager_ms, "step_ms_min": min(times), "step_ms_max": max(times),
                    "queries_per_s": 1e3 / eager_ms, "peak_mem_gb": peak, "launches": launches,
                    "total_loss_trace": [m["total_loss"] for m in rows], "all_finite": finite,
                    "bn_statistics": len(stats), "bn_statistics_moved": moved, "bn_statistics_finite": stats_finite,
                    "card": smi})
    if not finite or moved != len(stats) or not stats_finite or not stats:
        raise AssertionError(f"finetune_dla steps: finite {finite}, statistics moved {moved}/{len(stats)}")
    if launches != kernels(0, n_steps):
        raise AssertionError(f"finetune_dla launches {launches} over {n_steps} steps (expected 0 CGM, 1 NMS a step)")
    batch = batches[0]

    # ---- K2 on the training decode's own set
    checks, nms_err, train_site = train_nms_site(torch, cfg, state, batch)
    train_site["launches_per_step"] = launches["nms"] / n_steps
    emit(dla_train_nms=dict(checks=checks, **train_site, card=smi))

    # ---- one step card vs CPU
    rois, roi_valid = train_rois(torch, np, batch, cfg.roi.batch_size_per_image, seed=13)
    card_vs_cpu = dla_card_vs_cpu(torch, cfg, params, batch, (rois, roi_valid))
    emit(dla_card_vs_cpu={**card_vs_cpu, "card": smi})
    if not card_vs_cpu["ok"]:
        raise AssertionError(f"finetune_dla card vs CPU: {card_vs_cpu}")

    # ---- graphed against eager, the BatchNorm statistics included
    eq = graphed_vs_eager(torch, cfg, params, batches[:sum(DLA_EQ_CHUNKS)], DLA_EQ_CHUNKS, deterministic=True)
    emit(dla_graphed_vs_eager={**eq, "card": smi})
    if not eq["ok"]:
        raise AssertionError(f"finetune_dla graphed steps differ from eager ones: {eq}")

    # ---- evaluation with the trained state (running statistics) in eval mode
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    erecords, entries, store = eval_data(np, cfg, DLA_EVAL_FRAMES, DLA_EVAL_FRAMES, seed=6)
    cache = encode_support_set(cfg, sd, entries, shot=DLA_EVAL_FRAMES, imread=store.get)
    res, built = {}, []
    counted = count_launches(cgm_cuda, nms_cuda, lambda: built.extend(pinned_built(
        evaluate_module, "build_pinned_inference_fn",
        lambda: res.update(evaluate(cfg, sd, cache, erecords, batch_size=1, imread=store.get)))))
    eval_launches = built[0].kernel_launches()  # evaluate replays one pinned graph
    infer = build_inference_fn(cfg, sd)
    inp = cfg.input
    canvas, hw, _ = preprocess_host(store["frame0"], inp.min_size_test, inp.max_size_test, CANVAS_HW,
                                    inp.pixel_mean, inp.pixel_std)
    canvas = canvas.cuda()
    serve_checks, serve_err, serve_seen = nms_checks_on_request(torch, lambda: infer(cache, canvas, hw))
    dboxes, dscores, dvalid = serve_seen["kernel"][0][:3]
    k_dec, thr_dec = cfg.static.nms_budget_test, cfg.centernet.nms_thresh_test
    n_valid = int(dvalid.sum())
    serve_site = {"shape": [1, k_dec], "thr": thr_dec, "valid": n_valid,
                  "ms": graph_ms(torch, lambda: nms_cuda.nms_mask(dboxes, dscores, dvalid, thr_dec)),
                  "plain_ms": enqueue_ms(torch, lambda: nms_plain(dboxes, dscores, dvalid, thr_dec), 10),
                  **bound(k_dec * 22, n_valid * (n_valid - 1) // 2 * 13 + k_dec ** 2 * 3)}
    emit(dla_eval={"frames": len(erecords), "shots": len(entries), **res, "launches": eval_launches,
                   "counted_launches": counted,
                   "nms_on_a_request": serve_checks, "decode_site": serve_site, "card": smi,
                   "note": "random weights: the AP values check the loop, not the detector"})
    sites = [(c["shape"], c["thr"]) for c in serve_checks if c["site"] == "kernel"]
    if not all(np.isfinite(res[k]) for k in AP_KEYS):
        raise AssertionError("finetune_dla eval: an AP value is not finite")
    if (eval_launches != kernels(0, 2 * len(erecords), len(erecords))
            or counted != kernels(0, 2 * (WARMUP_CALLS + CAPTURES), WARMUP_CALLS + CAPTURES)):
        raise AssertionError(f"finetune_dla eval launches {eval_launches}, counted {counted} (expected 0 CGM, "
                             "2 NMS an image replayed from one graph)")
    if sites != [([1, k_dec], thr_dec), ([1, cfg.centernet.post_nms_topk_test], cfg.roi.nms_thresh_test)] \
            or any(c["mismatches"] for c in serve_checks):
        raise AssertionError(f"the NMS kernel on a finetune_dla request's inputs: {serve_checks}")

    # ---- the graphed step's time beside the eager one
    step_k = build_train_step_scan(cfg)
    loader = train_loader(records, mapper, cfg.solver.ims_per_batch, seed=1)
    try:
        step_k(state, [next(loader) for _ in range(GRAPH_K)])
        before = step_k.kernel_launches()
        graphed_ms, _ = chunk_times(torch, step_k, state, loader, DLA_TIMED_CHUNKS)
        after = step_k.kernel_launches()
    finally:
        loader.close()
    g_launches = {k: after[k] - before[k] for k in after}
    g_med = statistics.median(graphed_ms)
    emit(dla_timing={"eager_step_ms_median": eager_ms, "graphed_step_ms_median": g_med,
                     "graphed_step_ms_min": min(graphed_ms), "graphed_step_ms_max": max(graphed_ms),
                     "speedup": eager_ms / g_med, "graphed_launches": g_launches, "card": smi})
    if g_launches != kernels(0, DLA_TIMED_CHUNKS * GRAPH_K * 2):
        raise AssertionError(f"finetune_dla graphed launches {g_launches}")
    emit(dla_phase_s=time.perf_counter() - t_phase)
    out.update(train_launches=launches, graphed_launches={k: eq["launches"][k] + g_launches[k] for k in g_launches},
               eval_launches=eval_launches, nms_err=max(nms_err, serve_err),
               nms_mismatches=sum(c["mismatches"] for c in checks + serve_checks), train_site=train_site,
               serve_site=serve_site)
    return out


# the reference's module path of each of the port's modules (the inverse of
# utils/torch_convert.convert_torch_checkpoint's renames)
_HEAD = "proposal_generator.centernet_head"
_REFERENCE_PATHS = (
    (r"backbone\.stem(\d)\.(conv|norm)", "backbone.bottom_up.stem.stem_{0}/{1}"),
    (r"backbone\.stage(\d)_block(\d+)\.layer(\d+)\.(conv|norm)",
     "backbone.bottom_up.stage{0}.OSA{0}_{b}.layers.{2}.OSA{0}_{b}_{2}/{3}"),
    (r"backbone\.stage(\d)_block(\d+)\.concat\.(conv|norm)",
     "backbone.bottom_up.stage{0}.OSA{0}_{b}.concat.OSA{0}_{b}_concat/{2}"),
    (r"backbone\.stage(\d)_block(\d+)\.ese\.fc", "backbone.bottom_up.stage{0}.OSA{0}_{b}.ese.fc"),
    (r"fpn\.(lateral|output)(\d)", "backbone.fpn_{0}{1}"),
    (r"head\.bbox_tower(\d+)", _HEAD + ".bbox_tower.{t0}"),
    (r"head\.bbox_tower(\d+)_gn", _HEAD + ".bbox_tower.{t1}"),
    (r"head\.(bbox_pred|agn_hm)", _HEAD + ".{0}"),
    (r"head\.scale(\d+)", _HEAD + ".scales.{0}"),
    (r"roi\.dsa_conv(\d)", "roi_heads.conv{0}"),
    (r"roi\.stage(\d+)_fc1", "roi_heads.box_head.{0}.fc1"),
    (r"roi\.stage(\d+)_cls", "roi_heads.box_predictor.{0}.cls_score"),
    (r"roi\.stage(\d+)_bbox", "roi_heads.box_predictor.{0}.bbox_pred"),
    (r"(vip_p\d)\.reweight_(fc\d)", "{0}.reweighting.{1}"),
    (r"(vip_p\d\.(?:mlp_h|mlp_w|proj))", "{0}"),
    (r"cgm_conv3", "conv3"),
)


def reference_checkpoint(torch, np, model_sd, seed: int) -> dict:
    """A seeded random checkpoint in the reference's key layout, for the
    port's VoVNet + FPN detector whose state_dict is `model_sd`: each of its
    modules under the reference's name and in the reference's form (FrozenBN
    as weight, bias, running mean and variance; the ROI head's and the CGM
    fusion's Linear layers as 1x1 convs). Weights N(0, 1/fan_in), norm
    scales near 1, the heatmap bias at a low prior and the box bias at 8
    strides, as init_params draws them."""
    import re

    g = np.random.default_rng(seed)

    def rand(shape, offset=0.0, std=None):
        std = std if std is not None else (1.0 / np.sqrt(np.prod(shape[1:])) if len(shape) > 1 else 0.1)
        return torch.from_numpy((offset + std * g.standard_normal(shape)).astype(np.float32))

    ref = {}
    for key, t in model_sd.items():
        module, leaf = key.rsplit(".", 1)
        shape = tuple(t.shape)
        for pattern, path in _REFERENCE_PATHS:
            m = re.fullmatch(pattern, module)
            if m:
                groups = m.groups()
                idx = {"b": int(groups[1]) + 1 if module.startswith("backbone.stage") else 0,
                       "t0": 3 * int(groups[0]) if module.startswith("head.bbox_tower") else 0,
                       "t1": 3 * int(groups[0]) + 1 if module.startswith("head.bbox_tower") else 0}
                path = path.format(*groups, **idx)
                break
        else:
            raise KeyError(f"no reference name for {key}")
        if module.endswith("norm"):  # FrozenBN, folded by the converter into scale and bias
            if leaf == "scale":
                ref[f"{path}.weight"], ref[f"{path}.bias"] = rand(shape, 1.0), rand(shape)
                ref[f"{path}.running_mean"] = rand(shape)
                ref[f"{path}.running_var"] = torch.from_numpy(g.uniform(0.5, 1.5, shape).astype(np.float32))
        elif module.endswith("_gn"):  # GroupNorm's affine
            ref[f"{path}.{'weight' if leaf == 'scale' else 'bias'}"] = rand(shape, 1.0 if leaf == "scale" else 0.0)
        elif module.startswith("head.scale"):
            ref[f"{path}.scale"] = torch.ones(shape)
        elif leaf == "weight" and re.fullmatch(r"roi\.dsa_conv\d|cgm_conv3", module):
            ref[f"{path}.weight"] = rand(shape)[:, :, None, None]
        elif key == "head.agn_hm.bias":
            ref[f"{path}.bias"] = rand(shape, -4.6)
        elif key == "head.bbox_pred.bias":
            ref[f"{path}.bias"] = rand(shape, 8.0)
        else:
            ref[f"{path}.{leaf}"] = rand(shape)
    return ref


class MemoryMedia:
    """The demo's readers and writers on frames held in memory: `store`
    {path: frame, or a list of frames for a video}; what the demo draws,
    writes and overlays is recorded in `draws`, `written` and `debugs`."""

    def __init__(self, np, store):
        self.np, self.store, self.draws, self.written, self.debugs = np, store, [], {}, []

    def media(self):
        import fnmatch

        from faster_orefsdet_tpu_torch.cli.demo import Media

        np, written = self.np, self.written

        class Sink(list):
            def __init__(self, path):
                super().__init__()
                written[path] = self

            def write(self, frame):
                self.append(frame)

            def release(self):
                pass

        def open_video(source):
            frames = self.store[source]
            return iter(frames), 25.0, frames[0].shape[:2]

        def draw(img, boxes, scores, thresh):
            self.draws.append({"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
                               "scores": np.asarray(scores, np.float64)})
            return img

        def debug(image, agn_hms, proposals, out_dir, **kw):
            self.debugs.append((image, agn_hms, proposals, kw))

        return Media(imread=self.store.get, imwrite=written.__setitem__,
                     glob=lambda pattern: sorted(fnmatch.filter(self.store, pattern)), open_video=open_video,
                     open_writer=lambda path, fps, size_wh: Sink(path), draw=draw, debug=debug)


def nms_tie_kept(np, d, other, nms_thresh):
    """Which detections of a frame's `d` the other device's `other` lacks
    although an NMS at `nms_thresh` decided them by a tie: no box of `other`
    matches one at IoU >= MATCH_IOU, and a higher-scored detection of `d`
    that `other` does match lies within NMS_TIE of the threshold from it,
    as does that detection's match in `other`, which the NMS there kept in
    its place."""
    b, s, ob = d["boxes"], d["scores"], other["boxes"]
    if not len(ob):
        return np.zeros(len(b), bool)
    cross = box_iou(np, b, ob)
    partner = cross.argmax(axis=1)  # each detection's best box on the other side
    matched = cross.max(axis=1) >= MATCH_IOU
    near = lambda iou: np.abs(iou - nms_thresh) <= NMS_TIE  # noqa: E731
    # [i, j]: detection j of d, higher-scored and matched, ties with i on both sides
    tie = (s[None, :] > s[:, None]) & matched[None, :] & near(box_iou(np, b, b)) & near(cross[:, partner])
    return ~matched & tie.any(axis=1)


def match_frames(np, got, ref, max_dscore, nms_thresh=None) -> dict:
    """Phase 5's criteria on each frame's detections (frame coordinates,
    valid ones only, as the demo draws them). Given the ROI NMS threshold,
    a detection that one side kept and the other suppressed by a tie at it
    (``nms_tie_kept``) is left out of both sides' counts and counted in
    `nms_ties`, of which NMS_TIES_MAX pass."""
    checks, ties = [], 0
    for g, r in zip(got, ref):
        keep = [np.ones(len(d["scores"]), bool) for d in (g, r)]
        if nms_thresh is not None and len(g["scores"]) != len(r["scores"]):
            keep = [~nms_tie_kept(np, g, r, nms_thresh), ~nms_tie_kept(np, r, g, nms_thresh)]
            ties += sum(int((~k).sum()) for k in keep)
        checks.append(match(np, {"boxes": g["boxes"], "scores": g["scores"], "valid": keep[0]},
                            {"boxes": r["boxes"], "scores": r["scores"], "valid": keep[1]}, max_dscore))
    return {"frames": [len(got), len(ref)],
            "all_matched": len(got) == len(ref) and all(c["ok"] for c in checks) and ties <= NMS_TIES_MAX,
            "max_dscore": max((c["max_dscore"] for c in checks), default=0.0),
            "matched": sum(c["matched"] for c in checks), "valid": sum(c["valid"][1] for c in checks),
            "nms_ties": ties}


def phase_workflow(torch, np, smi):
    """The user's single-card workflow at full width: a reference-layout
    .pth converted to the port's npz; support crops built from a COCO set;
    the demo by image glob, by video frame batches, by the async predictor
    and with --debug; visualize_features; finetune_dla with the fused CGM at
    160 channels. Card against CPU, and the kernels' launches per image."""
    import json
    import tempfile

    from faster_orefsdet_tpu_torch.cli import build_support, demo, visualize_features
    from faster_orefsdet_tpu_torch.config import apply_overrides, get_config
    from faster_orefsdet_tpu_torch.data.synthetic import generate_ore_dataset
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.pipelines.evaluate import encode_support_set
    from faster_orefsdet_tpu_torch.pipelines.graphs import CAPTURES, WARMUP_CALLS
    from faster_orefsdet_tpu_torch.data.coco import load_support_index
    from faster_orefsdet_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz
    from faster_orefsdet_tpu_torch.utils.params import init_params
    from faster_orefsdet_tpu_torch.utils.torch_convert import convert_torch_checkpoint, load_torch_pth

    t_phase = time.perf_counter()
    cfg = get_config(WORKFLOW_CONFIG)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the reference's checkpoint -> the port's params file
        model_sd = init_params(cfg, seed=0)
        pth, npz = os.path.join(tmp, "model_final.pth"), os.path.join(tmp, "model_final.npz")
        torch.save({"model": reference_checkpoint(torch, np, model_sd, seed=16)}, pth)
        sd = convert_torch_checkpoint(load_torch_pth(pth))
        save_params_npz(npz, sd)
        back = load_params_npz(npz)
        same = back.keys() == sd.keys() == model_sd.keys() and all(
            torch.equal(back[k], sd[k]) and sd[k].shape == model_sd[k].shape for k in sd)
        emit(workflow_weights={"tensors": len(sd), "npz_round_trip_equal": same})
        if not same:
            raise AssertionError("the converted checkpoint does not round-trip through the npz or miss keys")

        # ---- support crops from a COCO set held in memory
        images, coco = generate_ore_dataset(num_images=WORKFLOW_COCO_IMAGES, image_hw=FRAME_HW, seed=16)
        store = {os.path.join("coco", fn): img for fn, img in images.items()}
        with open(os.path.join(tmp, "instances.json"), "w") as f:
            json.dump(coco, f)
        entries, index = build_support.build_support(
            os.path.join(tmp, "instances.json"), "coco", os.path.join(tmp, "support"), cfg.fs.support_crop_size,
            imread=store.get, imwrite=store.__setitem__)
        emit(workflow_support={"annotations": len(coco["annotations"]), "crops": len(entries),
                               "shots_used": cfg.fs.support_shot})
        if len(entries) < cfg.fs.support_shot or load_support_index(index)[0].file_path not in store:
            raise AssertionError(f"build_support gave {len(entries)} crops")

        frames, _ = synthetic_frames(np, WORKFLOW_VIDEO, seed=17)
        store.update({f"frames/frame{i}.png": f for i, f in enumerate(frames[:WORKFLOW_GLOB])})
        store["clip"] = frames

        def run(argv, device="cuda", opts=()):
            media = MemoryMedia(np, store)
            args = demo.parse_args(argv + ["--support-index", index, "--params", npz, "--confidence", "0.0",
                                           "--config", WORKFLOW_CONFIG, "--device", device, "--output",
                                           os.path.join(tmp, "out"), *opts])
            launches = count_launches(cgm_cuda, nms_cuda, lambda: demo.run(args, media.media()))
            return media, launches

        glob_args = ["--input", "frames/*.png"]
        video_args = ["--video-input", "clip", "--frame-batch", str(WORKFLOW_FRAME_BATCH)]

        # ---- serving_vovnet as configured (bf16): the launches per image, then pinned vs eager
        g16, launches = run(glob_args)
        per_image = {k: v / WORKFLOW_GLOB for k, v in launches.items()}
        finite = all(np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all() and len(d["scores"]) > 0
                     for d in g16.draws)
        par, par_launches = run(glob_args + ["--parallel"])
        pinned_vs_eager = match_frames(np, par.draws, g16.draws, PINNED_DSCORE)
        vid16, vid_launches = run(video_args)
        dbg, dbg_launches = run(["--input", "frames/frame[01].png", "--debug"])
        dbg_ok = len(dbg.debugs) == 2 and all(
            len(hms) == 3 and all(torch.isfinite(h).all() and h.shape[-1] == 1 for h in hms)
            and bool(torch.isfinite(p.boxes).all()) and int(p.valid.sum()) > 0 for _, hms, p, _ in dbg.debugs)
        emit(workflow_demo={
            "config": WORKFLOW_CONFIG, "dtype": "bfloat16", "glob_frames": len(g16.draws), "launches": launches,
            "launches_per_image": per_image, "finite": finite, "parallel_vs_glob": pinned_vs_eager,
            "parallel_launches_counted": par_launches, "video_frames_drawn": len(vid16.draws),
            "video_frames_written": len(vid16.written.get(os.path.join(tmp, "out", "clip_out.mp4"), [])),
            "video_launches": vid_launches, "debug_overlays": len(dbg.debugs), "debug_launches": dbg_launches,
            "debug_finite": dbg_ok, "card": smi})
        # each run builds its support cache on the card: K3's 8x8 and 4x4 pools, 2 launches
        if launches != kernels(3 * WORKFLOW_GLOB, 2 * WORKFLOW_GLOB, WORKFLOW_GLOB + 2) or not finite \
                or len(g16.draws) != WORKFLOW_GLOB:
            raise AssertionError(f"demo by glob: launches {launches}, finite {finite}")
        if not pinned_vs_eager["all_matched"]:
            raise AssertionError(f"demo --parallel against the glob run: {pinned_vs_eager}")
        # the video's frame batches go through the pinned serving function:
        # one signature captured (its warm-ups and both captures counted), then replays
        if len(vid16.draws) != WORKFLOW_VIDEO or vid_launches != kernels(
                3 * (WARMUP_CALLS + CAPTURES), 2 * (WARMUP_CALLS + CAPTURES), WARMUP_CALLS + CAPTURES + 2):
            raise AssertionError(f"demo by video: {len(vid16.draws)} frames, launches {vid_launches}")
        if not dbg_ok or dbg_launches != kernels(3 * 2, 2 * 2, 2 + 2):  # one forward pass an image
            raise AssertionError(f"demo --debug: overlays {len(dbg.debugs)}, launches {dbg_launches}")

        # ---- card vs CPU in f32, by phase 5's criteria
        f32 = ["compute_dtype=float32"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card_vs_cpu = {}
        for name, argv in (("glob", glob_args), ("video", video_args)):
            runs = {d: run(argv, d, f32)[0].draws for d in ("cuda", "cpu")}
            tie_at = get_config(WORKFLOW_CONFIG).roi.nms_thresh_test if name == "video" else None
            card_vs_cpu[name] = match_frames(np, runs["cuda"], runs["cpu"], MATCH_DSCORE, tie_at)

        # ---- visualize_features on one frame, card vs CPU in f32
        cfg32 = apply_overrides(cfg, f32)
        params = load_params_npz(npz)
        maps = {}
        for d in ("cuda", "cpu"):
            cache = encode_support_set(cfg32, params, load_support_index(index), imread=store.get, device=d)
            maps[d] = visualize_features.feature_maps(cfg32, params, cache, frames[0], device=d)
        worst = {k: float(np.abs(maps["cuda"][k] - v).max() / np.abs(v).max()) for k, v in maps["cpu"].items()}
        maps_ok = len(worst) == 9 and all(np.isfinite(m).all() for d in maps.values() for m in d.values()) and \
            max(worst.values()) <= WORKFLOW_MAP_TOL

        # ---- finetune_dla with the fused CGM at 160 channels (random weights from seed 0 on both sides)
        dla, dla_roi = {}, []
        for d in ("cuda", "cpu"):
            media = MemoryMedia(np, store)
            args = demo.parse_args(["--input", "frames/frame[01].png", "--support-index", index, "--config",
                                    "finetune_dla", "--confidence", "0.0", "--device", d, "--output",
                                    os.path.join(tmp, "dla"), "use_pallas_cgm=true"])
            # K3's calls recorded (on the card; the CPU run launches none)
            dla[d] = (media, count_launches(cgm_cuda, nms_cuda, lambda: dla_roi.extend(record_roi_calls(
                torch, lambda: demo.run(args, media.media())))))
        dla_match = match_frames(np, dla["cuda"][0].draws, dla["cpu"][0].draws, MATCH_DSCORE)
        dla_roi_checks, dla_roi_bad = check_roi_calls(torch, dla_roi)
        dla_roi.clear()
        emit(workflow_card_vs_cpu={"f32": card_vs_cpu, "feature_maps_worst_of_largest": worst,
                                   "finetune_dla_use_pallas_cgm": {"channels": get_config("finetune_dla").fpn.out_channels,
                                                                   "launches": dla["cuda"][1], **dla_match,
                                                                   "roi_checks": dla_roi_checks},
                                   "card": smi})
        if not all(c["all_matched"] for c in card_vs_cpu.values()):
            raise AssertionError(f"demo card vs CPU: {card_vs_cpu}")
        if not maps_ok:
            raise AssertionError(f"visualize_features card vs CPU: {worst}")
        if dla["cuda"][1] != kernels(3 * 2, 2 * 2, 2 + 2) or not dla_match["all_matched"]:
            raise AssertionError(f"finetune_dla with use_pallas_cgm: launches {dla['cuda'][1]}, {dla_match}")
        if dla_roi_bad or len(dla_roi_checks) != 2 + 2:
            raise AssertionError(f"finetune_dla with use_pallas_cgm: K3 on the request's own inputs {dla_roi_checks}")
        out.update(glob_launches=launches, dla_launches=dla["cuda"][1])
    emit(workflow_phase_s=time.perf_counter() - t_phase)
    return out


# ------------------------------------------------------------------ phase 17
def quant_inputs(torch, np, cfg, n: int, seed: int):
    """n synthetic VGA frames on the 320x448 canvas: normalized f32
    canvases [n, 3, H, W] (host preprocessing) and the uint8 canvases of the
    same resized frames (zero padding), both on the card."""
    from faster_orefsdet_tpu_torch.pipelines.preprocess import pad_to_canvas, preprocess_host, resize_image_host

    inp = cfg.input
    frames, _ = synthetic_frames(np, n, seed)
    f32 = torch.stack([preprocess_host(f, inp.min_size_test, inp.max_size_test, CANVAS_HW, inp.pixel_mean,
                                       inp.pixel_std)[0] for f in frames])
    rh, rw = int(IMAGE_HW[0]), int(IMAGE_HW[1])
    u8 = np.stack([pad_to_canvas(resize_image_host(f, rh, rw), CANVAS_HW) for f in frames]).transpose(0, 3, 1, 2)
    return f32.cuda(), torch.from_numpy(np.ascontiguousarray(u8)).cuda()


def record_int8_products(torch, request):
    """Runs request() once with ops.quant.int8_conv2d recording its int8
    operands and int32 result, and the int8 layers recording their inputs
    (QuantConv calls that return floats, resident ConvNorm units): returns
    (products, units). Each unit makes one of the products, in order."""
    from faster_orefsdet_tpu_torch.models import layers
    from faster_orefsdet_tpu_torch.ops import quant

    conv2d, conv_fwd, resident = quant.int8_conv2d, layers.QuantConv.forward, layers.ConvNorm._resident
    products, units = [], []

    def rec_conv2d(xq, wq, stride, padding):
        acc = conv2d(xq, wq, stride, padding)
        products.append((xq, wq, tuple(stride), tuple(padding), acc))
        return acc

    def rec_conv(self, x, raw=False):
        if not raw:
            units.append((self, x))
        return conv_fwd(self, x, raw=raw)

    def rec_resident(self, x):
        units.append((self, x))
        return resident(self, x)

    quant.int8_conv2d, layers.QuantConv.forward, layers.ConvNorm._resident = rec_conv2d, rec_conv, rec_resident
    try:
        request()
        torch.cuda.synchronize()
    finally:
        quant.int8_conv2d, layers.QuantConv.forward, layers.ConvNorm._resident = conv2d, conv_fwd, resident
    return products, units


def int8_products_card_vs_cpu(torch, products) -> list:
    """Every distinct int8 conv of a request (operand shapes, stride,
    padding): the card's int32 accumulator against the CPU's on copies of
    the same int8 operands, which must be equal."""
    from faster_orefsdet_tpu_torch.ops import quant

    checks, done = [], set()
    for xq, wq, stride, padding, acc in products:
        key = (tuple(xq.shape), tuple(wq.shape), stride, padding)
        if key in done:
            continue
        done.add(key)
        ref = quant.int8_conv2d(xq.cpu(), wq.cpu(), stride, padding)
        diff = int((acc.cpu() != ref).sum())
        checks.append({"x": list(xq.shape), "w": list(wq.shape), "stride": list(stride), "mismatches": diff})
    return checks


def quant_card_vs_cpu(torch, np, cfg32, params, scales, sup, img) -> dict:
    """A quantized preset in f32, card against CPU, on one image with the
    card's support cache on both. The float ops feeding a quantizer (the
    eSE's mean and 1x1 conv, the FPN's sums) differ in the last bits between
    the devices; where such a value sits at a rounding boundary, or where it
    moves a dynamic scale, an int8 value flips by one step, which random
    weights carry into other boxes. So the CPU request runs twice: on its
    own int8 grids (reported: the int8 activations that differ, and the
    match), and on the card's (each int8 product takes the card's int32
    result, after the CPU's own int8 operands are compared with the card's),
    which phase 5's criteria hold. Every weight's int8 grid must be the
    card's."""
    from faster_orefsdet_tpu_torch.ops import quant
    from faster_orefsdet_tpu_torch.pipelines.inference import build_inference_fn, pack_detections, unpack_detections_np
    from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache, build_support_cache

    cache = build_support_cache(cfg32, params, *sup)
    cpu_cache = SupportCache(*(t.cpu() for t in cache))
    out = {}
    with torch.inference_mode():
        products, _ = record_int8_products(torch, lambda: out.update(card=build_inference_fn(
            cfg32, params, act_scales=scales)(cache, img.cuda(), IMAGE_HW)))
    cpu_fn = build_inference_fn(cfg32, params, device="cpu", act_scales=scales)
    own = cpu_fn(cpu_cache, img, IMAGE_HW)
    conv2d, it = quant.int8_conv2d, iter(products)
    diff = {"x": 0, "w": 0, "x_values": 0}

    def on_card_grid(xq, wq, stride, padding):
        cxq, cwq, _, _, acc = next(it)
        diff["x"] += int((xq != cxq.cpu()).sum())
        diff["w"] += int((wq != cwq.cpu()).sum())
        diff["x_values"] += xq.numel()
        return acc.cpu()

    quant.int8_conv2d = on_card_grid
    try:
        forced = cpu_fn(cpu_cache, img, IMAGE_HW)
    finally:
        quant.int8_conv2d = conv2d
    card = unpack_detections_np(pack_detections(out["card"]))
    return {"own_int8_grids": {**match(np, card, unpack_detections_np(pack_detections(own)), MATCH_DSCORE),
                               "int8_activations_differing": diff["x"], "int8_activations": diff["x_values"]},
            "on_the_cards_int8_grids": match(np, card, unpack_detections_np(pack_detections(forced)), MATCH_DSCORE),
            "weight_int8_mismatches": diff["w"], "products": len(products)}


def int8_breakdown(torch, products, units, scales) -> dict:
    """Device ms of a request's int8 work, each piece a CUDA-graph replay on
    the request's own operands: the int8 GEMMs, the im2col gathers, and the
    int8 layers whole (QuantConv calls and resident ConvNorm units); the
    quantize, dequant and weight passes are the layers' time less their
    GEMMs and gathers (FrozenBN and relu of a resident unit included). The
    GEMMs' bound counts 2*M*K*N operations at the int8 peak and their int8
    operands and int32 results once."""
    from faster_orefsdet_tpu_torch.ops import quant

    def in_scales(fn):
        def run():
            with torch.inference_mode(), quant.static_act_scales(scales):
                fn()
        return run

    gemm_ms = im2col_ms = layers_ms = ops = nbytes = 0.0
    for xq, wq, stride, padding, _ in products:
        kh, kw = wq.shape[-2:]
        with torch.inference_mode():
            cols = quant.im2col(xq, (kh, kw), stride, padding)
            wmat = quant.weight_matrix(wq)
        if cols.data_ptr() != xq.data_ptr():  # a 1x1 stride-1 conv's im2col is a view: no work
            im2col_ms += graph_ms(torch, in_scales(lambda: quant.im2col(xq, (kh, kw), stride, padding)), 20, 3)
        gemm_ms += graph_ms(torch, in_scales(lambda: quant.int8_gemm(cols, wmat)), 20, 3)
        m, k = cols.shape
        ops += 2.0 * m * k * wmat.shape[0]
        nbytes += m * k + k * wmat.shape[0] + 4 * m * wmat.shape[0]
    for module, x in units:
        layers_ms += graph_ms(torch, in_scales(lambda: module(x)), 20, 3)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S
    return {"int8_layers_ms": layers_ms, "int8_gemm_ms": gemm_ms, "im2col_ms": im2col_ms,
            "quant_passes_ms": layers_ms - gemm_ms - im2col_ms, "int8_gemms": len(products),
            "int8_gemm_bound_ms": max(t_ops, t_bytes) * 1e3,
            "int8_gemm_bound_by": "operations" if t_ops > t_bytes else "bytes"}


def phase_quant(torch, np, smi):
    """The quantized serving presets at full width, each with its own
    25-shot cache; the static ones calibrated on 8 synthetic VGA frames.
    Eager batch 1 and 8 (launches, the NMS kernel on the ROI site's own
    inputs, every int8 product card vs CPU), pinned against eager, card vs
    CPU in f32, then request times, a profile of the pinned batch-8 request
    and its int8 work piece by piece; serving_vovnet_fast in bf16 timed the
    same way beside them."""
    from faster_orefsdet_tpu_torch.config import get_config
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda, quant
    from faster_orefsdet_tpu_torch.pipelines.inference import (
        build_batched_inference_fn, build_inference_fn, build_pinned_inference_fn, pack_detections,
        unpack_detections_np,
    )
    from faster_orefsdet_tpu_torch.pipelines.quant_calib import calibrate_act_scales
    from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache
    from faster_orefsdet_tpu_torch.utils.params import init_params

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # the comparisons first, as phases 3-10
    params = init_params(get_config(QUANT_YARDSTICK), seed=0)  # one float tree serves every preset
    sup = support_inputs(torch, np, get_config(QUANT_YARDSTICK), 25, np.random.default_rng(17))
    sup32 = support_inputs(torch, np, get_config(QUANT_YARDSTICK), 5, np.random.default_rng(2))
    img32 = torch.from_numpy(np.random.default_rng(3).standard_normal((3, *CANVAS_HW)).astype(np.float32))
    f32, u8 = quant_inputs(torch, np, get_config(QUANT_YARDSTICK), 8, seed=21)
    calib, _ = quant_inputs(torch, np, get_config(QUANT_YARDSTICK), QUANT_CALIB_FRAMES, seed=22)
    hw8 = torch.tensor([IMAGE_HW] * 8, device="cuda")
    launches, replayed = kernels(), kernels()
    roi_site = {"launches": 0, "mismatches": 0, "max_abs_err": 0.0}
    timed = {}
    for name in QUANT_PRESETS + (QUANT_YARDSTICK,):
        t_preset = time.perf_counter()
        cfg = get_config(name)
        cache = build_support_cache(cfg, params, *sup)
        scales, row = None, {"config": name, "quantize": cfg.quantize, "dtype": cfg.compute_dtype}
        if cfg.quantize in ("int8_static", "int8_resident"):
            t0 = time.perf_counter()
            scales = calibrate_act_scales(cfg, params, calib)
            row.update(calibration={"frames": len(calib), "scales": len(scales), "s": time.perf_counter() - t0})
        serve1 = build_inference_fn(cfg, params, act_scales=scales)
        serve8 = build_batched_inference_fn(cfg, params, act_scales=scales)
        at = {1: lambda: serve1(cache, f32[0], IMAGE_HW), 8: lambda: serve8(cache, u8, hw8)}
        if cfg.quantize != "none":
            # ---- a counted batch-1 and batch-8 request: launches, int8 GEMMs, K2's own inputs
            out, seen = {}, {}
            quant.counter.gemms = 0
            counted = count_launches(cgm_cuda, nms_cuda, lambda: seen.update(record_nms_calls(
                torch, lambda: out.update(p1=pack_detections(at[1]()), p8=pack_detections(at[8]())))))
            gemms = quant.counter.gemms
            nms_checks, nms_err = check_nms_calls(torch, seen)
            sites = [c["shape"] for c in nms_checks if c["site"] == "kernel"]
            roi = [c for c in nms_checks if c["shape"][1] == FAST_ROI_K]
            roi_site = {"launches": roi_site["launches"] + len(roi),
                        "mismatches": roi_site["mismatches"] + sum(c["mismatches"] for c in roi),
                        "max_abs_err": max(roi_site["max_abs_err"], nms_err)}
            launches = {k: launches[k] + counted[k] for k in launches}
            # ---- every distinct int8 conv of the batch-8 request, card vs CPU
            with torch.inference_mode():
                products, units = record_int8_products(torch, at[8])
            product_checks = int8_products_card_vs_cpu(torch, products)
            # ---- pinned against eager
            pinned = build_pinned_inference_fn(cfg, params, cache, packed=True, act_scales=scales)
            got1, got8 = pinned(f32[0], IMAGE_HW), pinned(u8, hw8)
            pin = [match(np, unpack_detections_np(got1), unpack_detections_np(out["p1"]), PINNED_DSCORE)]
            g8, e8 = unpack_detections_np(got8), unpack_detections_np(out["p8"])
            pin += [match(np, {k: v[i] for k, v in g8.items()}, {k: v[i] for k, v in e8.items()}, PINNED_DSCORE)
                    for i in range(8)]
            identical = int((got1 == out["p1"]).sum() + (got8 == out["p8"]).sum())
            graphs = [g.launches for g in pinned.graphs.values()]
            # ---- card vs CPU in f32, the same scales on both
            cfg32 = cfg.replace(compute_dtype="float32")
            scales32 = None if scales is None else calibrate_act_scales(cfg32, params, calib)
            card_vs_cpu = quant_card_vs_cpu(torch, np, cfg32, params, scales32, sup32, img32)
            row.update(launches=counted, int8_gemms=gemms, nms_sites=sites, roi_nms_mismatches=roi_site["mismatches"],
                       int8_products_card_vs_cpu={"shapes": len(product_checks),
                                                  "mismatches": sum(c["mismatches"] for c in product_checks)},
                       pinned_vs_eager={"images": len(pin), "all_matched": all(c["ok"] for c in pin),
                                        "max_dscore": max(c["max_dscore"] for c in pin),
                                        "bit_identical_values": identical,
                                        "values": got1.numel() + got8.numel(), "graphs": graphs},
                       card_vs_cpu_f32=card_vs_cpu)
            emit(quant_check=row, card=smi)
            if counted != kernels(6, 4, 2) or gemms != 2 * QUANT_GEMMS:
                raise AssertionError(f"{name}: launches {counted}, int8 GEMMs {gemms} for 2 requests")
            if sites != [[1, 1024], [1, FAST_ROI_K], [8, 1024], [8, FAST_ROI_K]] or any(
                    c["mismatches"] for c in nms_checks):
                raise AssertionError(f"{name}: the NMS kernel on the request's own inputs: {nms_checks}")
            if len(products) != QUANT_GEMMS or any(c["mismatches"] for c in product_checks):
                raise AssertionError(f"{name}: int8 products card vs CPU {product_checks}")
            if not all(c["ok"] for c in pin) or any(g != kernels(3, 2, 1) for g in graphs):
                raise AssertionError(f"{name}: pinned and eager differ: {pin} {graphs}")
            if not card_vs_cpu["on_the_cards_int8_grids"]["ok"] or card_vs_cpu["weight_int8_mismatches"]:
                raise AssertionError(f"{name}: card and CPU detections do not match: {card_vs_cpu}")
        else:
            pinned = build_pinned_inference_fn(cfg, params, cache, packed=True)
        # ---- times, with the library's default TF32 settings as phase 11
        torch.backends.cudnn.allow_tf32 = True
        b1, b8 = request_times(torch, at[1], 10), request_times(torch, at[8], 5)
        pin_at = {1: lambda: pinned(f32[0], IMAGE_HW), 8: lambda: pinned(u8, hw8)}
        p1, p8 = request_times(torch, pin_at[1], 20), request_times(torch, pin_at[8], 10)
        prof = profile_requests(torch, pin_at[8], p8[0])
        timed[name] = {"batch1_ms_median": b1[0], "batch8_ms_median": b8[0], "batch8_images_per_s": 8e3 / b8[0],
                       "pinned_batch1_ms_median": p1[0], "pinned_batch8_ms_median": p8[0],
                       "pinned_batch8_images_per_s": 8e3 / p8[0],
                       "pinned_batch8_device_busy_ms": prof["device_busy_ms"],
                       "pinned_batch8_idle_share": prof["idle_share"],
                       "pinned_batch8_kernel_events": prof["kernel_launches_per_request"]}
        if cfg.quantize != "none":
            parts = int8_breakdown(torch, products, units, scales)
            parts["share_of_device_busy"] = {k: parts[k] / prof["device_busy_ms"]
                                             for k in ("int8_gemm_ms", "im2col_ms", "quant_passes_ms")}
            timed[name]["int8_work"] = parts
        torch.backends.cudnn.allow_tf32 = False
        replayed = {k: replayed[k] + v for k, v in pinned.kernel_launches().items()}
        emit(quant_e2e={"config": name, "dtype": cfg.compute_dtype, "canvas": list(CANVAS_HW), **timed[name],
                        "top_kernels_ms": prof["top_kernels_ms"][:8], "preset_s": time.perf_counter() - t_preset,
                        "card": smi})
    emit(quant_phase_s=time.perf_counter() - t_phase)
    return {"launches": launches, "pinned_replays": replayed, "roi_site": roi_site, "timed": timed}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train_rank(rank, world, device, cfg, params, batches, mode):
    """One rank of phase 18's training (spawned): TF32 off and cuDNN
    deterministic (its default backward sums with atomics, so that two runs
    of one step differ: phase 14). A run: rank 0's state replicated, then
    DP_TRAIN_STEPS steps on this rank's rows of the global batches (on the
    card), the kernels' launches counted (0 just before, read just after),
    each step timed on the host's clock ending in a sync, the weights'
    digest after each step.

    mode "gloo": ``build_pinned_dp_train_step`` must refuse this group, then
    an eager run without dropout. mode "nccl": eager and pinned runs
    without dropout, two eager runs and a pinned one with dropout; then the
    pinned step's time over DP_TIMED_STEPS steps with the batches on the
    card and over as many with this rank's own loader pulls inside (each
    rank maps the whole global batch and keeps its rows), and the loader
    alone. Last, the all-reduce of a flat f32 buffer the size of the step's
    (gradients, running statistics, metrics) timed alone."""
    import torch
    import torch.distributed as dist

    from faster_orefsdet_tpu_torch.data.loader import train_loader
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda, roi_align_cuda
    from faster_orefsdet_tpu_torch.parallel import build_dp_train_step, replicate_state, shard_batch
    from faster_orefsdet_tpu_torch.parallel.train_dp import build_pinned_dp_train_step
    from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_state
    from faster_orefsdet_tpu_torch.utils.params import is_batch_stat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    shards = [shard_batch(b, rank, world).to(device) for b in batches]

    def synced_ms(fn):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t) * 1e3

    def run(build, deterministic: bool, samples: bool = False):
        state = build_train_state(cfg, params, device=device)
        replicate_state(state)
        step = build(cfg, deterministic=deterministic)
        res = {"rows": [], "digests": [], "step_ms": []}
        torch.cuda.synchronize(device)

        def steps():
            for b in shards:
                out = {}
                res["step_ms"].append(synced_ms(lambda: out.update(step(state, b))))
                res["rows"].append({k: float(v) for k, v in out.items()})
                res["digests"].append(_digest(state.model.state_dict().values()))

        cgm_cuda.counter.launches = nms_cuda.counter.launches = roi_align_cuda.counter.launches = 0
        if samples:
            res["roi_samples"] = record_roi_samples(torch, steps)
        else:
            res["captured_nms_shapes"] = record_captured_nms_shapes(torch, steps)
        torch.cuda.synchronize(device)
        res["counted"] = kernels(cgm_cuda.counter.launches, nms_cuda.counter.launches, roi_align_cuda.counter.launches)
        if hasattr(step, "kernel_launches"):
            res["launches"] = step.kernel_launches()
            res["graphs"] = [{"captured_launches": g.launches, "replays": g.replays} for g in step.graphs.values()]
        return res, step, state

    out = {"backend": dist.get_backend(), "device": str(device)}
    if mode == "gloo":
        try:
            build_pinned_dp_train_step(cfg)(build_train_state(cfg, params, device=device), shards[0])
        except ValueError as e:
            out["pinned_refused"] = str(e)
        out["eager"], _, state = run(build_dp_train_step, True, samples=True)
    else:
        out["eager"] = run(build_dp_train_step, True, samples=True)[0]
        out["pinned"] = run(build_pinned_dp_train_step, True)[0]
        out["eager_dropout"] = [run(build_dp_train_step, False)[0] for _ in range(2)]
        out["pinned_dropout"], step, state = run(build_pinned_dp_train_step, False)
        # ---- times: the batches on the card, then this rank's loader pulls inside
        on_card = [synced_ms(lambda: step(state, shards[i % len(shards)])) for i in range(DP_TIMED_STEPS)]
        records, mapper = train_data(cfg)
        loader = train_loader(records, mapper, cfg.solver.ims_per_batch, seed=3, device=device)
        try:
            with_loader = [synced_ms(lambda: step(state, shard_batch(next(loader), rank, world)))
                           for _ in range(DP_TIMED_STEPS)]
            for _ in range(4):  # the loader alone: drain what it holds, then time it
                next(loader)
            t = time.perf_counter()
            for _ in range(LOADER_BATCHES):
                next(loader)
            loader_bps = LOADER_BATCHES / (time.perf_counter() - t)
        finally:
            loader.close()
        out["timed"] = {"on_card_ms": on_card, "with_loader_ms": with_loader, "loader_alone_batches_per_s": loader_bps,
                        "launches": step.kernel_launches(), "steps": state.step,
                        "graphs": [{"captured_launches": g.launches, "replays": g.replays}
                                   for g in step.graphs.values()]}
    numel = sum(p.numel() for p in state.model.parameters() if p.grad is not None)
    numel += sum(v.numel() for k, v in state.model.state_dict().items() if is_batch_stat(k))
    numel += len(out["eager"]["rows"][0])
    flat = torch.zeros(numel, device=device)
    out["allreduce_numel"] = numel
    out["allreduce_ms"] = [synced_ms(lambda: dist.all_reduce(flat)) for _ in range(DP_ALLREDUCE_ITERS + 3)][3:]
    return out


def rel_by_step(rows, reference) -> list:
    """The worst |metric - reference| / |reference| at each step."""
    return [max(abs(row[k] - v) / max(abs(v), 1e-12) for k, v in ref.items()) for row, ref in zip(rows, reference)]


def worst_rel(rows, reference) -> tuple:
    """The worst |metric - reference| / |reference| over the steps and the
    metrics, and where: (err, (step, metric))."""
    worst, where = 0.0, None
    for i, ref in enumerate(reference):
        for k, v in ref.items():
            err = abs(rows[i][k] - v) / max(abs(v), 1e-12)
            if err > worst:
                worst, where = err, (i, k)
    return worst, where


def dp_train_run(torch, np, cfg, params, batches, world, device, backend, reference, per_rank, smi, what,
                 yardstick):
    """phase 18's training over `world` ranks (``dp_train_rank``) against
    the one-process runs `reference` and `per_rank` (each its metrics rows
    and ROI samples on the same global batches; `per_rank` runs each product
    on one rank's rows at a time): every metric within TRAIN_LOSS_RTOL of
    `reference` at each of the first DP_REFERENCE_STEPS steps, and at every
    step where each rank's ROI sample is `reference`'s for its image; each
    step's worst and its flipped samples reported, for the ranks and for
    `per_rank` (the witness: the products' batch alone, in one process,
    flips samples and moves the losses), the ranks' weights bit for bit
    equal after every step, 0 CGM and 1 NMS
    launch a step a rank. Over gloo the pinned step must refuse. Over NCCL the
    pinned runs as well, and each is held against the eager run on the same
    batches: bit for bit where two eager runs with dropout agree bit for
    bit, else within DEFAULTS_FACTOR x their worst loss difference; the
    dropout must change the losses. `yardstick` is the one-process graphed
    step's median ms at these settings. Returns the ranks' launches: the
    eager runs' counted ones, the pinned runs' (warm-ups and captured x
    replays), the pinned graph's captured launches and replays, and the
    [B, K] of the NMS launch captured into the ranks' graphs."""
    import tempfile

    from faster_orefsdet_tpu_torch.parallel.mesh import spawn_ranks
    from faster_orefsdet_tpu_torch.pipelines.train_step import WARMUP_STEPS

    host = [b.to("cpu") for b in batches]
    torch.cuda.synchronize()  # the copies to the host are asynchronous
    mode = "gloo" if backend == "gloo" else "nccl"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(dp_train_rank, world, (cfg, params, host, mode), init_method=f"file://{tmp}/store",
                            device=device, backend=backend, timeout=DP_RANKS_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    (ref_rows, ref_samples), (per_rank_rows, per_rank_samples) = reference, per_rank
    steps = len(ref_rows)
    per_step = kernels(0, steps)
    runs = ["eager"] + (["pinned", "eager_dropout", "pinned_dropout"] if mode == "nccl" else [])

    def each(name):  # a run's results by rank (the two eager dropout runs: the first)
        return [r[name][0] if name == "eager_dropout" else r[name] for r in ranks]

    replicas = {name: all(r["digests"] == each(name)[0]["digests"] for r in each(name)) for name in runs}
    held_steps = ref_rows[:DP_REFERENCE_STEPS]
    vs_one = {name: worst_rel(each(name)[0]["rows"], held_steps) for name in ("eager", "pinned") if name in runs}
    vs_one_all = {name: worst_rel(each(name)[0]["rows"], ref_rows) for name in vs_one}
    # the eager ranks' ROI samples (a graphed run is held to its eager run bit for bit below)
    flips = roi_sample_flips(np, [r["eager"]["roi_samples"] for r in ranks], ref_samples)
    same_sample = [i for i, f in enumerate(flips) if not f]
    by_step = {name: rel_by_step(each(name)[0]["rows"], ref_rows) for name in vs_one}
    vs_one_same = {name: max((v[i] for i in same_sample), default=0.0) for name, v in by_step.items()}
    line = {"run": what, "ranks": world, "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks],
            "steps": steps, "global_batch": cfg.solver.ims_per_batch, "canvas": list(TRAIN_CANVAS),
            "worst_metric_rel_err_vs_one_rank": {k: v[0] for k, v in vs_one.items()},
            "at": {k: v[1] for k, v in vs_one.items()}, "rtol": TRAIN_LOSS_RTOL, "held_steps": len(held_steps),
            "worst_metric_rel_err_vs_one_rank_every_step_reported": vs_one_all,
            "roi_sample_flips_vs_one_process_by_step": flips,
            "worst_metric_rel_err_vs_one_process_by_step": by_step,
            "steps_with_equal_roi_samples": same_sample,
            "worst_metric_rel_err_at_steps_with_equal_roi_samples": vs_one_same,
            "one_process_per_rank_products_vs_one_process": {
                "roi_sample_flips_by_step": roi_sample_flips(np, [per_rank_samples], ref_samples),
                "worst_metric_rel_err_by_step": rel_by_step(per_rank_rows, ref_rows)},
            "replicas_bit_identical_every_step": replicas,
            "eager_step_ms_median_per_rank": [statistics.median(r["eager"]["step_ms"][1:]) for r in ranks],
            "eager_step_ms_first": [r["eager"]["step_ms"][0] for r in ranks],
            "allreduce_ms_median_per_rank": [statistics.median(r["allreduce_ms"]) for r in ranks],
            "allreduce_bytes": 4 * ranks[0]["allreduce_numel"],
            "total_loss": [r["eager"]["rows"][-1]["total_loss"] for r in ranks], "spawn_to_end_s": wall_s}
    bad = [name for name, v in vs_one.items() if v[0] > TRAIN_LOSS_RTOL] + [n for n, ok in replicas.items() if not ok]
    bad += [f"{name} vs one process at steps with equal ROI samples: {v}" for name, v in vs_one_same.items()
            if v > TRAIN_LOSS_RTOL]
    eager_runs = [r["eager"] for r in ranks] + [x for r in ranks for x in r.get("eager_dropout", [])]
    bad += [f"eager counted {x['counted']}" for x in eager_runs if x["counted"] != per_step]
    launches = {"eager": {k: sum(x["counted"][k] for x in eager_runs) for k in per_step},
                "pinned": kernels(), "captured_per_replay": None, "replayed": kernels(),
                "captured_nms_shapes": None}
    if mode == "gloo":
        refused = [r.get("pinned_refused", "") for r in ranks]
        line["pinned_refused"] = refused[0][:160]
        bad += [f"rank {i} did not refuse the pinned step" for i, e in enumerate(refused) if "needs NCCL" not in e]
    else:
        # eager vs eager with dropout: bit for bit, or the spread the graph is held to
        e1, e2 = ([r["eager_dropout"][j] for r in ranks] for j in (0, 1))
        eager_same = all(a["rows"] == b["rows"] and a["digests"] == b["digests"] for a, b in zip(e1, e2))
        spread = max(worst_rel(b["rows"], a["rows"])[0] for a, b in zip(e1, e2))
        held = {}
        for g_name, e_runs in (("pinned", each("eager")), ("pinned_dropout", e1)):
            g_runs = each(g_name)
            same = all(g["rows"] == e["rows"] and g["digests"] == e["digests"] for g, e in zip(g_runs, e_runs))
            err = max(worst_rel(g["rows"], e["rows"])[0] for g, e in zip(g_runs, e_runs))
            held[g_name] = {"bit_identical": same, "worst_loss_rel_err": err,
                            "ok": same if eager_same else err <= DEFAULTS_FACTOR * spread}
        dropout_moves = each("eager_dropout")[0]["rows"][0] != each("eager")[0]["rows"][0]
        graph_runs = [r[name] for r in ranks for name in ("pinned", "pinned_dropout")]
        pinned_launches = [g["launches"] for g in graph_runs]
        captured_shapes = [g["captured_nms_shapes"] for g in graph_runs]
        graphs = [g["graphs"] for g in graph_runs]
        timed = [r["timed"] for r in ranks]  # the dropout run's step function, on to its timed steps
        replay_ms = [statistics.median(r["pinned_dropout"]["step_ms"][WARMUP_STEPS + 1:]) for r in ranks]
        on_card = [statistics.median(t["on_card_ms"]) for t in timed]
        with_loader = [statistics.median(t["with_loader_ms"]) for t in timed]
        eager_ms = line["eager_step_ms_median_per_rank"]
        per_rank = cfg.solver.ims_per_batch // world
        rate = {"graphed": world * per_rank * 1e3 / max(on_card),
                "graphed_with_loader": world * per_rank * 1e3 / max(with_loader),
                "eager": world * per_rank * 1e3 / max(eager_ms),
                "one_process_graphed_yardstick": per_rank * 1e3 / yardstick}
        line.update({
            "eager_vs_eager_dropout_bit_identical": eager_same, "eager_vs_eager_dropout_worst_loss_rel_err": spread,
            "graphed_vs_eager": held, "dropout_changes_the_losses": dropout_moves,
            "graphed_step_ms_median_per_rank": on_card, "graphed_step_ms_median_with_loader_per_rank": with_loader,
            "graphed_replay_ms_median_in_the_checked_run": replay_ms,
            "loader_alone_batches_per_s": [t["loader_alone_batches_per_s"] for t in timed],
            "images_per_s": rate, "images_per_s_over_one_process": rate["graphed"] / rate[
                "one_process_graphed_yardstick"],
            "one_process_graphed_yardstick_ms": yardstick, "graphed_over_yardstick": max(on_card) / yardstick,
            "eager_over_graphed": max(eager_ms) / max(on_card), "pinned_launches_per_run": pinned_launches,
            "pinned_graphs": graphs, "captured_nms_shapes": captured_shapes[0],
            "timed_launches": [t["launches"] for t in timed],
            "timed_graphs": [t["graphs"] for t in timed], "timed_steps": [t["steps"] for t in timed]})
        bad += [f"{k} vs eager {v}" for k, v in held.items() if not v["ok"]]
        bad += [] if dropout_moves else ["the dropout did not change the losses"]
        bad += [f"pinned launches {x}" for x in pinned_launches if x != per_step]
        bad += [f"graphs {g}" for g in graphs + [t["graphs"] for t in timed]
                if [x["captured_launches"] for x in g] != [kernels(0, 1)]]
        bad += [f"captured NMS shapes {c}" for c in captured_shapes
                if c != captured_shapes[0] or len(c) != graphs[0][0]["captured_launches"]["nms"]]
        bad += [f"timed launches {t['launches']} over {t['steps']} steps" for t in timed
                if t["launches"] != kernels(0, t["steps"])]
        # the pinned runs' launches: the dropout-off run's, and the dropout run's to the end of its timed steps
        replayed = [x for r in ranks for x in r["pinned"]["graphs"] + r["timed"]["graphs"]]
        launches.update(pinned={k: sum(r["pinned"]["launches"][k] + r["timed"]["launches"][k] for r in ranks)
                                for k in per_step},
                        captured_per_replay=graphs[0][0]["captured_launches"],
                        captured_nms_shapes=captured_shapes[0],
                        replayed={k: sum(x["replays"] * x["captured_launches"][k] for x in replayed) for k in per_step})
    emit(dp_train={**line, "launches": launches, "card": smi})
    if bad:
        raise AssertionError(f"{what}: {bad}")
    return launches


def per_rank_products(torch, world: int):
    """A function mode under which each convolution and linear layer whose
    input rows split evenly over `world` ranks (the global batch's images,
    their support crops, their ROIs: rank-major, as ``shard_batch`` splits
    them) runs on one rank's share at a time, the outputs concatenated: the
    products that `world` ranks compute, in one process. Autograd's backward
    follows the split."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class PerRank(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            x = args[0] if args else None
            if (func in (F.conv2d, F.linear) and world > 1 and isinstance(x, torch.Tensor) and x.dim() >= 2
                    and x.shape[0] % world == 0):
                return torch.cat([func(part, *args[1:], **kwargs) for part in x.chunk(world)])
            return func(*args, **kwargs)

    return PerRank()


def dp_reference(torch, cfg, params, batches, per_rank: bool = False):
    """The one-process run over the global batches (TF32 off, cuDNN
    deterministic as in the ranks, no dropout): its metrics rows and ROI
    samples. With `per_rank`, under ``per_rank_products`` over cfg's
    ims_per_batch ranks."""
    import contextlib

    from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_state, build_train_step

    torch.backends.cudnn.allow_tf32 = False
    prev, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
    split = per_rank_products(torch, cfg.solver.ims_per_batch) if per_rank else contextlib.nullcontext()
    try:
        state, step = build_train_state(cfg, params), build_train_step(cfg, deterministic=True)
        rows = []
        with split:
            samples = record_roi_samples(torch, lambda: rows.extend(
                {k: float(v) for k, v in step(state, b).items()} for b in batches))
    finally:
        torch.backends.cudnn.deterministic = prev
    del state
    torch.cuda.empty_cache()
    return rows, samples


def dp_world_one(torch, cfg, params, batches, smi) -> dict:
    """The pinned DP step outside a process group on this card (TF32 off,
    cuDNN deterministic, dropout on) against build_train_step_scan over
    the same batches from the same state: every metric and the weights
    after every step bit for bit, the generators equal, 1 NMS and 0 CGM
    launches a step (warm-ups and captured x replays). Then a checkpoint
    written after step DP_RESUME_STEP is resumed into the running state (in
    place, between replays) and the later steps taken again: the same
    metrics and weights. Then the one-process graphed step's time at these
    settings (build_train_step_scan's replays, the batches on the card):
    the yardstick of the ranks' graphed steps."""
    import tempfile

    from faster_orefsdet_tpu_torch.parallel.train_dp import build_pinned_dp_train_step
    from faster_orefsdet_tpu_torch.pipelines.train_step import build_train_state, build_train_step_scan
    from faster_orefsdet_tpu_torch.utils.checkpoint import resume_or_load, save_checkpoint

    prev, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
    torch.backends.cudnn.allow_tf32 = False
    batches = [b.to("cuda") for b in batches]
    scan_state, scan = build_train_state(cfg, params), build_train_step_scan(cfg)
    state, pinned = build_train_state(cfg, params), build_pinned_dp_train_step(cfg)
    rows = {"scan": [], "pinned": [], "resumed": []}
    digests = {"scan": [], "pinned": [], "resumed": []}
    captured = []  # the [B, K] of each NMS launch captured into the pinned step's graph
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for b in batches:
                rows["scan"].append({k: float(v[0]) for k, v in scan(scan_state, [b]).items()})
                digests["scan"].append(_digest(scan_state.model.state_dict().values()))
                got = {}
                captured += record_captured_nms_shapes(torch, lambda: got.update(pinned(state, b)))
                rows["pinned"].append({k: float(v) for k, v in got.items()})
                digests["pinned"].append(_digest(state.model.state_dict().values()))
                if state.step == DP_RESUME_STEP:
                    save_checkpoint(tmp, state)
            generators_equal = torch.equal(scan_state.generator.get_state(), state.generator.get_state())
            resume_or_load(tmp, state)
            for b in batches[DP_RESUME_STEP:]:
                rows["resumed"].append({k: float(v) for k, v in pinned(state, b).items()})
                digests["resumed"].append(_digest(state.model.state_dict().values()))
        times = []
        for i in range(DP_TIMED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            scan(scan_state, [batches[i % len(batches)]])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        torch.backends.cudnn.deterministic = prev
    steps = len(batches)
    taken = steps + steps - DP_RESUME_STEP
    graphs = [{"captured_launches": g.launches, "replays": g.replays} for g in pinned.graphs.values()]
    res = {"steps": steps, "bit_identical_to_scan": rows["pinned"] == rows["scan"]
           and digests["pinned"] == digests["scan"], "generators_equal": generators_equal,
           "resumed_at": DP_RESUME_STEP, "resumed_in_place_bit_identical": rows["resumed"] == rows["pinned"][
               DP_RESUME_STEP:] and digests["resumed"] == digests["pinned"][DP_RESUME_STEP:],
           "launches": pinned.kernel_launches(), "steps_taken": taken, "graphs": graphs,
           "captured_nms_shapes": captured,
           "yardstick_step_ms_median": statistics.median(times), "yardstick_step_ms_min": min(times),
           "yardstick_step_ms_max": max(times)}
    emit(dp_train={"run": "one_card_world1_graph", **res, "canvas": list(TRAIN_CANVAS), "card": smi})
    if not (res["bit_identical_to_scan"] and generators_equal and res["resumed_in_place_bit_identical"]):
        raise AssertionError(f"the pinned DP step at world 1 differs from build_train_step_scan: {res}")
    if res["launches"] != kernels(0, taken) or [g["captured_launches"] for g in graphs] != [kernels(0, 1)] \
            or len(captured) != 1:
        raise AssertionError(f"the pinned DP step at world 1 launched {res['launches']} over {taken} steps: {graphs}, "
                             f"captured NMS shapes {captured}")
    del scan_state, scan, state, pinned
    torch.cuda.empty_cache()
    return res


def phase_dp_train(torch, np, smi, count: int, n: int) -> dict:
    """Phase 18's training of finetune_vovnet at full width, TF32 off and
    cuDNN deterministic: the pinned DP step at world 1 on this card
    (``dp_world_one``, also the one-process graphed yardstick), two gloo
    ranks on cuda:0 and, with two cards or more, one NCCL rank a card, each
    against one process over the same global batches (``dp_train_run``).
    Returns the launches: "train" counted on the eager runs, "graphed"
    the pinned runs' (warm-ups and captured x replays) and "graph_site"
    the DP step graph's captured launches, replayed launches and the
    [B, K] of its captured NMS launch, as the world-1 graph recorded them
    (the NCCL ranks' graphs must record the same)."""
    from faster_orefsdet_tpu_torch.config import get_config
    from faster_orefsdet_tpu_torch.data.loader import train_loader
    from faster_orefsdet_tpu_torch.utils.params import init_params

    tcfg = get_config(TRAIN_CONFIG)
    tparams = init_params(tcfg, seed=0)
    records, mapper = train_data(tcfg)
    runs = [("one_card_gloo", 2, "cuda:0", "gloo")]
    if count >= 2:
        runs.append(("cards_nccl", n, "cuda", None))
    else:
        emit(dp_train={"run": "cards_nccl", "ran": False,
                       "why": f"{count} card visible: NCCL across cards needs two or more", "card": smi})
    out = {"train": kernels(), "graphed": kernels()}

    def take(world):
        loader = train_loader(records, mapper, world, seed=3)
        try:
            return [next(loader) for _ in range(DP_TRAIN_STEPS)]
        finally:
            loader.close()

    one = dp_world_one(torch, tcfg, tparams, take(1), smi)
    yardstick = one["yardstick_step_ms_median"]
    out["graphed"] = dict(one["launches"])
    site = out["graph_site"] = {
        "captured_launches_per_replay": one["graphs"][0]["captured_launches"],
        "replays": {k: sum(g["replays"] * g["captured_launches"][k] for g in one["graphs"]) for k in kernels()},
        "shapes": one["captured_nms_shapes"]}
    for what, world, device, backend in runs:
        wcfg = tcfg.replace(solver=dataclasses.replace(tcfg.solver, ims_per_batch=world))
        batches = take(world)
        reference = dp_reference(torch, wcfg, tparams, batches)
        per_rank = dp_reference(torch, wcfg, tparams, batches, per_rank=True)
        got = dp_train_run(torch, np, wcfg, tparams, batches, world, device, backend, reference, per_rank, smi,
                           what, yardstick)
        if got["captured_per_replay"] is not None and (
                got["captured_per_replay"] != site["captured_launches_per_replay"]
                or got["captured_nms_shapes"] != site["shapes"]):
            raise AssertionError(f"{what}: the ranks' graphs captured {got['captured_per_replay']} at "
                                 f"{got['captured_nms_shapes']}, the world-1 graph {site}")
        out["train"] = {k: out["train"][k] + got["eager"][k] for k in out["train"]}
        out["graphed"] = {k: out["graphed"][k] + got["pinned"][k] for k in out["graphed"]}
        site["replays"] = {k: site["replays"][k] + got["replayed"][k] for k in site["replays"]}
    return out


def phase_dp(torch, np, cfg, params, cache, frames_u8, smi):
    """Data parallelism: sharded serving (a pinned replica a card) and
    sharded eval over min(cards, DP_MAX_CARDS) cards against one card,
    make_mesh's refusal, finetune_vovnet data-parallel training by two gloo
    ranks on cuda:0 and, where there are two cards or more, by one NCCL rank
    a card, each against one process over the same global batches. Returns
    the replicas' replayed launches ("pinned") and the training ranks'
    counted ones ("train")."""
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.parallel import eval_dp, make_mesh, make_sharded_serving
    from faster_orefsdet_tpu_torch.parallel.eval_dp import evaluate_sharded
    from faster_orefsdet_tpu_torch.pipelines import evaluate as evaluate_module
    from faster_orefsdet_tpu_torch.pipelines.evaluate import encode_support_set, evaluate
    from faster_orefsdet_tpu_torch.pipelines.graphs import CAPTURES, WARMUP_CALLS
    from faster_orefsdet_tpu_torch.pipelines.inference import (
        build_pinned_serving_fn, build_serving_fn, pack_detections, unpack_detections_np,
    )
    from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    n = min(count, DP_MAX_CARDS)
    try:
        make_mesh(count + 1)
    except ValueError as e:
        emit(dp_mesh={"visible": count, "refused": f"make_mesh({count + 1})", "error": str(e)[:90]})
    else:
        raise AssertionError(f"make_mesh({count + 1}) did not refuse {count} visible card(s)")
    mesh = make_mesh(n)
    torch.backends.cudnn.allow_tf32 = False  # the comparisons, as phases 3-10
    torch.backends.cuda.matmul.allow_tf32 = False
    once = kernels(3 * (WARMUP_CALLS + CAPTURES), 2 * (WARMUP_CALLS + CAPTURES),
                   WARMUP_CALLS + CAPTURES)  # warm-ups and captures

    # ---- (a) sharded serving through a pinned replica a card against card
    # 0's pinned replay of the same frames, bit for bit (at n = 1 the whole batch)
    frames = frames_u8[:DP_SERVE_BATCH].cuda()
    sharded, canvas = make_sharded_serving(cfg, params, FRAME_HW, mesh, cache)
    single, _ = build_pinned_serving_fn(cfg, params, cache, FRAME_HW)
    out = {}
    counted = count_launches(cgm_cuda, nms_cuda, lambda: out.update(det=sharded(frames)))
    serve_launches = sharded.kernel_launches()  # one replay a card
    graphs = [[g.launches for g in r.graphs.values()] for r in sharded.replicas]
    share = DP_SERVE_BATCH // n
    shares_equal = [all(torch.equal(a[i * share:(i + 1) * share], b)
                        for a, b in zip(out["det"], single(frames[i * share:(i + 1) * share])))
                    for i in range(n)]
    check = {"shares_bit_identical_to_card0_pinned": shares_equal, "graphs_captured_launches": graphs,
             "counted_launches": counted}
    ok = all(shares_equal)
    if n > 1:
        # reported, not held: the batch in f32 against one card's eager batch
        # of 8 by phase 5's criteria. That compares batch 8 with batch 8 / n
        # on one card (the shares are bit for bit card 0's): cuDNN picks its
        # convolutions by the batch, and on noise frames a random model's
        # near-tied proposals swap at the top-k boundary
        cfg32 = cfg.replace(compute_dtype="float32")
        sup32, box32 = support_inputs(torch, np, cfg32, 5, np.random.default_rng(2))
        cache32 = build_support_cache(cfg32, params, sup32, box32)
        got = make_sharded_serving(cfg32, params, FRAME_HW, mesh, cache32)[0](frames)
        ref = build_serving_fn(cfg32, params, FRAME_HW)[0](cache32, frames)
        g, r = (unpack_detections_np(pack_detections(d)) for d in (got, ref))
        check["f32_batch_effect_reported"] = [match(np, {k: v[i] for k, v in g.items()},
                                                    {k: v[i] for k, v in r.items()}, MATCH_DSCORE)
                                              for i in range(DP_SERVE_BATCH)]
    # images/s, the library defaults (TF32 convs) as phase 11, host clock,
    # each call ending in a sync: pinned at n cards and at one, at 8 frames
    # a call (8 / n a card) and at 8 frames a card, and the same through the
    # eager replicas that make_sharded_serving held to PR 11
    torch.backends.cudnn.allow_tf32 = True
    eager = [(build_serving_fn(cfg, params, FRAME_HW, device=dev)[0], cache.to(dev), dev) for dev in mesh.devices]

    def eager_sharded(fr):
        dets = [fn(c, part.to(dev, non_blocking=True)) for (fn, c, dev), part in zip(eager, fr.chunk(n))]
        return [torch.cat([t.to(mesh.devices[0], non_blocking=True) for t in ts]) for ts in zip(*dets)]

    timed_sharded, _ = make_sharded_serving(cfg, params, FRAME_HW, mesh, cache)
    timed_single, _ = build_pinned_serving_fn(cfg, params, cache, FRAME_HW)
    frames_n = frames.repeat(n, 1, 1, 1)  # 8 frames a card
    runs = {"pinned_at_n": (lambda: timed_sharded(frames), DP_SERVE_BATCH),
            "pinned_at_1": (lambda: timed_single(frames), DP_SERVE_BATCH),
            "pinned_at_1_batch_per_card": (lambda: timed_single(frames[:share]), share),
            "pinned_at_n_8_a_card": (lambda: timed_sharded(frames_n), DP_SERVE_BATCH * n),
            "eager_at_n": (lambda: eager_sharded(frames), DP_SERVE_BATCH),
            "eager_at_1": (lambda: eager[0][0](cache, frames), DP_SERVE_BATCH)}
    rates = {}
    for name, (fn, images) in runs.items():
        med = request_times(torch, fn, DP_SERVE_ITERS)[0]
        rates[name] = {"ms_median": med, "images_per_s": images * 1e3 / med}
    per_card = rates["pinned_at_1_batch_per_card"]["images_per_s"]
    emit(dp_serve={"config": "serving_vovnet", "frames": [DP_SERVE_BATCH, *FRAME_HW], "canvas": list(canvas),
                   "cards": n, "visible": count, "launches": serve_launches, **check, **rates,
                   "pinned_at_n_over_one_card_at_the_same_batch_per_card":
                       rates["pinned_at_n"]["images_per_s"] / per_card,
                   "card": smi})
    if n == 1:
        emit(dp_serve_scaling={"cards": 1, "why": "one card visible: sharded serving at n cards against one card "
                                                  "needs two or more; the figure stays open", "card": smi})
    if not ok:
        raise AssertionError(f"sharded serving over {n} card(s) differs from card 0's pinned replay: {check}")
    if (serve_launches != kernels(3 * n, 2 * n, n) or graphs != [[kernels(3, 2, 1)]] * n
            or counted != {k: v * n for k, v in once.items()}):
        raise AssertionError(f"sharded serving: replayed {serve_launches}, graphs {graphs}, counted {counted} "
                             f"over {n} card(s)")
    torch.backends.cudnn.allow_tf32 = False

    # ---- (b) sharded eval against one card at the cards' batch (the same
    # batches of images: the same table), both through pinned functions
    records, entries, store = eval_data(np, cfg, EVAL_FRAMES, EVAL_SHOTS)
    ecache = encode_support_set(cfg, params, entries, shot=EVAL_SHOTS, imread=store.get)
    per_device = DP_SERVE_BATCH // n
    ref_ap = {}
    pinned_built(evaluate_module, "build_pinned_inference_fn", lambda: ref_ap.update(
        evaluate(cfg, params, ecache, records, batch_size=per_device, imread=store.get)))
    res, built = {}, []
    counted = count_launches(cgm_cuda, nms_cuda, lambda: built.extend(pinned_built(
        eval_dp, "build_pinned_inference_fn", lambda: res.update(
            evaluate_sharded(cfg, params, ecache, records, mesh, per_device_batch=per_device, imread=store.get)))))
    eval_launches = {k: sum(fn.kernel_launches()[k] for fn in built) for k in kernels()}
    diff = max(abs(res[k] - ref_ap[k]) for k in AP_KEYS if not np.isnan(ref_ap[k])) if any(
        not np.isnan(ref_ap[k]) for k in AP_KEYS) else 0.0
    same_nan = all(np.isnan(res[k]) == np.isnan(ref_ap[k]) for k in AP_KEYS)
    requests = -(-len(records) // DP_SERVE_BATCH)
    emit(dp_eval={"frames": len(records), "cards": n, "per_device_batch": per_device,
                  "sharded": {k: res[k] for k in AP_KEYS}, "one_card": {k: ref_ap[k] for k in AP_KEYS},
                  "one_card_fps": ref_ap.get("fps"), "max_abs_diff": diff, "launches": eval_launches,
                  "counted_launches": counted, "card": smi,
                  "note": "random weights: the values check the loop, not the detector"})
    if not same_nan or diff > 0.0:
        raise AssertionError(f"evaluate_sharded over {n} card(s) vs evaluate: {res} vs {ref_ap}")
    if (len(built) != n or eval_launches != kernels(3 * n * requests, 2 * n * requests, n * requests)
            or counted != {k: v * n for k, v in once.items()}):
        raise AssertionError(f"evaluate_sharded: {len(built)} replicas, replayed {eval_launches}, counted {counted}")
    pinned = {k: serve_launches[k] + eval_launches[k] for k in serve_launches}

    # ---- (c) training: world 1 on this card, two gloo ranks on it, one NCCL rank a card
    train = phase_dp_train(torch, np, smi, count, n)
    torch.backends.cudnn.allow_tf32 = True
    emit(dp_phase_s=time.perf_counter() - t_phase)
    return {"pinned": pinned, **train}


# ------------------------------------------------------------------ phase 19
def record_cgm_calls(torch, request):
    """Runs request() once with the CGM wrapper's kernel entry recording
    copies of its arguments; returns the recorded calls. The recording
    launches nothing, so request() may be a counted run."""
    from faster_orefsdet_tpu_torch.ops import cgm_cuda

    launch, seen = cgm_cuda._launch, []

    def wrapped(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return launch(*args)

    cgm_cuda._launch = wrapped
    try:
        request()
        torch.cuda.synchronize()
    finally:
        cgm_cuda._launch = launch
    return seen


def record_roi_calls(torch, request):
    """Runs request() once with K3's launch entry recording copies of its
    arguments and of its result (launches made while a CUDA graph is being
    captured are not recorded); returns [(maps, boxes, levels, scales, P,
    sampling_ratio, out)]. The recording launches nothing, so request() may
    be a counted run."""
    from faster_orefsdet_tpu_torch.ops import roi_align_cuda

    launch, seen = roi_align_cuda._launch, []

    def wrapped(features, boxes, levels, scales, p, ratio):
        out = launch(features, boxes, levels, scales, p, ratio)
        if not torch.cuda.is_current_stream_capturing():
            seen.append(([f.clone() for f in features], boxes.clone(), None if levels is None else levels.clone(),
                         list(scales), p, ratio, out.clone()))
        return out

    roi_align_cuda._launch = wrapped
    try:
        request()
        torch.cuda.synchronize()
    finally:
        roi_align_cuda._launch = launch
    return seen


def roi_check(torch, got, maps, boxes, levels, scales, p, ratio) -> dict:
    """K3's result `got` against its plain version run on the CPU, by the
    card test's limits (tests/test_torch_roi_align_cuda.py): f32 within
    1e-5 + 1e-5 |ref|; bf16 no further from the f64 result than the dense
    bf16 path plus one bf16 ulp plus that f32 tolerance."""
    from faster_orefsdet_tpu_torch.ops import roi_align_cuda

    maps, boxes = [m.cpu() for m in maps], boxes.cpu()
    levels = None if levels is None else levels.cpu()
    ref = roi_align_cuda.roi_align_plain(maps, boxes, levels, scales, p, ratio).double()
    if got.dtype == torch.float32:
        ref64, allowed = ref, 0.0
    else:
        ref64 = roi_align_cuda.roi_align_plain([m.double() for m in maps], boxes, levels, scales, p, ratio)
        ulp = torch.where(ref64 == 0, torch.zeros_like(ref64), torch.exp2(torch.floor(torch.log2(ref64.abs())) - 7))
        allowed = (ref - ref64).abs() + ulp
    err = (got.cpu().double() - ref64).abs()
    return {"shape": list(got.shape), "dtype": str(got.dtype)[6:], "levels": len(maps),
            "max_abs_err": float(err.max()), "out_of_bound": int((err > allowed + 1e-5 + 1e-5 * ref64.abs()).sum())}


def record_dsa_calls(torch, request):
    """Runs request() with the DSA head's forward recording its arguments
    (calls made while a CUDA graph is being captured are not recorded);
    returns [(head, features, boxes, support_8, stage, fold)]. The recording
    launches nothing."""
    from faster_orefsdet_tpu_torch.models.cascade_roi import DSACascadeHead

    forward, seen = DSACascadeHead.forward, []

    def wrapped(head, features, boxes, support_8, support_4, stage, fold=None):
        if not torch.cuda.is_current_stream_capturing():
            seen.append((head, list(features), boxes, support_8, stage, fold))
        return forward(head, features, boxes, support_8, support_4, stage, fold)

    DSACascadeHead.forward = wrapped
    try:
        request()
        torch.cuda.synchronize()
    finally:
        DSACascadeHead.forward = forward
    return seen


def check_dsa_calls(torch, seen):
    """Each recorded DSA head call again by both routes on the request's own
    pooled rows: the fold it took (inference mode) and the chain (grad mode
    on copies, the head's parameters trainable), TF32 as the caller has it.
    Returns the worst |fold - chain| over each output's range."""
    worst = 0.0
    for head, feats, boxes, s8, stage, fold in seen:
        with torch.inference_mode():
            folded = head(feats, boxes, s8, None, stage, fold)
        with torch.enable_grad():
            chain = head([f.clone() for f in feats], boxes.clone(), s8.clone(), None, stage)
        if not chain.scores.requires_grad:
            raise AssertionError("the DSA head's chain was not taken under grad mode")
        for a, b in zip(folded, chain):
            b = b.detach()
            worst = max(worst, ((a - b).abs().max() / (b.max() - b.min())).item())
    return worst


def check_roi_calls(torch, seen):
    """Each recorded K3 call's result held by `roi_check`. Returns (checks,
    values out of the bound)."""
    checks = [roi_check(torch, out, *args) for *args, out in seen]
    return checks, sum(c["out_of_bound"] for c in checks)


def cgm_f64(torch, q, k1, k13, k31, w3, b3):
    """K1's function in f64 on the card, and the sum of each output's terms'
    |values| (|[attn | q]| . |W3|^T + |b3|); taps with a class axis give
    both class-major, as the kernel lays out its output."""
    from faster_orefsdet_tpu_torch.ops.correlation import cgm_correlate

    if k1.dim() == 2:
        parts = [cgm_f64(torch, q, *taps, w3, b3) for taps in zip(k1, k13, k31)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    a = [t.double() for t in (q, k1, k13, k31, w3, b3)]
    cat = torch.cat([cgm_correlate(*a[:4]), a[0]], dim=-1)
    return torch.relu(cat @ a[4].t() + a[5]), cat.abs() @ a[4].abs().t() + a[5].abs()


def check_cgm_calls(torch, seen):
    """Each recorded K1 call again through the kernel (f32 out), its plain
    twin (f32) and the same function in f64 on the card. A request's own
    inputs can make each output a small difference of large terms (a random
    ResNet-50's support taps reach 1e2, so attn's terms reach 1e6-1e7), where
    no f32 result holds |err| <= CGM_ATOL + CGM_RTOL |ref| (the plain twin
    does not either); the kernel is held to the bound of a dot product
    instead: |err| <= CGM_ATOL + CGM_RTOL x the sum of its terms' |values|
    (|[attn | q]| . |W3|^T + |b3|, attn's chain in f64), the plain twin's
    error reported beside it. Returns (checks, worst |err|, values out of
    the bound)."""
    from faster_orefsdet_tpu_torch.ops import cgm_cuda

    checks, worst, bad_total = [], 0.0, 0
    for q, k1, k13, k31, w3, b3, _ in seen:
        out = cgm_cuda.cgm_correlate_fused(q, k1, k13, k31, w3, b3, out_dtype=torch.float32)
        plain = cgm_cuda.cgm_fused_plain(q, k1, k13, k31, w3, b3, out_dtype=torch.float32)
        ref, terms = cgm_f64(torch, q, k1, k13, k31, w3, b3)
        err, plain_err = (out.double() - ref).abs(), (plain.double() - ref).abs()
        bad = int((err > CGM_ATOL + CGM_RTOL * terms).sum())
        worst, bad_total = max(worst, float(err.max())), bad_total + bad
        checks.append({"shape": list(q.shape), "classes": k1.shape[0] if k1.dim() == 2 else 1,
                       "q_dtype": str(q.dtype)[6:], "max_abs_err": float(err.max()),
                       "max_err_of_terms": float((err / terms).max()),
                       "plain_f32_max_abs_err": float(plain_err.max()),
                       "plain_f32_max_err_of_terms": float((plain_err / terms).max()),
                       "largest_terms_sum": float(terms.max()), "out_of_bound": bad})
    return checks, worst, bad_total


def nms_row(torch, args, thr) -> dict:
    """A timing row of K2 on one site's own inputs (boxes, scores, valid on
    the card, [B, K]): device-only ms, event ms, the plain fixpoint's ms and
    the bound of the work this data needs (IoU per pair of valid boxes, rank
    compares among them, per image)."""
    from faster_orefsdet_tpu_torch.ops import nms_cuda
    from faster_orefsdet_tpu_torch.ops.nms import nms_mask as nms_plain

    boxes, scores, valid = args
    b, k = scores.shape
    nv = [int(v) for v in valid.sum(-1)]
    ms = graph_ms(torch, lambda: nms_cuda.nms_mask(boxes, scores, valid, thr))
    row = {"batch": b, "k": k, "thr": thr, "valid": nv, "ms": ms,
           "enqueue_ms": enqueue_ms(torch, lambda: nms_cuda.nms_mask(boxes, scores, valid, thr), 50),
           "plain_ms": enqueue_ms(torch, lambda: nms_plain(boxes, scores, valid, thr), 10),  # syncs: no graph
           **bound(b * k * (16 + 4 + 1 + 1), sum(n * (n - 1) // 2 * 13 + n * n * 3 for n in nv))}
    row["share_of_bound"] = row["bound_ms"] / ms
    return row


def held_nms_sites(torch, seen, expected, what):
    """check_nms_calls on a request's recorded K2 calls: each bit for bit,
    and the kernel's sites exactly `expected` ([(shape, thr), ...])."""
    checks, worst = check_nms_calls(torch, seen)
    sites = [(c["shape"], c["thr"]) for c in checks if c["site"] == "kernel"]
    if sites != expected or any(c["mismatches"] for c in checks):
        raise AssertionError(f"{what}: the NMS kernel's sites {sites} (expected {expected}) or mismatches: {checks}")
    return checks, worst


def caches_close(torch, caches, what) -> dict:
    """A support cache card vs CPU, field by field: phase 5's rtol 1e-3 and
    atol 2e-4, the atol taken of the field's largest |value| where that is
    above 1 (a random ResNet-50's SM-refined maps reach 1e2, and f32 sums
    of such terms differ by more than 2e-4 near 0)."""
    res = {}
    for name in caches["cpu"]._fields:
        a, b = getattr(caches["cuda"], name).float().cpu(), getattr(caches["cpu"], name).float()
        largest = max(1.0, float(b.abs().max()))
        res[name] = {"max_abs_diff": float((a - b).abs().max()), "largest": largest,
                     "ok": bool(torch.allclose(a, b, rtol=1e-3, atol=2e-4 * largest))}
    if not all(r["ok"] for r in res.values()):
        raise AssertionError(f"{what} support cache card vs CPU: {res}")
    return res


def phase_resnet(torch, np, smi):
    """The ResNet-50 family at full width: finetune_R_50_C4_1x served with
    the CGM kernel (eager and pinned, batch 1 and 8) and trained (eager and
    graphed), mnv3_fpn served, the AttentionRPN baseline's cache, inference
    and training step; each card vs CPU, both kernels held on each path's
    own inputs, K2 timed at each new site."""
    from faster_orefsdet_tpu_torch.config import Config, SolverConfig, get_config, serving_vovnet
    from faster_orefsdet_tpu_torch.config_yaml import load_yaml
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda
    from faster_orefsdet_tpu_torch.pipelines import attention_rpn as arpn
    from faster_orefsdet_tpu_torch.pipelines.inference import (
        build_batched_inference_fn, build_inference_fn, build_pinned_inference_fn, normalize_uint8,
        pack_detections, unpack_detections_np,
    )
    from faster_orefsdet_tpu_torch.pipelines.preprocess import ceil_to, preprocess_device, resize_shortest_edge_size
    from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache
    from faster_orefsdet_tpu_torch.pipelines.train_step import (
        TrainBatch, build_train_state, build_train_step_scan, loss_fn, make_train_model,
    )
    from faster_orefsdet_tpu_torch.solver import build_optimizer, set_lr, sgd_update
    from faster_orefsdet_tpu_torch.utils.params import init_baseline_params, init_params

    t_phase = time.perf_counter()
    out = {"launches": {}, "graph_launches": {}, "k2": {}, "cgm_err": 0.0, "cgm_mismatches": 0, "nms_err": 0.0,
           "nms_mismatches": 0}

    def held(worst, checks):  # K2's checks at a site, into the kernel line's totals
        out["nms_err"] = max(out["nms_err"], worst)
        out["nms_mismatches"] += sum(c["mismatches"] for c in checks)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(19)
    h, w = CANVAS_HW

    # ---- finetune_R_50_C4_1x served with the CGM kernel (f32, TF32 off for the comparisons)
    t0 = time.perf_counter()
    cfg = get_config(R50_CONFIG).replace(use_pallas_cgm=True)
    params = init_params(cfg, seed=0)
    sup, sup_boxes = support_inputs(torch, np, cfg, cfg.fs.support_shot, rng)
    cache = build_support_cache(cfg, params, sup, sup_boxes)
    serve1, serve8 = build_inference_fn(cfg, params), build_batched_inference_fn(cfg, params)
    u8 = torch.from_numpy(rng.integers(0, 256, (8, 3, h, w), dtype=np.uint8)).cuda()
    hw8 = torch.tensor([IMAGE_HW] * 8, device="cuda")
    single = normalize_uint8(u8[:1], hw8[:1], cfg)[0].contiguous()
    eager, cgm_seen, nms_seen = [], [], {}

    def r50_requests():
        eager.append(pack_detections(serve1(cache, single, IMAGE_HW)))
        eager.append(pack_detections(serve8(cache, u8, hw8)))

    launches = count_launches(cgm_cuda, nms_cuda, lambda: cgm_seen.extend(record_cgm_calls(
        torch, lambda: nms_seen.update(record_nms_calls(torch, r50_requests)))))
    out["launches"]["r50_serve"] = launches
    cgm_checks, cgm_worst, cgm_bad = check_cgm_calls(torch, cgm_seen)
    out["cgm_err"], out["cgm_mismatches"] = max(out["cgm_err"], cgm_worst), out["cgm_mismatches"] + cgm_bad
    names = {"decode": (cfg.static.nms_budget_test, cfg.centernet.nms_thresh_test),
             "roi": (cfg.centernet.post_nms_topk_test, cfg.roi.nms_thresh_test)}
    r50_sites = [(f"r50_{name}_b{b}", [b, k], thr) for b in (1, 8) for name, (k, thr) in names.items()]
    nms_checks, worst = held_nms_sites(torch, nms_seen, [site[1:] for site in r50_sites], R50_CONFIG)
    held(worst, nms_checks)
    finite = all(bool(torch.isfinite(p).all()) for p in eager)
    n_valid = [int(v) for p in eager for v in p.reshape(-1, 100, 7)[..., 6].sum(-1)]
    emit(resnet_r50_serve={"config": R50_CONFIG, "canvas": list(CANVAS_HW), "shots": cfg.fs.support_shot,
                           "launches": launches, "cgm_checks": cgm_checks, "nms_checks": nms_checks,
                           "valid_per_image": n_valid, "all_finite": finite})
    if launches != kernels(3 + 3, 2 + 2, 1 + 1) or cgm_bad or not finite or min(n_valid) < 1:
        raise AssertionError(f"{R50_CONFIG} serving: launches {launches}, CGM out of its bound {cgm_bad}, "
                             f"finite {finite}, valid {n_valid}")
    for (site, _, thr), args in zip(r50_sites, nms_seen["kernel"]):
        out["k2"][site] = {"launches": 1, **nms_row(torch, args[:3], thr)}  # one a request of its batch

    # pinned against eager, the same inputs
    pinned = build_pinned_inference_fn(cfg, params, cache, packed=True)
    got = [pinned(single, IMAGE_HW), pinned(u8, hw8)]
    torch.cuda.synchronize()
    checks = []
    for a, b in zip(got, eager):
        ga, gb = unpack_detections_np(a.reshape(-1, 100, 7)), unpack_detections_np(b.reshape(-1, 100, 7))
        checks += [match(np, {k: v[i] for k, v in ga.items()}, {k: v[i] for k, v in gb.items()}, PINNED_DSCORE)
                   for i in range(len(ga["valid"]))]
    identical = sum(int((a == b).sum()) for a, b in zip(got, eager))
    graph_launches = [g.launches for g in pinned.graphs.values()]
    emit(resnet_r50_pinned={"images_checked": len(checks), "all_matched": all(c["ok"] for c in checks),
                            "max_dscore": max(c["max_dscore"] for c in checks), "bit_identical_values": identical,
                            "values": sum(a.numel() for a in got), "graphs_captured_launches": graph_launches})
    if not all(c["ok"] for c in checks) or any(g != kernels(3, 2, 1) for g in graph_launches):
        raise AssertionError(f"{R50_CONFIG} pinned vs eager: {checks}, graphs {graph_launches}")
    out["graph_launches"]["r50_pinned_replays"] = pinned.kernel_launches()

    # card vs CPU in f32 by phase 5's criteria
    caches = {"cuda": cache, "cpu": build_support_cache(cfg, params, sup, sup_boxes, device="cpu")}
    emit(resnet_r50_cache_card_vs_cpu=caches_close(torch, caches, R50_CONFIG))
    dets = {"cuda": serve1(cache, single, IMAGE_HW),
            "cpu": build_inference_fn(cfg, params, device="cpu")(caches["cpu"], single.cpu(), IMAGE_HW)}
    r50_vs_cpu = match(np, *(unpack_detections_np(pack_detections(dets[d])) for d in ("cuda", "cpu")), MATCH_DSCORE)
    emit(resnet_r50_card_vs_cpu=r50_vs_cpu)
    if not r50_vs_cpu["ok"]:
        raise AssertionError(f"{R50_CONFIG} card and CPU detections do not match: {r50_vs_cpu}")

    # request times under the library's defaults (TF32 convs), a pinned function captured under them
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    e1, e8 = request_times(torch, lambda: serve1(cache, single, IMAGE_HW), 10), \
        request_times(torch, lambda: serve8(cache, u8, hw8), 5)
    timed_pinned = build_pinned_inference_fn(cfg, params, cache, packed=True)
    p1, p8 = request_times(torch, lambda: timed_pinned(single, IMAGE_HW), 20), \
        request_times(torch, lambda: timed_pinned(u8, hw8), 10)
    out["graph_launches"]["r50_pinned_replays"] = {
        k: v + timed_pinned.kernel_launches()[k] for k, v in out["graph_launches"]["r50_pinned_replays"].items()}
    out["r50_serve"] = {"batch1_ms_median": e1[0], "batch8_ms_median": e8[0], "batch8_images_per_s": 8e3 / e8[0],
                        "pinned_batch1_ms_median": p1[0], "pinned_batch8_ms_median": p8[0],
                        "pinned_batch8_images_per_s": 8e3 / p8[0],
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(resnet_r50_e2e={"config": R50_CONFIG, "dtype": "float32", "canvas": list(CANVAS_HW), **out["r50_serve"],
                         "serve_s": time.perf_counter() - t0, "card": smi})

    # ---- finetune_R_50_C4_1x trained at 448x608 (f32; TF32 convs as phase 13 trains)
    t0 = time.perf_counter()
    tcfg = get_config(R50_CONFIG)
    records, mapper = train_data(tcfg)
    state, _, times, rows, batches, launches, peak = eager_steps(torch, np, tcfg, params, records, mapper,
                                                                 R50_WARMUP, R50_STEPS)
    finite = all(np.isfinite(v) for m in rows for v in m.values())
    if not finite or launches != kernels(0, len(rows)):
        raise AssertionError(f"{R50_CONFIG} train steps: finite {finite}, launches {launches}")
    out["launches"]["r50_train"] = launches
    batch = batches[0]
    with torch.no_grad():
        nms_checks, worst, seen = nms_checks_on_request(torch, lambda: loss_fn(state.model, batch, state.generator))
    train_site = ([1, TRAIN_NMS_K], tcfg.centernet.nms_thresh_train)
    if [(c["shape"], c["thr"]) for c in nms_checks] != [train_site] or nms_checks[0]["mismatches"]:
        raise AssertionError(f"{R50_CONFIG} training decode: {nms_checks}")
    held(worst, nms_checks)
    out["k2"]["r50_train_decode"] = {"launches_per_step": 1, **nms_row(torch, seen["kernel"][0][:3], train_site[1])}
    eager_ms = statistics.median(times)

    rois = train_rois(torch, np, batch, tcfg.roi.batch_size_per_image, seed=13)

    def r50_step_on(dev, dtype):
        model = make_train_model(tcfg, params, device=dev).to(dtype)
        total, losses = loss_fn(model, batch.to(dev), deterministic=True, injected_rois=tuple(r.to(dev) for r in rois))
        total.backward()
        return model, losses

    train_card_vs_cpu(torch, r50_step_on, "resnet_r50_train_card_vs_cpu", witness=True)

    eq_batches = take_batches(records, mapper, sum(R50_EQ_CHUNKS), seed=3)
    res = graphed_vs_eager(torch, tcfg, params, eq_batches, R50_EQ_CHUNKS, deterministic=True)
    emit(resnet_r50_graphed_vs_eager=res)
    if not res["ok"]:
        raise AssertionError(f"{R50_CONFIG} graphed vs eager under cudnn.deterministic: {res}")
    out["graph_launches"]["r50_train_graphed"] = res["launches"]

    gstate, step_k = build_train_state(tcfg, params), build_train_step_scan(tcfg)
    step_k(gstate, eq_batches[:2])  # the eager warm-up steps
    step_k(gstate, eq_batches[2:4])  # the capture and its first replays
    torch.cuda.reset_peak_memory_stats()
    graphed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_k(gstate, eq_batches[:GRAPH_K])
        torch.cuda.synchronize()
        graphed.append((time.perf_counter() - t) * 1e3 / GRAPH_K)
    out["graph_launches"]["r50_train_graphed"] = {
        k: v + step_k.kernel_launches()[k] for k, v in out["graph_launches"]["r50_train_graphed"].items()}
    out["r50_train"] = {"eager_step_ms_median": eager_ms, "eager_queries_per_s": 1e3 / eager_ms,
                        "eager_peak_mem_gb": peak, "graphed_step_ms_median": statistics.median(graphed),
                        "graphed_queries_per_s": 1e3 / statistics.median(graphed),
                        "graphed_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(resnet_r50_train={"config": R50_CONFIG, "canvas": list(TRAIN_CANVAS), "shots": tcfg.fs.support_shot,
                           "steps": len(rows), **out["r50_train"], "total_loss_trace": [m["total_loss"] for m in rows],
                           "train_s": time.perf_counter() - t0, "card": smi})

    # ---- mnv3_fpn served at batch 1 (K1 at 128 channels), card vs CPU in f32
    torch.backends.cudnn.allow_tf32 = False
    mcfg = serving_vovnet().replace(backbone_name="mnv3_fpn", compute_dtype="float32")
    mparams = init_params(mcfg, seed=0)
    msup, mboxes = support_inputs(torch, np, mcfg, 5, rng)
    mcaches = {d: build_support_cache(mcfg, mparams, msup, mboxes, device=d) for d in ("cuda", "cpu")}
    mserve = {d: build_inference_fn(mcfg, mparams, device=d) for d in ("cuda", "cpu")}
    mdet = {}
    launches = count_launches(cgm_cuda, nms_cuda, lambda: mdet.update(
        cuda=mserve["cuda"](mcaches["cuda"], single, IMAGE_HW)))
    mdet["cpu"] = mserve["cpu"](mcaches["cpu"], single.cpu(), IMAGE_HW)
    mnv3_vs_cpu = match(np, *(unpack_detections_np(pack_detections(mdet[d])) for d in ("cuda", "cpu")), MATCH_DSCORE)
    emit(resnet_mnv3_serve={"backbone": "mnv3_fpn", "launches": launches, "card_vs_cpu": mnv3_vs_cpu})
    if launches != kernels(3, 2, 1) or not mnv3_vs_cpu["ok"]:
        raise AssertionError(f"mnv3_fpn serving: launches {launches}, card vs CPU {mnv3_vs_cpu}")
    out["launches"]["mnv3_serve"] = launches

    # ---- the AttentionRPN baseline (Base-FSOD-C4.yaml): cache, inference, a training step
    t0 = time.perf_counter()
    bcfg = load_yaml(BASELINE_YAML)
    bparams = init_baseline_params(bcfg.depth, seed=0)
    pixels = Config().input
    bsup, bboxes = support_inputs(torch, np, Config(), bcfg.support_shot, rng)  # 240 crops on 256 canvases
    bcaches = {d: arpn.build_baseline_cache(bcfg, bparams, bsup, bboxes, device=d) for d in ("cuda", "cpu")}
    emit(resnet_baseline_cache_card_vs_cpu=caches_close(torch, bcaches, "the baseline"))
    frames, gt_lists = synthetic_frames(np, 2, seed=23)
    out_hw = resize_shortest_edge_size(*FRAME_HW, BASELINE_SHORT, BASELINE_MAX)
    canvas_hw = (ceil_to(out_hw[0]), ceil_to(out_hw[1]))
    u8frames = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).cuda()
    canvases = preprocess_device(u8frames, out_hw, canvas_hw, pixels.pixel_mean, pixels.pixel_std).contiguous()
    bserve = {d: arpn.build_baseline_inference_fn(bcfg, bparams, device=d) for d in ("cuda", "cpu")}
    bdet, bseen = {}, {}
    launches = count_launches(cgm_cuda, nms_cuda, lambda: bseen.update(record_nms_calls(
        torch, lambda: bdet.update(cuda=bserve["cuda"](bcaches["cuda"], canvases[0], out_hw)))))
    bdet["cpu"] = bserve["cpu"](bcaches["cpu"], canvases[0].cpu(), out_hw)
    base_sites = [([1, bcfg.rpn_pre_nms_topk_test], bcfg.rpn_nms_thresh),
                  ([1, bcfg.rpn_post_nms_topk_test], bcfg.test_nms_thresh)]
    nms_checks, worst = held_nms_sites(torch, bseen, base_sites, "the baseline's request")
    held(worst, nms_checks)
    base_vs_cpu = match(np, *(unpack_detections_np(pack_detections(bdet[d])) for d in ("cuda", "cpu")), MATCH_DSCORE,
                        by_class=True)
    emit(resnet_baseline_serve={"yaml": BASELINE_YAML, "shots": bcfg.support_shot, "support_canvas": list(bsup.shape[-2:]),
                                "canvas": list(canvas_hw), "resized": list(out_hw), "launches": launches,
                                "nms_checks": nms_checks, "card_vs_cpu": base_vs_cpu})
    if launches != kernels(0, 2, 1) or not base_vs_cpu["ok"]:
        raise AssertionError(f"the baseline's request: launches {launches}, card vs CPU {base_vs_cpu}")
    out["launches"]["baseline_serve"] = launches
    for (shape, thr), args, site in zip(base_sites, bseen["kernel"], ("baseline_rpn_test", "baseline_final")):
        out["k2"][site] = {"launches": 1, **nms_row(torch, args[:3], thr)}
    torch.backends.cudnn.allow_tf32 = True
    b1 = request_times(torch, lambda: bserve["cuda"](bcaches["cuda"], canvases[1], out_hw), 10)
    out["baseline_serve"] = {"request_ms_median": b1[0], "request_ms_min": b1[1], "request_ms_max": b1[2]}
    out["baseline_request"] = {"cfg": bcfg, "params": bparams, "cache": bcaches["cuda"], "canvas": canvases[0],
                               "image_hw": out_hw}

    # one training step at the same query size, 10 shots: card vs CPU with the same anchor draws and ROIs
    scale = out_hw[0] / FRAME_HW[0]
    gt = np.zeros((1, 8, 4), np.float32)
    gtv = np.zeros((1, 8), bool)
    n_gt = min(8, len(gt_lists[0]))
    gt[0, :n_gt] = np.asarray(gt_lists[0][:n_gt], np.float32) * scale
    gtv[0, :n_gt] = True
    bbatch = TrainBatch(canvases[:1], torch.tensor([out_hw], dtype=torch.float32, device="cuda"),
                        torch.from_numpy(gt).cuda(), torch.zeros(1, 8, dtype=torch.int32, device="cuda"),
                        torch.from_numpy(gtv).cuda(), bsup[None].cuda(), bboxes[None].cuda())
    brois = train_rois(torch, np, bbatch, bcfg.roi_batch_size, seed=29)

    def baseline_step_on(dev, dtype):
        model = arpn.make_fsod_rcnn(bcfg, bparams, device=dev).to(dtype).train()
        total, losses = arpn.baseline_loss_fn(model, bbatch.to(dev), bcfg, torch.Generator().manual_seed(5),
                                              injected_rois=tuple(r.to(dev) for r in brois))
        total.backward()
        return model, losses

    train_card_vs_cpu(torch, baseline_step_on, "resnet_baseline_train_card_vs_cpu", zero_grad=BASELINE_ZERO_GRAD,
                      witness=True)

    model = arpn.make_fsod_rcnn(bcfg, bparams).train()
    solver = dataclasses.replace(SolverConfig(), base_lr=BASELINE_LR)
    optimizer = build_optimizer(solver, model)
    set_lr(optimizer, BASELINE_LR)
    generator = torch.Generator(device="cuda").manual_seed(7)

    def bstep():
        optimizer.zero_grad(set_to_none=True)
        total, _ = arpn.baseline_loss_fn(model, bbatch, bcfg, generator)
        total.backward()
        sgd_update(optimizer, solver)
        return total.detach()

    step_ms, trace = [], []

    def steps():
        for i in range(sum(BASELINE_STEPS)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            trace.append(bstep())
            torch.cuda.synchronize()
            if i >= BASELINE_STEPS[0]:
                step_ms.append((time.perf_counter() - t) * 1e3)

    torch.cuda.reset_peak_memory_stats()
    launches = count_launches(cgm_cuda, nms_cuda, steps)
    bpeak = torch.cuda.max_memory_allocated() / 1e9
    trace = torch.stack(trace).tolist()
    if launches != kernels(0, len(trace)) or not all(np.isfinite(trace)):
        raise AssertionError(f"the baseline's train steps: launches {launches}, losses {trace}")
    out["launches"]["baseline_train"] = launches
    with torch.no_grad():
        nms_checks, worst, seen = nms_checks_on_request(torch, lambda: arpn.baseline_loss_fn(model, bbatch, bcfg,
                                                                                            generator))
    train_site = ([1, bcfg.rpn_pre_nms_topk_train], bcfg.rpn_nms_thresh)
    if [(c["shape"], c["thr"]) for c in nms_checks] != [train_site] or nms_checks[0]["mismatches"]:
        raise AssertionError(f"the baseline's training RPN: {nms_checks}")
    held(worst, nms_checks)
    out["k2"]["baseline_rpn_train"] = {"launches_per_step": 1, **nms_row(torch, seen["kernel"][0][:3], train_site[1])}
    out["baseline_train"] = {"step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
                             "queries_per_s": 1e3 / statistics.median(step_ms), "peak_mem_gb": bpeak,
                             "total_loss_trace": trace}
    emit(resnet_baseline={"serve": out["baseline_serve"], "train": out["baseline_train"],
                          "baseline_s": time.perf_counter() - t0, "card": smi})
    for site, row in out["k2"].items():
        emit(timing="nms", site=site, **row, card=smi)
    emit(resnet_phase_s=time.perf_counter() - t_phase)
    return out


# ------------------------------------------------------------------ phase 20
def onestage_cfg(cfg, num_classes: int, dtype: str = "float32"):
    """cfg as the one-stage detector over P3-P7 (fpn.top_levels=2, strides
    8-128, canvases a multiple of 128) with `num_classes` classes."""
    return cfg.replace(
        compute_dtype=dtype,
        fpn=dataclasses.replace(cfg.fpn, top_levels=2),
        centernet=dataclasses.replace(cfg.centernet, in_features=ONESTAGE_LEVELS, fpn_strides=ONESTAGE_STRIDES,
                                      only_proposal=False, num_classes=num_classes),
        input=dataclasses.replace(cfg.input, size_divisibility=ONESTAGE_STRIDES[-1]),
    )


def zoo_card_vs_cpu(torch, make, x, what) -> dict:
    """A module of the zoo card vs CPU in f32 (TF32 off): each output within
    ZOO_TOL of its largest |value|, or within DLA_F32_FACTOR x the CPU's own
    f32 vs f64 error (phase 15's witness, computed only where ZOO_TOL is
    exceeded) where that is larger. make() -> the module with its weights;
    its forward returns a dict of maps or one map."""
    def run(dev, dtype):
        model = make().to(device=dev, dtype=dtype).eval()
        with torch.no_grad():
            y = model(x.to(device=dev, dtype=dtype))
        return {k: v.double().cpu() for k, v in (y.items() if isinstance(y, dict) else [("out", y)])}

    card, cpu = run("cuda", torch.float32), run("cpu", torch.float32)
    res = {}
    for k, ref in cpu.items():
        largest = float(ref.abs().max())
        err = float((card[k] - ref).abs().max())
        res[k] = {"shape": list(ref.shape), "max_abs_err": err, "largest": largest, "limit": ZOO_TOL * largest}
    beyond = [k for k, r in res.items() if r["max_abs_err"] > r["limit"]]
    if beyond:
        f64 = run("cpu", torch.float64)
        for k in beyond:
            witness = float((cpu[k] - f64[k]).abs().max())
            res[k].update(cpu_f32_vs_f64=witness, limit=max(res[k]["limit"], DLA_F32_FACTOR * witness))
    bad = {k: r for k, r in res.items() if r["max_abs_err"] > r["limit"]}
    if bad:
        raise AssertionError(f"{what} card vs CPU: {bad}")
    return res


def onestage_dla_request(torch, np, smi) -> dict:
    """CenterNet-S4 over DLA-34-DCN (``backbone_name="dla_seg"``) as the
    benchmark's one-stage cell serves it: eight VGA frames a request through
    ``build_pinned_onestage_serving_fn`` at the test size 608 (the 608x832
    canvas), 80 classes, TF32 convs. The eager request (the same raw-frame
    body, not captured) counted, its K2 inputs recorded and held bit for bit
    against the plain twin on the card and on the CPU: the class-aware call
    ([8, 1000] at IoU 0.6) and the launch on its class-offset boxes (up to
    79 offsets of the largest coordinate + 1). The pinned request equal to
    the eager one bit for bit, at its capture and at a replay, its graph's
    captured launches equal to the eager request's, and
    ONESTAGE_DLA_DEFORM deformable convs and samples a body, eager and
    captured."""
    from faster_orefsdet_tpu_torch.config import apply_overrides, get_config
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, deform_conv, nms_cuda
    from faster_orefsdet_tpu_torch.pipelines import onestage
    from faster_orefsdet_tpu_torch.pipelines.graphs import CAPTURES, WARMUP_CALLS
    from faster_orefsdet_tpu_torch.pipelines.inference import pack_detections, raw_frame_body
    from faster_orefsdet_tpu_torch.utils.params import init_onestage_params

    cfg = apply_overrides(get_config("finetune_dla"), list(ONESTAGE_DLA_OVERRIDES))
    params = init_onestage_params(cfg, seed=23)
    frames, _ = synthetic_frames(np, ONESTAGE_DLA_BATCH, seed=23)
    u8 = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).contiguous().cuda()
    torch.backends.cudnn.allow_tf32 = True
    dev, run = onestage._onestage_body(cfg, params, "cuda")
    eager, canvas = raw_frame_body(run, FRAME_HW, cfg.input, dev)
    pinned, pinned_canvas = onestage.build_pinned_onestage_serving_fn(cfg, params, FRAME_HW)
    counter = deform_conv.counter

    def deform(before, bodies):
        return [(counter.calls - before[0]) / bodies, (counter.samples - before[1]) / bodies]

    seen, ref = {}, []
    before = (counter.calls, counter.samples)
    launches = count_launches(cgm_cuda, nms_cuda, lambda: seen.update(record_nms_calls(
        torch, lambda: ref.append(pack_detections(eager(u8))))))
    deform_eager = deform(before, 1)
    before = (counter.calls, counter.samples)
    got = [pack_detections(pinned(u8)) for _ in range(2)]  # the capture's call, then a replay
    torch.cuda.synchronize()
    deform_pinned = deform(before, len(pinned.graphs) * (WARMUP_CALLS + CAPTURES))
    checks, worst = check_nms_calls(torch, seen)
    shifted = seen["kernel"][0][0]
    row = {"canvas": list(canvas), "launches": launches,
           "graphs_captured_launches": [g.launches for g in pinned.graphs.values()],
           "nms_checks": [[c["site"], c["shape"], c["thr"], c["kept"], c["mismatches"]] for c in checks],
           "nms_max_abs_err": worst, "largest_shifted_coordinate": float(shifted.max()),
           "bit_identical": [bool(torch.equal(g, ref[0])) for g in got],
           "all_finite": bool(torch.isfinite(ref[0]).all()),
           "valid_per_frame": [int(v) for v in ref[0][:, :, 6].sum(1)],
           "deform_per_body": {"eager": deform_eager, "captured": deform_pinned}}
    med, lo, hi = request_times(torch, lambda: pinned(u8), 5)
    row.update(pinned_ms_median=med, pinned_ms_min=lo, pinned_ms_max=hi, card=smi)
    emit(onestage_dla=row)
    expect_deform = [float(n) for n in ONESTAGE_DLA_DEFORM]
    if (tuple(canvas) != ONESTAGE_DLA_CANVAS or pinned_canvas != canvas or launches != kernels(0, 1)
            or row["graphs_captured_launches"] != [launches]
            or [c["shape"] for c in checks] != [[ONESTAGE_DLA_BATCH, 1000]] * 2):
        raise AssertionError(f"one-stage DLA: canvas, launches or K2 sites: {row}")
    if any(c["mismatches"] for c in checks) or not all(row["bit_identical"]) or not row["all_finite"]:
        raise AssertionError(f"one-stage DLA: K2 against its twin or pinned against eager: {row}")
    if deform_eager != expect_deform or deform_pinned != expect_deform:
        raise AssertionError(f"one-stage DLA: deformable convs a body {row['deform_per_body']}, "
                             f"expected {expect_deform}")
    return row


def phase_onestage(torch, np, smi):
    """The one-stage CenterNet over P3-P7 at full width on six VGA frames
    (1 and 9 classes: K2 at its register and wide sweep), the P7 canvas
    refusal, CenterNet-S4 over DLA-34-DCN at batch 8 pinned against eager
    (``onestage_dla_request``), the rest of the backbone zoo and the
    attention zoo at the published widths, the federated loss, the profiling
    utilities and the native COCO matcher, each card vs CPU."""
    import tempfile

    from faster_orefsdet_tpu_torch.config import get_config, serving_vovnet
    from faster_orefsdet_tpu_torch.evaluation import coco_eval
    from faster_orefsdet_tpu_torch.models.dlaup import DLASeg
    from faster_orefsdet_tpu_torch.models.fpn import FPN
    from faster_orefsdet_tpu_torch.models.regnet import RegNet
    from faster_orefsdet_tpu_torch.models.res2net import Res2Net
    from faster_orefsdet_tpu_torch.models.vovnet import VOVNET_STAGE_SPECS, VoVNet
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, fed_loss, nms_cuda
    from faster_orefsdet_tpu_torch.ops.attention import CBAMBlock, CoTAttention
    from faster_orefsdet_tpu_torch.ops.heatmap import level_grid_shapes
    from faster_orefsdet_tpu_torch.pipelines import onestage
    from faster_orefsdet_tpu_torch.pipelines.inference import pack_detections, rescale_detections, unpack_detections_np
    from faster_orefsdet_tpu_torch.pipelines.preprocess import ceil_to, preprocess_device, resize_shortest_edge_size
    from faster_orefsdet_tpu_torch.utils import profiling
    from faster_orefsdet_tpu_torch.utils.params import init_onestage_params, seeded_init

    t_phase = time.perf_counter()
    out = {"launches": {}, "k2": {}, "k2_args": {}, "nms_err": 0.0, "nms_mismatches": 0}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- the one-stage detector on six VGA frames, 1 and 9 classes (f32)
    frames, _ = synthetic_frames(np, ONESTAGE_FRAMES, seed=20)
    u8 = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).contiguous().cuda()
    base = onestage_cfg(get_config(ONESTAGE_CONFIG), 1)
    rh, rw = resize_shortest_edge_size(*FRAME_HW, base.input.min_size_test, base.input.max_size_test)
    d = base.input.size_divisibility
    canvas = (ceil_to(rh, d), ceil_to(rw, d))
    canvases = preprocess_device(u8, (rh, rw), canvas, base.input.pixel_mean, base.input.pixel_std)
    hw = (float(rh), float(rw))
    shapes = level_grid_shapes(canvas, ONESTAGE_STRIDES)
    for n in ONESTAGE_CLASSES:
        cfg = onestage_cfg(get_config(ONESTAGE_CONFIG), n)
        params = init_onestage_params(cfg, seed=20)
        fns = {dev: onestage.build_onestage_inference_fn(cfg, params, device=dev) for dev in ("cuda", "cpu")}
        k = sum(min(cfg.centernet.pre_nms_topk_test, h * w * n) for h, w in shapes)
        dets, seen = [], {}

        def requests():
            for i in range(ONESTAGE_FRAMES):
                dets.append(pack_detections(fns["cuda"](canvases[i], hw)))

        launches = count_launches(cgm_cuda, nms_cuda, lambda: seen.update(record_nms_calls(torch, requests)))
        out["launches"][f"onestage_{n}class"] = launches
        checks, worst = check_nms_calls(torch, seen)
        out["nms_err"] = max(out["nms_err"], worst)
        out["nms_mismatches"] += sum(c["mismatches"] for c in checks)
        sites = [c["shape"] for c in checks if c["site"] == "kernel"]
        cpu_dets = [pack_detections(fns["cpu"](canvases[i].cpu(), hw)) for i in range(ONESTAGE_FRAMES)]
        matches = [match(np, unpack_detections_np(a), unpack_detections_np(b), MATCH_DSCORE, by_class=True)
                   for a, b in zip(dets, cpu_dets)]
        finite = all(bool(torch.isfinite(p).all()) for p in dets)
        emit(onestage={"classes": n, "canvas": list(canvas), "image_hw": [rh, rw], "k": k, "launches": launches,
                       "nms_sites": sites, "nms_mismatches": sum(c["mismatches"] for c in checks),
                       "nms_checks": len(checks), "card_vs_cpu": matches, "all_finite": finite,
                       "valid_per_frame": [int(p[:, 6].sum()) for p in dets]})
        if launches != kernels(0, ONESTAGE_FRAMES) or sites != [[1, k]] * ONESTAGE_FRAMES:
            raise AssertionError(f"one-stage {n} classes: launches {launches}, K2 sites {sites} (K = {k})")
        if any(c["mismatches"] for c in checks) or not finite or not all(m["ok"] for m in matches):
            raise AssertionError(f"one-stage {n} classes: K2 checks {checks}, card vs CPU {matches}")
        args = seen["kernel"][0]
        out["k2_args"][f"onestage{n}"] = args
        out["k2"][f"onestage{n}"] = {"launches": ONESTAGE_FRAMES, **nms_row(torch, args[:3], args[3])}
        emit(timing="nms", site=f"onestage{n}", **out["k2"][f"onestage{n}"], card=smi)

    # the refusal: at P7 a 320x448 canvas (the P3-P5 serving canvas of a VGA frame)
    try:
        fns["cuda"](torch.zeros(3, *CANVAS_HW, device="cuda"), IMAGE_HW)
        raise AssertionError("the one-stage detector took a 320x448 canvas at P7")
    except ValueError as e:
        if "size_divisibility" not in str(e):
            raise
        emit(onestage_refusal={"canvas": list(CANVAS_HW), "error": str(e)})

    # ---- CenterNet-S4 over DLA-34-DCN, the benchmark's one-stage cell's path (TF32 convs)
    out["dla"] = onestage_dla_request(torch, np, smi)

    # request times, library defaults (TF32 convs), bf16 and f32, batch 1
    torch.backends.cudnn.allow_tf32 = True
    times = {}
    for n in ONESTAGE_CLASSES:
        for dtype in ("bfloat16", "float32"):
            cfg = onestage_cfg(get_config(ONESTAGE_CONFIG), n, dtype)
            fn = onestage.build_onestage_inference_fn(cfg, init_onestage_params(cfg, seed=20))
            torch.cuda.reset_peak_memory_stats()
            med, lo, hi = request_times(torch, lambda: fn(canvases[0], hw), 10)
            times[f"{n}class_{dtype}"] = {"ms_median": med, "ms_min": lo, "ms_max": hi,
                                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["times"] = times
    out["canvases"], out["image_hw"] = canvases, hw
    emit(onestage_e2e={"config": ONESTAGE_CONFIG, "levels": list(ONESTAGE_LEVELS), "canvas": list(canvas),
                       "batch": 1, **times, "card": smi})

    # ---- the zoo at the published widths, batch 1, card vs CPU (TF32 off), ms and peak memory
    g = torch.Generator().manual_seed(20)
    x = torch.randn(1, 3, *ZOO_INPUT_HW, generator=g)
    x512 = torch.randn(1, 3, *DLASEG_INPUT_HW, generator=g)
    p3 = torch.randn(1, ZOO_ATTENTION_CHANNELS, ZOO_INPUT_HW[0] // 8, ZOO_INPUT_HW[1] // 8, generator=g)
    stages = ("stage2", "stage3", "stage4", "stage5")

    class WithFPN(torch.nn.Module):
        def __init__(self, spec):
            super().__init__()
            self.backbone = VoVNet(spec, stages[1:])
            chans = VoVNet.out_channels(spec)
            self.fpn = FPN([chans[s] for s in stages[1:]], stages[1:], 128, top_levels=2)

        def forward(self, t):
            return self.fpn(self.backbone(t))

    def seeded(module, seed):
        module.load_state_dict(seeded_init(module.state_dict(), seed), strict=True)
        return module

    zoo = {spec: (lambda s=spec: seeded(VoVNet(s, stages), 1), x)
           for spec in sorted(VOVNET_STAGE_SPECS) if spec != "V-19-slim-eSE"}
    zoo["V-19-eSE+FPN-P3-P7"] = (lambda: seeded(WithFPN("V-19-eSE"), 2), x)
    zoo["Res2Net-50"] = (lambda: seeded(Res2Net(50, ("res2", "res3", "res4", "res5")), 3), x)
    zoo["RegNetX-400MF"] = (lambda: seeded(RegNet(out_features=("s1", "s2", "s3", "s4")), 4), x)
    zoo["RegNetY-400MF"] = (lambda: seeded(RegNet(out_features=("s1", "s2", "s3", "s4"), **REGNET_Y_400MF), 5), x)
    zoo["DLASeg-34"] = (lambda: seeded(DLASeg(34), 6), x512)
    zoo["CoT-128"] = (lambda: seeded(CoTAttention(ZOO_ATTENTION_CHANNELS), 7), p3)
    zoo["CBAM-128"] = (lambda: seeded(CBAMBlock(ZOO_ATTENTION_CHANNELS), 8), p3)
    torch.backends.cudnn.allow_tf32 = False
    zoo_rows = {}
    for name, (make, inp) in zoo.items():
        t0 = time.perf_counter()
        check = zoo_card_vs_cpu(torch, make, inp, name)
        zoo_rows[name] = {"input": list(inp.shape), "card_vs_cpu": check, "check_s": time.perf_counter() - t0}
    torch.backends.cudnn.allow_tf32 = True
    for name, (make, inp) in zoo.items():
        model, xin = make().cuda().eval(), inp.cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            med, lo, hi = request_times(torch, lambda: model(xin), 5)
        zoo_rows[name].update(ms_median=med, ms_min=lo, ms_max=hi,
                              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                              params=sum(p.numel() for p in model.parameters()))
        emit(zoo={"module": name, **zoo_rows[name], "card": smi})
        del model
    out["zoo"] = zoo_rows

    # ---- the federated loss card vs CPU
    gc = torch.Generator().manual_seed(21)
    u = torch.rand(FED_CLASSES, generator=gc)
    gt = torch.randint(0, FED_CLASSES + 1, (32,), generator=gc)
    weight = torch.rand(FED_CLASSES, generator=gc) * 30 + 0.5
    masks = {dev: fed_loss.fed_loss_mask_from_uniforms(u.to(dev), gt.to(dev), FED_CLASSES, 50, weight.to(dev))
             for dev in ("cuda", "cpu")}
    scores = torch.randn(64, FED_CLASSES + 1, generator=gc) * 3
    rows = torch.randint(0, FED_CLASSES + 1, (64,), generator=gc)
    valid = torch.rand(64, generator=gc) < 0.8
    losses = {dev: float(fed_loss.sigmoid_cross_entropy_loss(scores.to(dev), rows.to(dev), valid.to(dev),
                                                             masks[dev])) for dev in ("cuda", "cpu")}
    drawn = fed_loss.fed_loss_class_mask(gt.cuda(), FED_CLASSES, 50, weight.cuda(),
                                         generator=torch.Generator(device="cuda").manual_seed(0))
    fed = {"masks_equal": bool(torch.equal(masks["cuda"].cpu(), masks["cpu"])), "losses": losses,
           "loss_rel_err": abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"]),
           "drawn_on_card": int(drawn.sum())}
    emit(fed_loss=fed)
    if not fed["masks_equal"] or fed["loss_rel_err"] > FED_LOSS_RTOL or fed["drawn_on_card"] < 50:
        raise AssertionError(f"fed loss card vs CPU: {fed}")

    # ---- profiling: a trace, the flops of a one-stage request, measure_model, device_memory
    cfg = onestage_cfg(get_config(ONESTAGE_CONFIG), 1)
    fn = onestage.build_onestage_inference_fn(cfg, init_onestage_params(cfg, seed=20))
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            fn(canvases[0], hw)
            torch.cuda.synchronize()
        trace_bytes = sum(os.path.getsize(os.path.join(log_dir, f)) for f in os.listdir(log_dir))
    cost = profiling.cost_analysis(fn, canvases[0], hw)
    measured = profiling.measure_model(serving_vovnet())
    mem = profiling.device_memory()
    prof = {"trace_bytes": trace_bytes, "onestage_request_flops": cost["flops"], "measure_model": measured,
            "device_memory": mem}
    emit(profiling=prof)
    if not (trace_bytes > 0 and cost["flops"] > 0 and measured["params"] > 0 and measured["flops"] > 0
            and "cuda:0" in mem):
        raise AssertionError(f"profiling: {prof}")

    # ---- the native COCO matcher: phase 10's eval set, the one-stage detections and jittered ground truth
    records, _, store = eval_data(np, get_config(ONESTAGE_CONFIG), EVAL_FRAMES, EVAL_SHOTS)
    eval_u8 = torch.from_numpy(np.stack([store[r.file_name] for r in records])).permute(0, 3, 1, 2).cuda()
    eval_canvases = preprocess_device(eval_u8, (rh, rw), canvas, base.input.pixel_mean, base.input.pixel_std)
    det = fn(eval_canvases, torch.tensor([hw] * len(records)))
    det = unpack_detections_np(pack_detections(rescale_detections(det, (FRAME_HW[0] / rh, FRAME_HW[1] / rw))))
    jitter = np.random.default_rng(22)
    dets, gts = [], []
    for i, r in enumerate(records):
        gt_boxes = np.asarray([a.bbox for a in r.annotations], np.float64)
        near = gt_boxes + jitter.normal(0, 3, gt_boxes.shape)
        boxes = np.concatenate([det["boxes"][i][det["valid"][i]], near])
        scores = np.concatenate([det["scores"][i][det["valid"][i]], jitter.uniform(0, 1, len(near))])
        dets.append(coco_eval.DetResult(r.image_id, boxes, scores))
        gts.append(coco_eval.GTImage(r.image_id, gt_boxes, np.zeros(len(gt_boxes), bool),
                                     (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])))
    t0 = time.perf_counter()
    lib = coco_eval._native_matcher()
    native = coco_eval.coco_ap(dets, gts)
    native_s = time.perf_counter() - t0
    coco_eval._NATIVE = None
    try:
        t0 = time.perf_counter()
        plain = coco_eval.coco_ap(dets, gts)
        plain_s = time.perf_counter() - t0
    finally:
        coco_eval._NATIVE = lib
    same = all(native[k] == plain[k] or (np.isnan(native[k]) and np.isnan(plain[k])) for k in AP_KEYS)
    emit(native_cocoeval={"library": str(getattr(lib, "_name", lib)), "frames": len(records), "native": native,
                          "numpy": plain, "equal": same, "native_s": native_s, "numpy_s": plain_s})
    if not same:
        raise AssertionError(f"coco_ap with the native matcher {native} != the numpy twin's {plain}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(onestage_phase_s=out["phase_s"])
    return out


# ------------------------------------------------------------------ phase 11, K3
# K3's rows: (name, maps' dtype, batch, ROIs an image, channels, P, canvas, strides), the three serving shapes
K3_SHAPES = (("vovnet", "bfloat16", 8, POST_NMS_TOPK, C, 8, CANVAS_HW, (8, 16, 32)),
             ("dla", "float32", 8, POST_NMS_TOPK, DLA_CHANNELS, 7, CANVAS_HW, (8, 16, 32)),
             ("baseline", "float32", 8, 100, 1024, 14, (608, 800), (16,)))


def roi_inputs(torch, np, rng, b, r, c, canvas, strides, dtype):
    """Random maps [B, C, H_l, W_l] (NCHW, as the baseline's res4 arrives;
    the gather copies them channel-last) and proposal-like boxes inside the
    canvas, 16 px to its short side, aspect 1:2 to 2:1, log-uniform; their
    levels (indices into the maps) and scales."""
    from faster_orefsdet_tpu_torch.ops.roi_align import assign_levels

    h, w = canvas
    maps = [torch.randn(b, c, h // s, w // s, device="cuda").to(getattr(torch, dtype)) for s in strides]
    size = np.exp(rng.uniform(np.log(16), np.log(min(h, w)), (b, r)))
    aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), (b, r)))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    x1, y1 = rng.uniform(0, w - np.minimum(bw, w)), rng.uniform(0, h - np.minimum(bh, h))
    boxes = np.stack([x1, y1, np.minimum(x1 + bw, w), np.minimum(y1 + bh, h)], -1)
    boxes = torch.tensor(boxes, dtype=torch.float32, device="cuda")
    levels = None
    if len(strides) > 1:
        lo = int(np.log2(strides[0]))
        levels = (assign_levels(boxes, lo, int(np.log2(strides[-1]))) - lo).contiguous()
    return maps, boxes, levels, [1.0 / s for s in strides]


def phase_k3_timing(torch, np, smi) -> dict:
    """K3 at the three serving shapes, as phase 11 times K1 and K2, after
    its result is held against the plain version by `roi_check` (the phase
    fails on a value out of the bound): device-only ms (50 calls in a CUDA
    graph, 6 at the baseline's shape), event ms (50 wrapper calls), the
    bound and the plain version's event ms; {name: row}. The maps arrive in
    NCHW, so each call's time holds their copy to channel-last, and the
    bound counts the copy's read and write beside the output and the maps
    read once."""
    from faster_orefsdet_tpu_torch.ops import roi_align_cuda

    rng = np.random.default_rng(31)
    rows = {}
    for name, dtype, b, r, c, p, canvas, strides in K3_SHAPES:
        maps, boxes, levels, scales = roi_inputs(torch, np, rng, b, r, c, canvas, strides, dtype)

        def gather():
            return roi_align_cuda.roi_align_gather(maps, boxes, levels, scales, p, 0)

        def plain():
            return roi_align_cuda.roi_align_plain(maps, boxes, levels, scales, p, 0)

        check = roi_check(torch, gather(), maps, boxes, levels, scales, p, 0)
        if check["out_of_bound"]:
            raise AssertionError(f"phase 11: K3 against the plain version at the {name} shape: {check}")
        elem = maps[0].element_size()
        out_bytes = b * r * p * p * c * elem
        copied = sum(m.numel() for m in maps if not m.is_contiguous(memory_format=torch.channels_last))
        nbytes = out_bytes + (sum(m.numel() for m in maps) + 2 * copied) * elem + boxes.numel() * 4
        # a graph holds every call's output: at most 4 GB of them (6 calls at the baseline's 642 MB)
        ms = graph_ms(torch, gather, iters=max(1, min(50, int(4e9 // out_bytes))))
        row = {"shape": [b, r, p, p, c], "dtype": dtype, "levels": len(maps), "max_abs_err": check["max_abs_err"],
               "copied_bytes": 2 * copied * elem, "ms": ms,
               "enqueue_ms": enqueue_ms(torch, gather, 50), "plain_ms": enqueue_ms(torch, plain, 5),
               **bound(nbytes, 0.0)}
        row["share_of_bound"] = row["bound_ms"] / ms
        rows[name] = row
        emit(timing="roi_align", site=name, **row, card=smi)
    torch.cuda.empty_cache()  # phase 18's ranks share this card
    return rows


# ------------------------------------------------------------------ phase 21
def entry_point(torch, np, smi, path, eager, pinned, inputs, by_class, iters=(10, 20), dsa_stages=0):
    """An eager request and its pinned counterpart on the same inputs (a
    list of argument tuples, one request each): the eager requests counted
    with K1's, K2's and K3's inputs recorded and held (K2 bit for bit against
    its plain twin, K1 within phase 19's dot-product bound, K3 by
    `roi_check`); the pinned requests
    against them by phase 5's criteria at |dscore| <= PINNED_DSCORE; each
    graph's captured launches equal to an eager request's; the DSA head's
    routes counted (`dsa_stages` folded calls a request, eager or captured,
    and no chain) and its fold held against the chain on the eager requests'
    own rows (DSA_FOLD_REL); then request ms at the median, eager and
    pinned, each on its own line."""
    from faster_orefsdet_tpu_torch.models import cascade_roi
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda, roi_align_cuda
    from faster_orefsdet_tpu_torch.pipelines.graphs import CAPTURES, WARMUP_CALLS
    from faster_orefsdet_tpu_torch.pipelines.inference import pack_detections, unpack_detections_np

    ref, cgm_seen, nms_seen, roi_seen, dsa_seen = [], [], {}, [], []
    dense_before = roi_align_cuda.counter.dense_calls

    def dsa_routes():
        return cascade_roi.counter.folded_calls, cascade_roi.counter.chain_calls

    def requests():
        roi_seen.extend(record_roi_calls(torch, lambda: dsa_seen.extend(record_dsa_calls(
            torch, lambda: ref.extend(eager(*x) for x in inputs)))))

    dsa_before = dsa_routes()
    launches = count_launches(cgm_cuda, nms_cuda, lambda: cgm_seen.extend(record_cgm_calls(
        torch, lambda: nms_seen.update(record_nms_calls(torch, requests)))))
    dsa_eager = [n - b for n, b in zip(dsa_routes(), dsa_before)]
    per_request = {k: v // len(inputs) for k, v in launches.items()}
    dsa_before = dsa_routes()
    got = [pinned(*x) for x in inputs]
    torch.cuda.synchronize()
    dsa_pinned = [n - b for n, b in zip(dsa_routes(), dsa_before)]
    dense_calls = roi_align_cuda.counter.dense_calls - dense_before
    dsa_rel = check_dsa_calls(torch, dsa_seen)
    dsa_seen.clear()
    bodies = len(pinned.graphs) * (WARMUP_CALLS + CAPTURES)  # eager warm-ups and captures: replays count nothing
    checks = []
    for a, b in zip(got, ref):
        pa, pb = pack_detections(a), pack_detections(b)
        ga, gb = (unpack_detections_np(p.reshape(-1, *p.shape[-2:])) for p in (pa, pb))
        checks += [match(np, {k: v[i] for k, v in ga.items()}, {k: v[i] for k, v in gb.items()}, PINNED_DSCORE,
                         by_class=by_class) for i in range(len(ga["valid"]))]
    identical = sum(int((pack_detections(a) == pack_detections(b)).sum()) for a, b in zip(got, ref))
    graphs = [g.launches for g in pinned.graphs.values()]
    nms_checks, nms_err = check_nms_calls(torch, nms_seen)
    cgm_checks, cgm_err, cgm_bad = check_cgm_calls(torch, cgm_seen)
    roi_checks, roi_bad = check_roi_calls(torch, roi_seen)
    roi_seen.clear()
    row = {"path": path, "requests": len(inputs), "eager_launches_per_request": per_request,
           "graphs_captured_launches": graphs, "images_checked": len(checks),
           "all_matched": all(c["ok"] for c in checks), "max_dscore": max(c["max_dscore"] for c in checks),
           "bit_identical_values": identical, "values": sum(pack_detections(a).numel() for a in got),
           "nms_sites": [c["shape"] for c in nms_checks if c["site"] == "kernel"],
           "nms_mismatches": sum(c["mismatches"] for c in nms_checks), "nms_max_abs_err": nms_err,
           "cgm_calls": [[c["shape"], c["classes"]] for c in cgm_checks], "cgm_max_abs_err": cgm_err,
           "cgm_out_of_bound": cgm_bad, "roi_dense_calls": dense_calls,
           "roi_calls": [[c["shape"], c["dtype"], c["levels"]] for c in roi_checks],
           "roi_max_abs_err": max((c["max_abs_err"] for c in roi_checks), default=0.0), "roi_out_of_bound": roi_bad,
           "dsa_folded_per_request": dsa_eager[0] / len(inputs), "dsa_folded_per_captured_body": dsa_pinned[0] / bodies,
           "dsa_chain_calls": dsa_eager[1] + dsa_pinned[1], "dsa_fold_vs_chain_rel": dsa_rel}
    emit(pinned_entry=row)
    if not row["all_matched"] or any(g != per_request for g in graphs) or not graphs or dense_calls:
        raise AssertionError(f"pinned {path}: detections {checks}, graphs {graphs} against {per_request} an eager "
                             "request")
    if row["nms_mismatches"] or cgm_bad or roi_bad or len(roi_checks) != launches["roi"]:
        raise AssertionError(f"pinned {path}: the kernels on the request's own inputs: {nms_checks} {cgm_checks} "
                             f"{roi_checks}")
    if (dsa_eager, dsa_pinned) != ([dsa_stages * len(inputs), 0], [dsa_stages * bodies, 0]) or dsa_rel > DSA_FOLD_REL:
        raise AssertionError(f"pinned {path}: the DSA head's routes (folded, chain) eager {dsa_eager} and captured "
                             f"{dsa_pinned} over {bodies} bodies, {dsa_stages} stages; fold vs chain {dsa_rel}")
    x = inputs[0]
    for side, fn, n in (("eager", eager, iters[0]), ("pinned", pinned, iters[1])):
        med, lo, hi = request_times(torch, lambda: fn(*x), n)
        row[f"{side}_ms_median"] = med
        emit(pinned_entry_ms={"path": path, "side": side, "ms_median": med, "ms_min": lo, "ms_max": hi,
                              "card": smi})
    return row, launches, pinned.kernel_launches()


def phase_pinned_entry_points(torch, np, smi, cfg, params, cache, frames_u8, multi, mcache, image, base, one):
    """The pinned counterparts of the JAX package's jitted serving builders
    at full width against their eager builders (``entry_point``), under the
    library's defaults (TF32 convs) on both sides, as phase 11 times: raw
    frames (phase 6's eight VGA frames, batch 1 and 8), the nine-class
    request (phase 8's cache and canvas), the one-stage request at 1 and 9
    classes in f32 and bf16 (phase 20's 384x512 canvases, two frames), the
    AttentionRPN baseline (phase 19's 608x800 canvas)."""
    from faster_orefsdet_tpu_torch.config import get_config
    from faster_orefsdet_tpu_torch.pipelines import attention_rpn as arpn
    from faster_orefsdet_tpu_torch.pipelines import onestage
    from faster_orefsdet_tpu_torch.pipelines.inference import (
        build_pinned_multiclass_inference_fn, build_pinned_serving_fn, build_serving_fn,
    )
    from faster_orefsdet_tpu_torch.utils.params import init_onestage_params

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, counted, replayed = {}, {}, {}

    def run(path, *args, **kwargs):
        rows[path], counted[path], replayed[path] = entry_point(torch, np, smi, path, *args, **kwargs)

    frames = frames_u8.cuda()
    serve, _ = build_serving_fn(cfg, params, FRAME_HW)
    eager_serve = lambda f: serve(cache, f)  # noqa: E731
    stages = len(cfg.roi.cascade_ious)
    # a function a batch, so that each path's replays are its own
    run("raw_frames_b1", eager_serve, build_pinned_serving_fn(cfg, params, cache, FRAME_HW)[0],
        [(frames[i:i + 1],) for i in range(len(frames))], False, dsa_stages=stages)
    pinned_serve, canvas = build_pinned_serving_fn(cfg, params, cache, FRAME_HW)
    run("raw_frames_b8", eager_serve, pinned_serve, [(frames,)], False, dsa_stages=stages)
    run(f"multiclass{MULTICLASS_CLASSES}", lambda *x: multi(mcache, *x),
        build_pinned_multiclass_inference_fn(cfg, params, mcache), [(image, IMAGE_HW)], True, dsa_stages=stages)
    for n in ONESTAGE_CLASSES:
        for dtype in ("float32", "bfloat16"):
            ocfg = onestage_cfg(get_config(ONESTAGE_CONFIG), n, dtype)
            oparams = init_onestage_params(ocfg, seed=20)
            run(f"onestage{n}_{dtype}", onestage.build_onestage_inference_fn(ocfg, oparams),
                onestage.build_pinned_onestage_inference_fn(ocfg, oparams),
                [(one["canvases"][i], one["image_hw"]) for i in range(PINNED_ONESTAGE_FRAMES)], True)
    bserve = arpn.build_baseline_inference_fn(base["cfg"], base["params"])
    run("baseline", lambda *x: bserve(base["cache"], *x),
        arpn.build_pinned_baseline_inference_fn(base["cfg"], base["params"], base["cache"]),
        [(base["canvas"], base["image_hw"])], True, iters=(5, 10))
    expected = {"raw_frames_b1": kernels(3, 2, 1), "raw_frames_b8": kernels(3, 2, 1),
                f"multiclass{MULTICLASS_CLASSES}": kernels(3, 2, 1), "baseline": kernels(0, 2, 1),
                **{f"onestage{n}_{d}": kernels(0, 1) for n in ONESTAGE_CLASSES for d in ("float32", "bfloat16")}}
    got = {path: row["eager_launches_per_request"] for path, row in rows.items()}
    slower = [path for path, row in rows.items() if row["pinned_ms_median"] > row["eager_ms_median"]]
    emit(pinned_entry_points={"canvas": list(canvas), "launches_per_request": got, "pinned_slower_than_eager": slower,
                              "phase_s": time.perf_counter() - t_phase, "card": smi})
    if got != expected:
        raise AssertionError(f"phase 21: launches a request {got}, expected {expected}")
    sites = {path: sorted({tuple(shape) for shape in row["nms_sites"]}) for path, row in rows.items()}
    return {"rows": rows, "sites": sites, "counted": counted, "replayed": replayed,
            "nms_err": max(r["nms_max_abs_err"] for r in rows.values()),
            "cgm_err": max(r["cgm_max_abs_err"] for r in rows.values())}


def build_baseline(torch, baseline: str) -> dict:
    """The kernels' sources in directory `baseline` (cgm.cu and nms.cu of an
    earlier build of the port) built with the port's nvcc flags into
    `baseline`/_build and loaded: {name: ctypes library}, the earlier C
    interfaces (cgm_forward without the class count)."""
    import ctypes

    from faster_orefsdet_tpu_torch.ops import _native

    out = os.path.join(baseline, "_build")
    os.makedirs(out, exist_ok=True)
    procs = {name: subprocess.Popen([_native._nvcc(), *_native.NVCC_FLAGS, "-o", os.path.join(out, f"lib{name}.so"),
                                     os.path.join(baseline, f"{name}.cu")], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True) for name in ("cgm", "nms")}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"baseline {name}.cu: nvcc rc={proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs["cgm"].cgm_forward.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
    libs["cgm"].cgm_forward.restype = i
    libs["nms"].nms_forward.argtypes = [vp, vp, vp, ctypes.c_float, i, i, vp, vp, vp]
    libs["nms"].nms_forward.restype = i
    return libs


def phase_ab(torch, np, smi, baseline: str, request_sites) -> dict:
    """The kernels of this tree against an earlier build's (sources in
    `baseline`), each row timed device-only (graph_ms) in turns, earlier,
    this, this, earlier, on the same inputs, the outputs compared: K1 at
    160 channels (f32 q, batch 1 and 8, p3+p4+p5, the redesigned any-width
    path) and at 128 (bf16, the tuned kernel); K2 past 2048 ranks (the
    redesigned wide sweep: `request_sites`, {name: (boxes, scores, valid,
    thr)} a request gave it, then [1, 3540] and [1, 4096] random, [1,
    16384]) and at or below 2048 (the register sweep: the request's
    [8, 1024] and [8, 256], the training decode's [1, 2048])."""
    from faster_orefsdet_tpu_torch.ops import cgm_cuda, nms_cuda

    old = build_baseline(torch, baseline)
    rows = {}

    def turns(name, earlier, this, check):
        times = {"earlier": [], "this": []}
        for who in ("earlier", "this", "this", "earlier"):
            times[who].append(graph_ms(torch, earlier if who == "earlier" else this))
        row = {"earlier_ms": statistics.mean(times["earlier"]), "this_ms": statistics.mean(times["this"]),
               "earlier_runs_ms": times["earlier"], "this_runs_ms": times["this"], **check()}
        row["this_over_earlier"] = row["this_ms"] / row["earlier_ms"]
        rows[name] = row
        emit(ab=name, **row, card=smi)
        if not row["same"]:
            raise AssertionError(f"A/B {name}: this build's output differs from the earlier build's")

    g = torch.Generator(device="cuda").manual_seed(11)
    for c, dtype in ((DLA_CHANNELS, torch.float32), (C, torch.bfloat16)):
        for b in (1, 8):
            levels = [cgm_inputs(torch, g, b, lh, lw, dtype, c) for (lh, lw) in LEVELS_HW]
            outs = {"earlier": [torch.empty(a[0].shape, dtype=dtype, device="cuda") for a in levels]}

            def earlier():
                for a, o in zip(levels, outs["earlier"]):
                    q = a[0]
                    rc = old["cgm"].cgm_forward(q.data_ptr(), int(dtype == torch.bfloat16),
                                                *(t.data_ptr() for t in a[1:]), o.data_ptr(),
                                                int(dtype == torch.bfloat16), *q.shape,
                                                torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"earlier cgm_forward: CUDA error {rc}")

            def this():
                outs["this"] = [cgm_cuda.cgm_correlate_fused(*a) for a in levels]

            def check():
                earlier()
                this()
                torch.cuda.synchronize()
                err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(outs["earlier"], outs["this"]))
                ref = max(float(x.float().abs().max()) for x in outs["earlier"])
                # both within phase 3's tolerance of the plain twin: their difference is at most twice it
                return {"max_abs_diff": err, "same": err <= 2 * (CGM_ATOL + CGM_RTOL * ref)}

            turns(f"cgm_c{c}_b{b}", earlier, this, check)

    rng = np.random.default_rng(12)
    sites = list(request_sites.items())
    for k, b, thr in ((3540, 1, 0.6), (4096, 1, 0.9), (NMS_LARGEST_K, 1, 0.9), (1024, 8, 0.7), (256, 8, 0.9),
                      (TRAIN_NMS_K, 1, 0.9)):
        boxes, scores, _ = nms_scenes(np, k, rng)
        args = (torch.from_numpy(boxes[:b]).cuda(), torch.from_numpy(scores[:b]).cuda(),
                torch.ones(b, k, dtype=torch.bool, device="cuda"), thr)
        sites.append((f"nms_b{b}_k{k}", args))
    for name, (boxes, scores, valid, thr) in sites:
        b, k = scores.shape
        workspace = torch.empty(nms_cuda._workspace_bytes(b, k), dtype=torch.uint8, device="cuda")
        keeps = {"earlier": torch.empty(b, k, dtype=torch.bool, device="cuda")}

        def earlier():
            rc = old["nms"].nms_forward(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), thr, b, k,
                                        workspace.data_ptr(), keeps["earlier"].data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"earlier nms_forward: CUDA error {rc}")

        def this():
            keeps["this"] = nms_cuda.nms_mask(boxes, scores, valid, thr)

        def check():
            earlier()
            this()
            torch.cuda.synchronize()
            return {"batch": b, "k": k, "valid": [int(v) for v in valid.sum(-1)],
                    "same": bool(torch.equal(keeps["earlier"], keeps["this"]))}

        turns(name, earlier, this, check)
    return rows


def request_times(torch, fn, iters):
    """(median, min, max) ms of fn() by the host's clock, each call ending
    in a sync, after 3 warm-up calls."""
    times = []
    for i in range(iters + 3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), min(times), max(times)


def replay_ms(torch, graph, reps: int = 20) -> float:
    """Device time of one replay of a captured graph: CUDA events around
    each replay, the median of `reps`."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one card.")
    parser.add_argument("--ab-baseline", metavar="DIR",
                        help="also time the kernels against an earlier build's cgm.cu and nms.cu in DIR, in turns")
    ab_baseline = parser.parse_args(argv).ab_baseline
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from faster_orefsdet_tpu_torch.config import serving_vovnet
        from faster_orefsdet_tpu_torch.ops import _native, cgm_cuda, nms_cuda
        from faster_orefsdet_tpu_torch.ops.nms import batched_nms_mask as nms_batched_plain
        from faster_orefsdet_tpu_torch.ops.nms import nms_mask as nms_plain
        from faster_orefsdet_tpu_torch.pipelines.inference import (
            build_batched_inference_fn, build_inference_fn, build_pinned_inference_fn, normalize_uint8,
            pack_detections, unpack_detections_np,
        )
        from faster_orefsdet_tpu_torch.pipelines.support_cache import build_support_cache
        from faster_orefsdet_tpu_torch.utils.params import init_params
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})", file=sys.stderr)
        return 2

    # ---- 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(torch=torch.__version__, cuda=torch.version.cuda, device=kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build
    t0 = time.time()
    libs = _native.build()
    for name, path in libs.items():
        used = [ln.split("info    : ")[-1] for ln in path.with_name(f"{name}.log").read_text().splitlines()
                if "Used" in ln]
        emit(build=name, ptxas=used)
    emit(build_s=round(time.time() - t0, 3))

    # ---- 3. kernels against their plain twins
    cgm_err, cgm_mismatches, nms_err, nms_mismatches = phase_kernels(torch, np, cgm_cuda, nms_cuda, nms_plain,
                                                                  nms_batched_plain)

    # ---- 4. main path, serving_vovnet (bf16)
    cfg = serving_vovnet()
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    sup_imgs, sup_boxes = support_inputs(torch, np, cfg, 25, rng)
    # the build's ms (host clock, ending in a sync): the first, then SUPPORT_BUILD_REPS more
    build_ms, built = [], []
    for _ in range(1 + SUPPORT_BUILD_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        built.append(build_support_cache(cfg, params, sup_imgs, sup_boxes))
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t) * 1e3)
    cache = built[0]
    for name, t in cache._asdict().items():
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"support cache {name} is not finite")
    del built
    emit(support_cache={k: [list(v.shape), str(v.dtype)[6:]] for k, v in cache._asdict().items()},
         build={"shots": 25, "crops": list(sup_imgs.shape), "ms_first": build_ms[0],
                "ms_median_after": statistics.median(build_ms[1:]), "ms_after": build_ms[1:]},
         card=smi)
    serve1 = build_inference_fn(cfg, params)
    serve8 = build_batched_inference_fn(cfg, params)
    h, w = CANVAS_HW
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 8, 3, h, w), dtype=np.uint8)).cuda()
    hw8 = torch.tensor([IMAGE_HW] * 8, device="cuda")
    singles = normalize_uint8(u8[0, :3], hw8[:3], cfg)
    torch.cuda.synchronize()

    packed = []
    launches = count_launches(cgm_cuda, nms_cuda, lambda: packed.extend(
        [pack_detections(serve1(cache, singles[i], IMAGE_HW)) for i in range(3)]
        + [pack_detections(serve8(cache, u8[i], hw8)) for i in range(2)]))
    requests = 3 + 2
    emit(main_path={"requests": requests, "images": 3 + 16, "launches": launches,
                    "launches_per_request": kernels(3, 2, 1)})
    if launches != kernels(3 * requests, 2 * requests, requests):
        raise AssertionError(f"kernel launch counts {launches} on the main path")
    for p in packed:
        p = p.reshape(-1, 100, 7)
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite detections")
        n_valid = p[..., 6].sum(-1)
        if (n_valid < 1).any():
            raise AssertionError("an image without a valid detection")
    emit(detections={"packed_shapes": [list(p.shape) for p in packed],
                     "valid_per_image": [int(v) for p in packed for v in p.reshape(-1, 100, 7)[..., 6].sum(-1)]})

    # ---- 5. card vs CPU, f32
    cfg32 = cfg.replace(compute_dtype="float32")
    sup32, box32 = support_inputs(torch, np, cfg32, 5, np.random.default_rng(2))
    img32 = torch.from_numpy(np.random.default_rng(3).standard_normal((3, h, w)).astype(np.float32))
    caches = {d: build_support_cache(cfg32, params, sup32, box32, device=d) for d in ("cuda", "cpu")}
    for name in caches["cpu"]._fields:
        a = getattr(caches["cuda"], name).float().cpu()
        b = getattr(caches["cpu"], name).float()
        if not torch.allclose(a, b, rtol=1e-3, atol=2e-4):
            raise AssertionError(f"support cache {name}: card vs CPU max diff {(a - b).abs().max():.3e}")
    dets = {d: build_inference_fn(cfg32, params, device=d)(caches[d], img32, IMAGE_HW) for d in ("cuda", "cpu")}
    card_vs_cpu = match(np, *(unpack_detections_np(pack_detections(dets[d])) for d in ("cuda", "cpu")), MATCH_DSCORE)
    emit(card_vs_cpu=card_vs_cpu)
    if not card_vs_cpu["ok"]:
        raise AssertionError("card and CPU detections do not match")

    # ---- 6. raw frames: preprocess_device and build_serving_fn
    frames = rng.integers(0, 256, (8, 3, *FRAME_HW), dtype=np.uint8)
    raw_launches = phase_raw_frames(torch, np, cfg, params, cache, torch.from_numpy(frames))

    # ---- 7. pinned serving (CUDA-graph replay) against the eager builders
    pinned_launches = phase_pinned(torch, np, cfg, params, cache, serve1, serve8, singles, u8, hw8)

    # ---- 8. multiclass serving: three classes, K2 across classes
    multi, mcache, multi_launches, multi_nms_err, multi_site = phase_multiclass(
        torch, np, cfg, params, serve1, singles, img32)

    # ---- 9. the async predictor on VGA frames
    phase_async(torch, np, cfg, params, cache, list(rng.integers(0, 256, (ASYNC_FRAMES, *FRAME_HW, 3), np.uint8)),
                smi)

    # ---- 10. COCO evaluation on synthetic frames
    phase_eval(torch, np, cfg, params, smi)

    # ---- 11. timing: kernels at the main path's shapes, then end to end
    g = torch.Generator(device="cuda").manual_seed(1)
    # a kernel's row in the table: the work of one batch-8 request, i.e. the
    # sum over its launches at batch 8 (three levels; decode and ROI NMS)
    cgm_ms = cgm_enq_ms = cgm_plain_ms = cgm_bytes = cgm_flops = cgm_tc_flops = 0.0
    for (lh, lw) in LEVELS_HW:
        for b in (1, 8):
            args = cgm_inputs(torch, g, b, lh, lw, torch.bfloat16)
            ms = graph_ms(torch, lambda: cgm_cuda.cgm_correlate_fused(*args))
            enq = enqueue_ms(torch, lambda: cgm_cuda.cgm_correlate_fused(*args), 50)
            plain = enqueue_ms(torch, lambda: cgm_cuda.cgm_fused_plain(*args), 50)
            n = b * lh * lw * C
            nbytes = n * 2 + n * 2 + (2 * C * C + 8 * C) * 4  # bf16 q in, bf16 out, f32 taps and W3
            # the function's multiplies and adds per output value (relus not
            # counted): the 256-term projection 2*2C on the tensor cores; c2 2,
            # the W stencil 5, the H stencil 5, attn's two sums 2, the bias 1
            tc_flops, flops = n * 2 * 2 * C, n * 15
            bnd = bound(nbytes, flops, tc_flops)
            emit(timing="cgm", batch=b, hw=[lh, lw], ms=ms, enqueue_ms=enq, plain_ms=plain, **bnd,
                 share_of_bound=bnd["bound_ms"] / ms, card=smi)
            if b == 8:
                cgm_ms, cgm_enq_ms, cgm_plain_ms = cgm_ms + ms, cgm_enq_ms + enq, cgm_plain_ms + plain
                cgm_bytes, cgm_flops, cgm_tc_flops = cgm_bytes + nbytes, cgm_flops + flops, cgm_tc_flops + tc_flops
    nms_ms = nms_enq_ms = nms_plain_ms = nms_bytes = nms_flops = 0.0
    nms_rng = np.random.default_rng(4)
    for k, thr in ((cfg.static.nms_budget_test, cfg.centernet.nms_thresh_test),
                   (cfg.centernet.post_nms_topk_test, cfg.roi.nms_thresh_test)):
        for b in (1, 8):
            boxes, scores, _ = nms_scenes(np, k, nms_rng)
            args = (torch.from_numpy(boxes[:b]).cuda(), torch.from_numpy(scores[:b]).cuda(),
                    torch.ones(b, k, dtype=torch.bool, device="cuda"))
            ms = graph_ms(torch, lambda: nms_cuda.nms_mask(*args, thr))
            enq = enqueue_ms(torch, lambda: nms_cuda.nms_mask(*args, thr), 50)
            plain = enqueue_ms(torch, lambda: nms_plain(*args, thr), 10)  # syncs: no graph
            nbytes = b * k * (16 + 4 + 1 + 1)
            flops = b * (k * (k - 1) // 2 * 13 + k * k * 3)  # IoU per valid pair + rank compares
            bnd = bound(nbytes, flops)
            emit(timing="nms", batch=b, k=k, ms=ms, enqueue_ms=enq, plain_ms=plain, **bnd,
                 share_of_bound=bnd["bound_ms"] / ms, card=smi)
            if b == 8:
                nms_ms, nms_enq_ms, nms_plain_ms = nms_ms + ms, nms_enq_ms + enq, nms_plain_ms + plain
                nms_bytes, nms_flops = nms_bytes + nbytes, nms_flops + flops

    # K3 at the three serving shapes (the VoVNet request's own row; DLA's and the baseline's beside it)
    k3_rows = phase_k3_timing(torch, np, smi)

    # K2 at the training decode's site, [1, 2048] at the train threshold (not in the request's row)
    boxes, scores, _ = nms_scenes(np, TRAIN_NMS_K, nms_rng)
    args = (torch.from_numpy(boxes[:1]).cuda(), torch.from_numpy(scores[:1]).cuda(),
            torch.ones(1, TRAIN_NMS_K, dtype=torch.bool, device="cuda"))
    thr = cfg.centernet.nms_thresh_train
    ms = graph_ms(torch, lambda: nms_cuda.nms_mask(*args, thr))
    bnd = bound(TRAIN_NMS_K * 22, TRAIN_NMS_K * (TRAIN_NMS_K - 1) // 2 * 13 + TRAIN_NMS_K ** 2 * 3)
    emit(timing="nms", site="train", batch=1, k=TRAIN_NMS_K, thr=thr, ms=ms,
         enqueue_ms=enqueue_ms(torch, lambda: nms_cuda.nms_mask(*args, thr), 50),
         plain_ms=enqueue_ms(torch, lambda: nms_plain(*args, thr), 10), **bnd, share_of_bound=bnd["bound_ms"] / ms,
         card=smi)

    # K2 past 2048 ranks (not in the request's row): the 9-class request's
    # cross-class call on the inputs phase 8's counted run gave it
    # (class-offset boxes), and [1, 4096] random scenes (16 classes' width)
    boxes, scores, valid, thr = multi_site["args"]
    wide_site = {"launches": multi_site["launches"], **nms_row(torch, (boxes, scores, valid), thr)}
    emit(timing="nms", site="multiclass9", **wide_site, card=smi)
    boxes, scores, _ = nms_scenes(np, WIDE_NMS_K, nms_rng)
    args = (torch.from_numpy(boxes[:1]).cuda(), torch.from_numpy(scores[:1]).cuda(),
            torch.ones(1, WIDE_NMS_K, dtype=torch.bool, device="cuda"))
    thr = cfg.roi.nms_thresh_test
    wide_random = nms_row(torch, args, thr)
    emit(timing="nms", site="random", **wide_random, card=smi)

    # K2 at the fast presets' ROI site (not in the request's row): [8, 64]
    # at IoU 0.9, random all-valid scenes; its launches are phase 17's
    boxes, scores, _ = nms_scenes(np, FAST_ROI_K, nms_rng)
    args = (torch.from_numpy(boxes[:8]).cuda(), torch.from_numpy(scores[:8]).cuda(),
            torch.ones(8, FAST_ROI_K, dtype=torch.bool, device="cuda"))
    thr = cfg.roi.nms_thresh_test
    ms = graph_ms(torch, lambda: nms_cuda.nms_mask(*args, thr))
    bnd = bound(8 * FAST_ROI_K * 22, 8 * (FAST_ROI_K * (FAST_ROI_K - 1) // 2 * 13 + FAST_ROI_K ** 2 * 3))
    fast_roi = {"batch": 8, "k": FAST_ROI_K, "thr": thr, "ms": ms,
                "enqueue_ms": enqueue_ms(torch, lambda: nms_cuda.nms_mask(*args, thr), 50),
                "plain_ms": enqueue_ms(torch, lambda: nms_plain(*args, thr), 10), **bnd,
                "share_of_bound": bnd["bound_ms"] / ms}
    emit(timing="nms", site="fast_roi", **fast_roi, card=smi)

    # K1 at 160 channels (finetune_dla's BiFPN; f32 q, as that config
    # serves) at the three levels, batch 1 and 8, and their sums
    cgm160 = {}
    for b in (1, 8):
        tot = dict.fromkeys(("ms", "enqueue_ms", "plain_ms", "bytes", "flops", "tc_flops"), 0.0)
        for (lh, lw) in LEVELS_HW:
            args = cgm_inputs(torch, g, b, lh, lw, torch.float32, DLA_CHANNELS)
            row = {"ms": graph_ms(torch, lambda: cgm_cuda.cgm_correlate_fused(*args)),
                   "enqueue_ms": enqueue_ms(torch, lambda: cgm_cuda.cgm_correlate_fused(*args), 50),
                   "plain_ms": enqueue_ms(torch, lambda: cgm_cuda.cgm_fused_plain(*args), 50)}
            n = b * lh * lw * DLA_CHANNELS
            work = {"bytes": n * 4 + n * 4 + (2 * DLA_CHANNELS ** 2 + 8 * DLA_CHANNELS) * 4,
                    "flops": n * 15, "tc_flops": n * 2 * 2 * DLA_CHANNELS}
            bnd = bound(work["bytes"], work["flops"], work["tc_flops"])
            emit(timing="cgm", channels=DLA_CHANNELS, batch=b, hw=[lh, lw], **row, **bnd,
                 share_of_bound=bnd["bound_ms"] / row["ms"], card=smi)
            tot = {key: v + {**row, **work}[key] for key, v in tot.items()}
        cgm160[b] = {"ms": tot["ms"], "enqueue_ms": tot["enqueue_ms"], "plain_ms": tot["plain_ms"],
                     **bound(tot["bytes"], tot["flops"], tot["tc_flops"])}
        emit(timing="cgm", channels=DLA_CHANNELS, batch=b, levels="p3+p4+p5", **cgm160[b],
             share_of_bound=cgm160[b]["bound_ms"] / tot["ms"], card=smi)

    # K1 at the nine-class request's site, on the inputs phase 8's counted
    # run gave it (bf16 q, batch 1, taps [9, C] a level): one launch a level
    # over the stacked taps against nine launches a level, one a class
    multi9 = dict.fromkeys(("ms", "nine_launches_ms", "enqueue_ms", "plain_ms", "bytes", "tc_flops", "flops"), 0.0)
    for q, k1, k13, k31, w3, b3, out_dtype in multi_site["cgm_calls"]:
        def one_launch():
            cgm_cuda.cgm_correlate_fused(q, k1, k13, k31, w3, b3, out_dtype)

        def nine_launches():
            for taps in zip(k1, k13, k31):
                cgm_cuda.cgm_correlate_fused(q, *taps, w3, b3, out_dtype)

        n = k1.shape[0] * q.numel()
        row = {"ms": graph_ms(torch, one_launch), "nine_launches_ms": graph_ms(torch, nine_launches),
               "enqueue_ms": enqueue_ms(torch, one_launch, 50),
               "plain_ms": enqueue_ms(torch, lambda: cgm_cuda.cgm_fused_plain(q, k1, k13, k31, w3, b3, out_dtype), 20),
               "bytes": q.numel() * q.element_size() + n * (torch.finfo(out_dtype).bits // 8)
               + (k1.numel() * 7 + 2 * C * C + C) * 4,
               "tc_flops": n * 2 * 2 * C, "flops": n * 15}
        emit(timing="cgm", site=f"multiclass{MULTICLASS_CLASSES}", classes=k1.shape[0], hw=list(q.shape[1:3]),
             **{k: row[k] for k in ("ms", "nine_launches_ms", "enqueue_ms", "plain_ms")},
             **bound(row["bytes"], row["flops"], row["tc_flops"]), card=smi)
        multi9 = {k: v + row[k] for k, v in multi9.items()}
    multi9 = {"launches": len(multi_site["cgm_calls"]), "classes": MULTICLASS_CLASSES,
              **{k: multi9[k] for k in ("ms", "nine_launches_ms", "enqueue_ms", "plain_ms")},
              **bound(multi9["bytes"], multi9["flops"], multi9["tc_flops"])}
    multi9["share_of_bound"] = multi9["bound_ms"] / multi9["ms"]
    emit(timing="cgm", site=f"multiclass{MULTICLASS_CLASSES}", levels="p3+p4+p5", **multi9, card=smi)

    # K2's wide sweep on one random scene of 64 classes' width (phase 3's largest K)
    boxes, scores, _ = nms_scenes(np, NMS_LARGEST_K, np.random.default_rng(NMS_LARGEST_K))
    wide_largest = nms_row(torch, (torch.from_numpy(boxes[:1]).cuda(), torch.from_numpy(scores[:1]).cuda(),
                                   torch.ones(1, NMS_LARGEST_K, dtype=torch.bool, device="cuda")),
                          cfg.roi.nms_thresh_test)
    emit(timing="nms", site="random", **wide_largest, card=smi)

    torch.backends.cudnn.allow_tf32 = True  # the library defaults for serving
    torch.backends.cuda.matmul.allow_tf32 = False

    serve_at = {1: lambda: serve1(cache, singles[0], IMAGE_HW), 8: lambda: serve8(cache, u8[0], hw8)}
    torch.cuda.reset_peak_memory_stats()  # the requests' own peak, not the kernel timings' graphs
    b1 = request_times(torch, serve_at[1], 20)
    b8 = request_times(torch, serve_at[8], 10)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    # the pinned path captured under the same settings (its first call captures)
    torch.cuda.reset_peak_memory_stats()
    pinned = build_pinned_inference_fn(cfg, params, cache, packed=True)
    pin_at = {1: lambda: pinned(singles[0], IMAGE_HW), 8: lambda: pinned(u8[0], hw8)}
    p1 = request_times(torch, pin_at[1], 50)
    p8 = request_times(torch, pin_at[8], 20)
    pinned_peak = torch.cuda.max_memory_allocated() / 1e9
    m1 = request_times(torch, lambda: multi(mcache, singles[0], IMAGE_HW), 10)
    emit(e2e={"config": "serving_vovnet", "dtype": "bfloat16", "canvas": list(CANVAS_HW),
              "batch1_ms_median": b1[0], "batch1_ms_min": b1[1], "batch1_ms_max": b1[2],
              "batch8_ms_median": b8[0], "batch8_images_per_s": 8e3 / b8[0], "peak_mem_gb": eager_peak,
              "pinned_batch1_ms_median": p1[0], "pinned_batch1_ms_min": p1[1], "pinned_batch1_ms_max": p1[2],
              "pinned_batch8_ms_median": p8[0], "pinned_batch8_images_per_s": 8e3 / p8[0],
              "pinned_peak_mem_gb": pinned_peak,
              f"multiclass{MULTICLASS_CLASSES}_batch1_ms_median": m1[0],
              f"multiclass{MULTICLASS_CLASSES}_batch1_ms_min": m1[1],
              f"multiclass{MULTICLASS_CLASSES}_batch1_ms_max": m1[2], "card": smi})

    # ---- 12. where a request's time goes: the same requests under torch.profiler
    for b, wall in ((1, b1[0]), (8, b8[0])):
        emit(profile={"path": "eager", "batch": b, **profile_requests(torch, serve_at[b], wall), "card": smi})
    for b, wall in ((1, p1[0]), (8, p8[0])):
        captured = next(c for key, c in pinned.graphs.items() if key[0][0][0] == b)  # the images' batch
        # the replays' own kernels, as the profiler saw them, must be the
        # graph's captured launches: this is what shows that the pinned path
        # launches the kernels, whose counters advance only at capture. The
        # profiler has dropped part of a replay's kernel records (one run of
        # ten batch-8 replays saw 2.7 CGM launches per replay), so a profile
        # is taken again, PROFILE_ATTEMPTS times at most, until it is whole.
        expected = {"cgm_kernel": captured.launches["cgm"], "roi_align_kernel": captured.launches["roi"],
                    **{f"nms_{k}_kernel": captured.launches["nms"] for k in ("rank", "mask", "sweep")}}
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            prof = profile_requests(torch, pin_at[b], wall)
            seen = prof["own_kernel_ms_and_launches_per_request"]
            whole = all(seen[name][1] == n for name, n in expected.items())
            if whole:
                break
        replay = replay_ms(torch, captured.graph)
        emit(profile={"path": "pinned", "batch": b, **prof, "captured_launches": captured.launches,
                      "profile_attempts": attempt, "replay_device_ms": replay, "card": smi})
        if not whole:
            raise AssertionError(f"pinned batch {b}: the profiler saw {seen} per replay, the graph holds {expected}")

    # ---- 13. fine-tuning finetune_vovnet
    train = phase_train(torch, np, smi)

    # ---- 14. finetune_vovnet, K steps per call: CUDA-graph replays of the step
    graphed = phase_train_graphed(torch, np, smi, train["step_ms"])

    # ---- 15. finetune_dla (DLA-34 + BiFPN, trainable BatchNorm) at full width
    dla = phase_dla(torch, np, smi)

    # ---- 16. the workflow: reference .pth -> npz -> support crops -> demo -> feature maps
    workflow = phase_workflow(torch, np, smi)

    # ---- 17. the quantized serving presets at full width
    quant = phase_quant(torch, np, smi)

    # ---- 18. data parallel: sharded serving and eval, training by ranks
    dp_launches = phase_dp(torch, np, cfg, params, cache, torch.from_numpy(frames), smi)

    # ---- 19. the ResNet-50 family: finetune_R_50_C4_1x, mnv3_fpn, the AttentionRPN baseline
    resnet = phase_resnet(torch, np, smi)

    # ---- 20. the one-stage CenterNet over P3-P7, the rest of the zoo, fed loss, profiling, the native matcher
    one = phase_onestage(torch, np, smi)

    # ---- 21. the pinned entry points: raw frames, nine classes, one-stage, baseline, against eager
    entry = phase_pinned_entry_points(torch, np, smi, cfg, params, cache, torch.from_numpy(frames), multi, mcache,
                                      singles[0], resnet["baseline_request"], one)

    # phase 11's A/B lines: the kernels against an earlier build's, K2 also
    # on the nine-class and the one-stage nine-class requests' own inputs
    if ab_baseline:
        phase_ab(torch, np, smi, ab_baseline, {"nms_multiclass9_k2304": multi_site["args"],
                                               "nms_onestage9_k3540": one["k2_args"]["onestage9"]})

    # launches counted by the wrappers on each eager path; the pinned paths'
    # and the graphed train steps' from their graphs' captured launches times
    # their replays (phases 7, 10, 14, 15, 17, 18, 19 and 21), plus the K-step
    # function's eager warm-up steps; phase 18's training ranks count theirs
    # and report them
    entry_eager = {f"entry_{p}": v for p, v in entry["counted"].items()}
    entry_graphs = {f"entry_{p}_pinned_replays": v for p, v in entry["replayed"].items()}
    by_path = {"main": launches, "raw_frames": raw_launches, "multiclass": multi_launches,
               "pinned_replays": pinned_launches, "train": train["launches"], "train_graphed": graphed["launches"],
               "dla_train": dla["train_launches"], "dla_train_graphed": dla["graphed_launches"],
               "dla_eval_pinned_replays": dla["eval_launches"], "workflow_glob": workflow["glob_launches"],
               "workflow_dla_c160": workflow["dla_launches"], "quant": quant["launches"],
               "quant_pinned_replays": quant["pinned_replays"], "dp_pinned_replays": dp_launches["pinned"],
               "dp_train": dp_launches["train"], "dp_train_graphed": dp_launches["graphed"],
               **{f"resnet_{k}": v for k, v in {**resnet["launches"], **resnet["graph_launches"]}.items()},
               **one["launches"], **entry_eager, **entry_graphs}
    resnet_paths = tuple(f"resnet_{k}" for k in resnet["launches"])
    # K3's: 0 in the graphed train steps (training pools through the dense composition)
    k3_by_path = {p: v.get("roi", 0) for p, v in by_path.items()}
    eager_paths = ("main", "raw_frames", "multiclass", "train", "dla_train", "workflow_glob", "workflow_dla_c160",
                   "quant", "dp_train") + resnet_paths + tuple(one["launches"]) + tuple(entry_eager)
    graph_sites = {p: {"captured_launches_per_replay": row["graphs_captured_launches"][0],
                       "replays": entry["replayed"][p]} for p, row in entry["rows"].items()}
    # phase 18's data-parallel train step, one graph a rank (and at world 1)
    graph_sites["dp_train_step"] = dp_launches["graph_site"]
    site_shapes = {**entry["sites"], "dp_train_step": dp_launches["graph_site"]["shapes"]}
    counted = {k: sum(by_path[p][k] for p in eager_paths) for k in ("cgm", "nms")}
    resnet_entry = {k: {"launches": sum(by_path[p][k] for p in resnet_paths),
                        "launches_by_path": {p: v[k] for p, v in by_path.items() if p.startswith("resnet_")}}
                    for k in ("cgm", "nms")}
    common = {"route": "cuda", "library_ms": None}
    emit(kernels=[
        {"name": "cgm_correlate_fused", **common,
         "source": "faster_orefsdet_tpu_torch/csrc/cgm.cu",
         "replaces": "faster_orefsdet_tpu/ops/pallas_cgm.py:47",
         "launches": counted["cgm"], "launches_by_path": {p: v["cgm"] for p, v in by_path.items()},
         "max_abs_err": max(cgm_err, multi_site["cgm_err"], resnet["cgm_err"], entry["cgm_err"]),
         "mismatches": cgm_mismatches + resnet["cgm_mismatches"],
         "ms": cgm_ms, "enqueue_ms": cgm_enq_ms,
         "plain_ms": cgm_plain_ms, **bound(cgm_bytes, cgm_flops, cgm_tc_flops),
         "train_site": {"launches_per_step": train["launches"]["cgm"] / train["steps"]},
         "c160_site": {"launches": workflow["dla_launches"]["cgm"], "batch8": cgm160[8], "batch1": cgm160[1]},
         f"multiclass{MULTICLASS_CLASSES}_site": multi9,
         "resnet": {**resnet_entry["cgm"], "max_abs_err": resnet["cgm_err"],
                    "out_of_bound": resnet["cgm_mismatches"]},
         "graph_sites": {p: {"captured_launches_per_replay": v["captured_launches_per_replay"]["cgm"],
                             "replayed_launches": v["replays"]["cgm"]} for p, v in graph_sites.items()}},
        {"name": "nms_mask", **common,
         "source": "faster_orefsdet_tpu_torch/csrc/nms.cu",
         "replaces": "faster_orefsdet_tpu/ops/pallas_nms.py:46",
         "launches": counted["nms"], "launches_by_path": {p: v["nms"] for p, v in by_path.items()},
         "max_abs_err": max(nms_err, multi_nms_err, train["nms_err"], dla["nms_err"], quant["roi_site"]["max_abs_err"],
                            resnet["nms_err"], one["nms_err"], entry["nms_err"]),
         "mismatches": nms_mismatches + train["nms_mismatches"] + dla["nms_mismatches"]
         + quant["roi_site"]["mismatches"] + resnet["nms_mismatches"] + one["nms_mismatches"],
         "ms": nms_ms, "enqueue_ms": nms_enq_ms, "plain_ms": nms_plain_ms, **bound(nms_bytes, nms_flops),
         "train_site": train["nms_site"], "dla_train_site": dla["train_site"],
         "dla_serving_decode_site": dla["serve_site"],
         "multiclass9_site": wide_site, f"k{WIDE_NMS_K}_random": wide_random,
         f"k{NMS_LARGEST_K}_random": wide_largest,
         "fast_roi_site": {**fast_roi, "launches": quant["roi_site"]["launches"]},
         "resnet": {**resnet_entry["nms"], "max_abs_err": resnet["nms_err"], "mismatches": resnet["nms_mismatches"],
                    "sites": resnet["k2"]},
         "onestage": {"launches_by_classes": {n: one["launches"][f"onestage_{n}class"]["nms"]
                                              for n in ONESTAGE_CLASSES},
                      "max_abs_err": one["nms_err"], "mismatches": one["nms_mismatches"], "sites": one["k2"]},
         "graph_sites": {p: {"captured_launches_per_replay": v["captured_launches_per_replay"]["nms"],
                             "replayed_launches": v["replays"]["nms"], "shapes": site_shapes[p]}
                         for p, v in graph_sites.items()}},
        {"name": "roi_align_gather", **common,
         "source": "faster_orefsdet_tpu_torch/csrc/roi_align.cu",
         "replaces": None, "why": "the dense ROIAlign einsums took most of the ROI stage on the card",
         "launches": sum(k3_by_path[p] for p in eager_paths), "launches_by_path": k3_by_path,
         "rows": k3_rows,
         "graph_sites": {p: {"captured_launches_per_replay": v["captured_launches_per_replay"]["roi"],
                             "replayed_launches": v["replays"]["roi"]} for p, v in graph_sites.items()
                         if "roi" in v["replays"]}},
    ])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
