#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (faster_orefsdet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. card: prints `nvidia-smi --query-gpu=name,power.limit` and turns TF32 off
   for the comparison phases;
2. build: compiles the CUDA kernels of faster_orefsdet_tpu_torch/csrc with nvcc;
3. kernels: the CGM kernel against its plain twin at the p3/p4/p5 shapes of a
   320x448 canvas (batch 1 and 8) and at ragged tile edges (1x1, 3x5, 7x33 at
   batch 3), bf16 and f32 q: its f32 result within |err| <= CGM_ATOL +
   CGM_RTOL*|ref|, its result in q's dtype that f32 result rounded once, bit
   for bit. The NMS kernel against the plain fixpoint, bit for bit, at K in
   {1, 63, 64, 65, 256, 512, 1000, 1024, 1792, 2048} on batches of 10 scenes
   (random, dense chains, score ties, invalid padding, ascending scores, all
   scores equal), and at K in {256, 1024} on each scene alone (batch 1);
4. main path: seeded init_params under serving_vovnet (bf16), a 25-shot support
   cache from 256x256 crops, then 3 batch-1 requests (build_inference_fn) and
   2 batch-8 uint8 requests (build_batched_inference_fn) on 320x448 canvases
   with image_hw (320, 427). Every image must give finite packed [100, 7]
   detections, and both kernels' launch counters must have advanced by the
   expected count;
5. card vs CPU: the same weights and inputs in f32 through the port on the card
   and on the CPU (plain twins), the support caches compared and the
   detections greedy-matched;
6. timing: each kernel at the main path's shapes, on the device only (50
   calls captured in a CUDA graph, the replay timed with CUDA events; L2
   warm) and as enqueued from the host (events around 50 calls), its plain
   twin (events), and the main path end to end in bf16 with the library's
   default TF32 settings;
7. profile: the same batch-1 and batch-8 requests under torch.profiler:
   device busy time, idle share, launches, each of the port's own kernels'
   device time and launches, each stage's device span and the top kernels.

Each result is one JSON line. The line before the last holds the kernels'
table; the last line is {"ok": true, "device": {...}}. Run without the
repository beside it, or without a CUDA device, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet); a
# card set to a lower power limit (printed in phase 1) reaches less
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12      # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 on the tensor cores, dense
CGM_RTOL = CGM_ATOL = 1e-4  # f32 (3xTF32 on the card), 256-term sums in another order
MATCH_IOU, MATCH_FRACTION, MATCH_DSCORE = 0.95, 0.85, 1e-3
CANVAS_HW, IMAGE_HW = (320, 448), (320.0, 427.0)
LEVELS_HW = [(CANVAS_HW[0] // s, CANVAS_HW[1] // s) for s in (8, 16, 32)]
C = 128
PROFILE_ITERS = 10
STAGES = ("features", "correlate", "proposal_head", "decode_proposals", "roi_stage", "roi_inference")
OWN_KERNELS = ("cgm_kernel", "nms_rank_kernel", "nms_mask_kernel", "nms_sweep_kernel")


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


def profile_requests(torch, request, wall_ms: float) -> dict:
    """PROFILE_ITERS requests under torch.profiler, per request: device busy
    ms (the sum of kernel times; the path runs on one stream, so kernels do
    not overlap), the idle share of the median wall time `wall_ms` measured
    without the profiler, kernel launches, this port's own kernels' ms, each
    stage's device span (first kernel start to last kernel end, idle gaps
    included; the profiler slows the host) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt, names=("self_device_time_total", "self_cuda_time_total")):
        return next((float(getattr(evt, n)) for n in names if hasattr(evt, n)), 0.0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ITERS):
            request()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_card if e.key not in STAGES]
    spans = {e.key: device_us(e, ("device_time_total", "cuda_time_total")) / PROFILE_ITERS / 1e3
             for e in on_card if e.key in STAGES}
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
def cgm_inputs(torch, g, b, h, w, dtype):
    dev = "cuda"
    q = torch.randn(b, h, w, C, device=dev, generator=g).to(dtype)
    k1 = torch.randn(C, device=dev, generator=g)
    k13 = torch.randn(3, C, device=dev, generator=g)
    k31 = torch.randn(3, C, device=dev, generator=g)
    w3 = torch.randn(C, 2 * C, device=dev, generator=g) / (2 * C) ** 0.5  # nn.Linear's [out, in]
    b3 = 0.1 * torch.randn(C, device=dev, generator=g)
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


def greedy_match(np, got_b, got_s, ref_b, ref_s, iou_min):
    """Greedy one-to-one matching by descending IoU >= iou_min."""
    a1 = (got_b[:, 2] - got_b[:, 0]) * (got_b[:, 3] - got_b[:, 1])
    a2 = (ref_b[:, 2] - ref_b[:, 0]) * (ref_b[:, 3] - ref_b[:, 1])
    lt = np.maximum(got_b[:, None, :2], ref_b[None, :, :2])
    rb = np.minimum(got_b[:, None, 2:], ref_b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    iou = np.where(inter > 0, inter / np.maximum(a1[:, None] + a2[None] - inter, 1e-12), 0.0)
    pairs, used_g, used_r = [], set(), set()
    for j, r in zip(*np.unravel_index(np.argsort(-iou, axis=None), iou.shape)):
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
def phase_kernels(torch, np, cgm_cuda, nms_cuda, nms_plain):
    g = torch.Generator(device="cuda").manual_seed(0)
    cgm_err, cgm_mismatches = 0.0, 0
    # the main path's levels at batch 1 and 8, and ragged tile edges at batch 3
    shapes = [(b, h, w) for b in (1, 8) for (h, w) in LEVELS_HW] + [(3, 1, 1), (3, 3, 5), (3, 7, 33)]
    for (b, h, w) in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            args = cgm_inputs(torch, g, b, h, w, dtype)
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
            cgm_err, cgm_mismatches = max(cgm_err, float(err.max())), cgm_mismatches + bad + rounded
            emit(check="cgm", batch=b, hw=[h, w], q_dtype=str(dtype)[6:], max_abs_err=float(err.max()),
                 out_of_tolerance=bad, out_dtype=str(out.dtype)[6:], rounding_mismatches=rounded)
            if bad or rounded or out.dtype != dtype or not torch.isfinite(out32).all():
                raise AssertionError(f"CGM kernel disagrees with its plain twin at {b}x{h}x{w}")
    rng = np.random.default_rng(0)
    nms_mismatches, nms_err = 0, 0.0
    for k in (1, 63, 64, 65, 256, 512, 1000, 1024, 1792, 2048):
        boxes, scores, valid = nms_scenes(np, k, rng)
        # the whole batch of 8 scenes, and at the main path's K (decode 1024,
        # ROI 256) each scene alone, as a batch-1 request launches it
        n = len(scores)
        slices = [slice(0, n)] + ([slice(i, i + 1) for i in range(n)] if k in (256, 1024) else [])
        for thr in (0.6, 0.9):
            for s in slices:
                cpu = (torch.from_numpy(boxes[s]), torch.from_numpy(scores[s]), torch.from_numpy(valid[s]))
                dev = tuple(t.cuda() for t in cpu)
                keep = nms_cuda.nms_mask(*dev, thr)
                torch.cuda.synchronize()
                ref_card = nms_plain(*dev, thr)
                ref_cpu = nms_plain(*cpu, thr)
                diff = int((keep != ref_card).sum()) + int((keep.cpu() != ref_cpu).sum())
                err = max(float((keep.float() - ref_card.float()).abs().max()),
                          float((keep.cpu().float() - ref_cpu.float()).abs().max()))
                nms_mismatches, nms_err = nms_mismatches + diff, max(nms_err, err)
                emit(check="nms", batch=int(keep.shape[0]), scenes=[s.start, s.stop], k=k, thr=thr,
                     kept=int(keep.sum()), mismatches=diff)
                if diff:
                    raise AssertionError(f"NMS kernel differs from the plain fixpoint at K={k}")
    return cgm_err, cgm_mismatches, nms_err, nms_mismatches


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


def main() -> int:
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
        from faster_orefsdet_tpu_torch.ops.nms import nms_mask as nms_plain
        from faster_orefsdet_tpu_torch.pipelines.inference import (
            build_batched_inference_fn, build_inference_fn, normalize_uint8, pack_detections,
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
    cgm_err, cgm_mismatches, nms_err, nms_mismatches = phase_kernels(torch, np, cgm_cuda, nms_cuda, nms_plain)

    # ---- 4. main path, serving_vovnet (bf16)
    cfg = serving_vovnet()
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    sup_imgs, sup_boxes = support_inputs(torch, np, cfg, 25, rng)
    cache = build_support_cache(cfg, params, sup_imgs, sup_boxes)
    for name, t in cache._asdict().items():
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"support cache {name} is not finite")
    emit(support_cache={k: [list(v.shape), str(v.dtype)[6:]] for k, v in cache._asdict().items()})
    serve1 = build_inference_fn(cfg, params)
    serve8 = build_batched_inference_fn(cfg, params)
    h, w = CANVAS_HW
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 8, 3, h, w), dtype=np.uint8)).cuda()
    hw8 = torch.tensor([IMAGE_HW] * 8, device="cuda")
    singles = normalize_uint8(u8[0, :3], hw8[:3], cfg)
    torch.cuda.synchronize()

    cgm_cuda.counter.launches = 0
    nms_cuda.counter.launches = 0
    packed = [pack_detections(serve1(cache, singles[i], IMAGE_HW)) for i in range(3)]
    packed += [pack_detections(serve8(cache, u8[i], hw8)) for i in range(2)]
    torch.cuda.synchronize()
    launches = {"cgm": cgm_cuda.counter.launches, "nms": nms_cuda.counter.launches}
    requests = 3 + 2
    emit(main_path={"requests": requests, "images": 3 + 16, "launches": launches,
                    "launches_per_request": {"cgm": 3, "nms": 2}})
    if launches != {"cgm": 3 * requests, "nms": 2 * requests}:
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
    got = {d: {f: getattr(dets[d], f).float().cpu().numpy() for f in ("boxes", "scores", "valid")}
           for d in dets}
    gv, cv = got["cuda"]["valid"] > 0, got["cpu"]["valid"] > 0
    gb, gs = got["cuda"]["boxes"][gv], got["cuda"]["scores"][gv]
    cb, cs = got["cpu"]["boxes"][cv], got["cpu"]["scores"][cv]
    pairs, dscore, used_g, used_r = greedy_match(np, gb, gs, cb, cs, MATCH_IOU)
    top_g = set(np.argsort(-gs, kind="mergesort")[:10].tolist())
    top_r = set(np.argsort(-cs, kind="mergesort")[:10].tolist())
    emit(card_vs_cpu={"card_valid": int(gv.sum()), "cpu_valid": int(cv.sum()), "matched": len(pairs),
                      "max_dscore": dscore, "top10_matched": top_g <= used_g and top_r <= used_r})
    if (gv.sum() != cv.sum() or len(pairs) < MATCH_FRACTION * cv.sum() or dscore > MATCH_DSCORE
            or not (top_g <= used_g and top_r <= used_r)):
        raise AssertionError("card and CPU detections do not match")

    # ---- 6. timing: kernels at the main path's shapes, then end to end
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

    torch.backends.cudnn.allow_tf32 = True  # the library defaults for serving
    torch.backends.cuda.matmul.allow_tf32 = False

    def request_ms(fn, iters):
        times = []
        for i in range(iters + 3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times), min(times), max(times)

    serve_at = {1: lambda: serve1(cache, singles[0], IMAGE_HW), 8: lambda: serve8(cache, u8[0], hw8)}
    torch.cuda.reset_peak_memory_stats()  # the requests' own peak, not the kernel timings' graphs
    b1 = request_ms(serve_at[1], 20)
    b8 = request_ms(serve_at[8], 10)
    emit(e2e={"config": "serving_vovnet", "dtype": "bfloat16", "canvas": list(CANVAS_HW),
              "batch1_ms_median": b1[0], "batch1_ms_min": b1[1], "batch1_ms_max": b1[2],
              "batch8_ms_median": b8[0], "batch8_images_per_s": 8e3 / b8[0],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})

    # ---- 7. where a request's time goes: the same requests under torch.profiler
    for b, wall in ((1, b1[0]), (8, b8[0])):
        emit(profile={"batch": b, **profile_requests(torch, serve_at[b], wall), "card": smi})

    common = {"route": "cuda", "library_ms": None}
    emit(kernels=[
        {"name": "cgm_correlate_fused", **common,
         "source": "faster_orefsdet_tpu_torch/csrc/cgm.cu",
         "replaces": "faster_orefsdet_tpu/ops/pallas_cgm.py:47",
         "launches": launches["cgm"], "max_abs_err": cgm_err, "mismatches": cgm_mismatches, "ms": cgm_ms, "enqueue_ms": cgm_enq_ms,
         "plain_ms": cgm_plain_ms, **bound(cgm_bytes, cgm_flops, cgm_tc_flops)},
        {"name": "nms_mask", **common,
         "source": "faster_orefsdet_tpu_torch/csrc/nms.cu",
         "replaces": "faster_orefsdet_tpu/ops/pallas_nms.py:46",
         "launches": launches["nms"], "max_abs_err": nms_err, "mismatches": nms_mismatches,
         "ms": nms_ms, "enqueue_ms": nms_enq_ms, "plain_ms": nms_plain_ms, **bound(nms_bytes, nms_flops)},
    ])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
