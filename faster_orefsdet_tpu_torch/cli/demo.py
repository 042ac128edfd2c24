"""Detections on images, a video or a camera, drawn as scored boxes
(counterpart of ``faster_orefsdet_tpu/cli/demo.py``).

Usage:
  python -m faster_orefsdet_tpu_torch.cli.demo \\
      --input 'directory/*.png' --output results/ \\
      --params model_final.npz --support-index support_index.json \\
      [--confidence 0.3] [--parallel] [--debug] [--device cuda|cpu]
      [--config serving_vovnet_int8_static --calib-glob 'calib/*.png']
  python -m faster_orefsdet_tpu_torch.cli.demo --video-input clip.mp4 \\
      --output results/clip_out.mp4 --support-index support_index.json \\
      [--frame-batch 8] [--num-devices N]
  python -m faster_orefsdet_tpu_torch.cli.demo --webcam \\
      --output results/webcam.mp4 --max-frames 100 --support-index ...

The reference's demo.py:93-193 with predictor.py: build the support cache
from the index, preprocess each frame at the test scale, run the query path,
draw the boxes and print the timings. Images go one at a time through
``build_inference_fn`` (batch 1), or with --parallel through
``AsyncPredictor`` (pinned CUDA-graph replays, host work overlapped). Video
frames go --frame-batch at a time through ``build_pinned_serving_fn`` (raw
frames resized on the device, the request a CUDA-graph replay on the card;
the tail batch padded with its first frame), split over --num-devices cards
by ``parallel.make_sharded_serving`` (a pinned replica a card) when it is
above 1, or one at a time at --frame-batch 1 (--parallel: through
``AsyncPredictor``).
--debug also writes each image's per-level heatmap overlays
(``utils.debug_vis.debug_test``). --params reads a params .npz of either
package (random weights from seed 0 without it). The int8_static and
int8_resident presets first calibrate their activation scales on up to 8
images of --calib-glob (default: the --input glob). Runs on the card unless
--device cpu.

``run`` takes its readers, writers and drawer as callables (``Media``), so
that it also runs on frames held in memory without cv2; the command line
wires in cv2 (``cv2_media``).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="finetune_vovnet")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="image path or glob")
    src.add_argument("--video-input", help="video file (reference demo.py:116-162)")
    src.add_argument("--webcam", action="store_true",
                     help="read camera 0 (reference demo.py:104-115); frames are written to --output")
    p.add_argument("--frame-batch", type=int, default=8,
                   help="video/webcam frames per request through the raw-frame serving function (resize and "
                        "normalization on the device); 1 = per frame")
    p.add_argument("--max-frames", type=int, default=0, help="stop video/webcam after N frames (0 = whole stream)")
    p.add_argument("--num-devices", type=int, default=1,
                   help=">1 shards --frame-batch over a device mesh (parallel.serve_dp data-parallel serving; "
                        "frame-batch must be divisible by it)")
    p.add_argument("--parallel", action="store_true",
                   help="AsyncPredictor for globs and per-frame video (--frame-batch 1): pinned CUDA-graph "
                        "replays with host preprocessing and readbacks overlapped (predictor.py:150-238)")
    p.add_argument("--calib-glob",
                   help="calibration images for the int8_static/int8_resident presets (<=8 used; defaults to the "
                        "first --input glob images; REQUIRED for quantized video/webcam runs — streams cannot "
                        "self-calibrate)")
    p.add_argument("--output", default="results")
    p.add_argument("--params", help="params .npz of either package (random init from seed 0 if omitted)")
    p.add_argument("--support-index", required=True)
    p.add_argument("--confidence", type=float, default=0.3)
    p.add_argument("--debug", action="store_true",
                   help="also write per-level predicted-heatmap overlays (the cfg.DEBUG debug_test path, "
                        "CenterNet2 debug.py:141-215) into --output")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs="*", help="config overrides key=value")
    return p.parse_args(argv)


def draw_detections(img: np.ndarray, boxes, scores, thresh: float) -> np.ndarray:
    """The frame with a green box and score for each detection >= thresh."""
    import cv2

    out = img.copy()
    for box, score in zip(boxes, scores):
        if score < thresh:
            continue
        x1, y1, x2, y2 = [int(v) for v in box]
        cv2.rectangle(out, (x1, y1), (x2, y2), (0, 220, 0), 2)
        cv2.putText(out, f"ore {score:.2f}", (x1, max(12, y1 - 4)), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                    (0, 220, 0), 1)
    return out


@dataclasses.dataclass
class Media:
    """The demo's readers, writers and drawer.

    imread(path) -> [H, W, 3] uint8 BGR or None; imwrite(path, img);
    glob(pattern) -> sorted paths; open_video(source) -> (frames, fps,
    (h, w)) with source a path or a camera index and frames an iterator of
    [h, w, 3] uint8 frames; open_writer(path, fps, (w, h)) -> a writer with
    write(frame) and release();
    draw(img, boxes, scores, thresh) -> the drawn frame; debug(...) as
    ``utils.debug_vis.debug_test``."""

    imread: Callable
    imwrite: Callable
    glob: Callable[[str], List[str]]
    open_video: Callable
    open_writer: Callable
    draw: Callable
    debug: Callable


def cv2_media() -> Media:
    """Media on files, read and written with cv2."""
    import cv2

    from ..utils.debug_vis import debug_test

    def open_video(source):
        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise SystemExit(f"cannot open video source {source!r}")

        def frames() -> Iterator[np.ndarray]:
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        return
                    yield frame
            finally:
                cap.release()

        size = (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        return frames(), cap.get(cv2.CAP_PROP_FPS) or 25.0, size

    def open_writer(path, fps, size_wh):
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if path.endswith(".mp4") else "MJPG"))
        return cv2.VideoWriter(path, fourcc, fps, size_wh)

    return Media(imread=cv2.imread, imwrite=cv2.imwrite, glob=lambda pattern: sorted(glob.glob(pattern)),
                 open_video=open_video, open_writer=open_writer, draw=draw_detections, debug=debug_test)


def check_args(args: argparse.Namespace) -> None:
    """Flag combinations that cannot run fail before any model work."""
    if args.parallel and args.num_devices > 1:
        raise SystemExit("--parallel (AsyncPredictor, single-device pinned graphs) and --num-devices > 1 (DP "
                         "serving) are mutually exclusive")
    if args.num_devices > 1 and not ((args.video_input or args.webcam) and args.frame_batch > 1):
        raise SystemExit("--num-devices > 1 is DP video serving and requires --video-input/--webcam with "
                         "--frame-batch > 1 (the image-glob and per-frame paths are single-device)")
    if args.num_devices > 1 and args.frame_batch % args.num_devices:
        raise SystemExit(f"--frame-batch {args.frame_batch} not divisible by --num-devices {args.num_devices}")
    if args.parallel and (args.video_input or args.webcam) and args.frame_batch > 1:
        raise SystemExit("--parallel drives per-frame video only: pass --frame-batch 1 (or drop --parallel to "
                         "use the batched raw-frame serving function)")
    if args.parallel and args.debug:
        raise SystemExit("--debug needs the sequential path; drop --parallel")


def run(args: argparse.Namespace, media: Media) -> int:
    """The demo on `args` (``parse_args``'s) through `media`. Returns the
    number of frames drawn."""
    check_args(args)
    import torch

    from ..config import apply_overrides, get_config
    from ..data.coco import load_support_index
    from ..pipelines.evaluate import encode_support_set
    from ..pipelines.inference import build_inference_fn
    from ..pipelines.preprocess import ceil_to, preprocess_host, resize_shortest_edge_size
    from ..utils.checkpoint import load_params_npz
    from ..utils.device import resolve_device
    from ..utils.params import init_params

    cfg = apply_overrides(get_config(args.config), args.opts)
    calib_paths: List[str] = []
    if cfg.quantize in ("int8_static", "int8_resident"):
        pattern = args.calib_glob or args.input
        calib_paths = media.glob(pattern) if pattern else []
        if not calib_paths:
            raise SystemExit(f"--config {args.config} (quantize={cfg.quantize}) needs calibration images: pass "
                             "--calib-glob 'imgs/*.png' (video/webcam streams cannot self-calibrate)")
    dev = resolve_device(args.device)
    params = load_params_npz(args.params, batch_stats=True) if args.params else init_params(cfg, seed=0)

    t0 = time.perf_counter()
    cache = encode_support_set(cfg, params, load_support_index(args.support_index), imread=media.imread, device=dev)
    print(f"support cache built in {time.perf_counter() - t0:.2f}s")
    inp = cfg.input

    def canvas_of(h: int, w: int) -> Tuple[int, int]:
        rh, rw = resize_shortest_edge_size(h, w, inp.min_size_test, inp.max_size_test)
        return ceil_to(rh, inp.size_divisibility), ceil_to(rw, inp.size_divisibility)

    act_scales = None
    if calib_paths:
        # the static presets: activation scales measured once on a few
        # in-domain images, then read by every request below
        from ..pipelines.quant_calib import calibrate_act_scales

        imgs = [img for img in (media.imread(path) for path in calib_paths[:8]) if img is not None]
        if not imgs:
            raise SystemExit("no readable calibration images")
        sizes = [canvas_of(*img.shape[:2]) for img in imgs]
        chw = (max(h for h, _ in sizes), max(w for _, w in sizes))
        canvases = torch.stack([preprocess_host(img, inp.min_size_test, inp.max_size_test, chw, inp.pixel_mean,
                                                inp.pixel_std)[0] for img in imgs])
        t0 = time.perf_counter()
        act_scales = calibrate_act_scales(cfg, params, canvases, device=dev)
        print(f"calibrated {len(act_scales)} activation scales ({len(imgs)} images) in "
              f"{time.perf_counter() - t0:.2f}s")

    infer = None

    def detect_frame(img: np.ndarray, taps: Optional[dict] = None):
        """BGR frame -> (boxes in frame coordinates, scores, canvas); `taps`
        as in ``query_path``."""
        nonlocal infer
        infer = infer or build_inference_fn(cfg, params, device=dev, act_scales=act_scales)
        canvas, (newh, neww), (sy, sx) = preprocess_host(img, inp.min_size_test, inp.max_size_test,
                                                         canvas_of(*img.shape[:2]), inp.pixel_mean, inp.pixel_std)
        det = infer(cache, canvas, (float(newh), float(neww)), taps=taps)
        valid = det.valid.cpu().numpy()
        boxes = det.boxes.float().cpu().numpy()[valid] * np.asarray([sx, sy, sx, sy])
        return boxes, det.scores.float().cpu().numpy()[valid], canvas

    def async_predictor():
        from ..pipelines.async_predictor import AsyncPredictor

        return AsyncPredictor(cfg, params, cache, depth=8, readback_workers=8, device=dev, act_scales=act_scales)

    if args.video_input or args.webcam:
        frames, fps, (h, w) = media.open_video(0 if args.webcam else args.video_input)
        if args.output.lower().endswith((".mp4", ".avi", ".mkv")):
            out_path = args.output
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        else:
            os.makedirs(args.output, exist_ok=True)
            stem = "webcam" if args.webcam else os.path.splitext(os.path.basename(args.video_input))[0]
            out_path = os.path.join(args.output, f"{stem}_out.mp4")
        writer = media.open_writer(out_path, fps, (w, h))
        if args.max_frames:
            frames = (f for _, f in zip(range(args.max_frames), frames))
        n, t_total = 0, 0.0
        fb = max(1, args.frame_batch)
        if fb > 1:
            # raw frames in, boxes in frame coordinates out: resize,
            # normalization and the query path on the device, fb frames a call
            if args.num_devices > 1:
                # data-parallel: the frames split over the mesh, a replica of
                # the weights and the cache on each device
                from ..parallel import make_mesh, make_sharded_serving

                serve, _ = make_sharded_serving(cfg, params, (h, w), make_mesh(args.num_devices, dev), cache,
                                                act_scales=act_scales)
            else:
                from ..pipelines.inference import build_pinned_serving_fn

                serve, _ = build_pinned_serving_fn(cfg, params, cache, (h, w), device=dev, act_scales=act_scales)
            buf: List[np.ndarray] = []

            def flush():
                nonlocal n, t_total
                count = len(buf)
                batch = np.stack(buf + [buf[0]] * (fb - count))
                t0 = time.perf_counter()
                det = serve(torch.from_numpy(batch).permute(0, 3, 1, 2))
                boxes, scores, valid = (det.boxes.float().cpu().numpy(), det.scores.float().cpu().numpy(),
                                        det.valid.cpu().numpy())
                t_total += time.perf_counter() - t0
                for i in range(count):
                    writer.write(media.draw(buf[i], boxes[i][valid[i]], scores[i][valid[i]], args.confidence))
                    n += 1
                buf.clear()
                if n % 24 < fb:
                    print(f"frame {n}: {n / max(t_total, 1e-9):.1f} fps (incl. the first call)")

            for frame in frames:
                buf.append(frame)
                if len(buf) == fb:
                    flush()
            if buf:
                flush()
        elif args.parallel:
            pending: List[np.ndarray] = []

            def frames_iter():
                for frame in frames:
                    pending.append(frame)
                    yield frame

            t0 = time.perf_counter()
            for out in async_predictor().run(frames_iter()):
                writer.write(media.draw(pending.pop(0), out["boxes"], out["scores"], args.confidence))
                n += 1
                if n % 25 == 0:
                    print(f"frame {n}: {len(out['scores'])} dets, {n / max(time.perf_counter() - t0, 1e-9):.1f} "
                          "fps (incl. the first call)")
            t_total = time.perf_counter() - t0
        else:
            for frame in frames:
                t0 = time.perf_counter()
                boxes, scores, _ = detect_frame(frame)
                t_total += time.perf_counter() - t0
                writer.write(media.draw(frame, boxes, scores, args.confidence))
                n += 1
                if n % 25 == 0:
                    print(f"frame {n}: {len(scores)} dets, {n / max(t_total, 1e-9):.1f} fps (incl. the first call)")
        writer.release()
        print(f"{n} frames -> {out_path} ({n / max(t_total, 1e-9):.1f} fps)")
        return n

    os.makedirs(args.output, exist_ok=True)
    paths = media.glob(args.input) or [args.input]
    n = 0
    if args.parallel:
        # decodes stream: `pending` holds at most the predictor's depth of frames
        pending: List[Tuple[str, np.ndarray]] = []

        def images_iter():
            for path in paths:
                img = media.imread(path)
                if img is None:
                    print(f"skip unreadable {path}")
                    continue
                pending.append((path, img))
                yield img

        t0 = time.perf_counter()
        for out in async_predictor().run(images_iter()):
            path, img = pending.pop(0)
            n += 1
            n_vis = int((out["scores"] >= args.confidence).sum())
            print(f"{path}: {len(out['scores'])} detections ({n_vis} >= {args.confidence})")
            media.imwrite(os.path.join(args.output, os.path.basename(path)),
                          media.draw(img, out["boxes"], out["scores"], args.confidence))
        wall = time.perf_counter() - t0
        print(f"{n} images in {wall:.2f}s ({n / max(wall, 1e-9):.1f} img/s, AsyncPredictor incl. the first call)")
        return n

    for path in paths:
        img = media.imread(path)
        if img is None:
            print(f"skip unreadable {path}")
            continue
        taps = {} if args.debug else None
        t0 = time.perf_counter()
        boxes, scores, canvas = detect_frame(img, taps)
        dt = time.perf_counter() - t0
        n_vis = int((scores >= args.confidence).sum())
        print(f"{path}: {len(scores)} detections ({n_vis} >= {args.confidence}) in {dt:.3f}s")
        media.imwrite(os.path.join(args.output, os.path.basename(path)),
                      media.draw(img, boxes, scores, args.confidence))
        n += 1
        if args.debug:
            # debug_test overlays from the same forward pass: the per-level
            # heatmaps and the proposals (debug.py:141-215)
            from ..structures.instances import Proposals

            stem = os.path.splitext(os.path.basename(path))[0]
            media.debug(canvas, [torch.sigmoid(hm[0].float()).permute(1, 2, 0).cpu() for hm in taps["heatmaps"]],
                        Proposals(*(t[0].cpu() for t in taps["proposals"])), args.output, prefix=f"{stem}_debug",
                        vis_thresh=args.confidence, pixel_mean=inp.pixel_mean, pixel_std=inp.pixel_std)
            print(f"  debug overlays -> {args.output}/{stem}_debug_*.png")
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv), cv2_media())


if __name__ == "__main__":
    main()
