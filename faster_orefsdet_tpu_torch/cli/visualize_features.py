"""Feature-map and attention-map dump (counterpart of
``faster_orefsdet_tpu/cli/visualize_features.py``, the reference's
demo_visualizer.py).

The reference's `Have_a_Look` (demo_visualizer.py:36-77) saves
channel-averaged heatmap overlays of intermediate tensors. This runs the
query path phase by phase and writes, per pyramid level, the channel mean of
the backbone features, of the CGM-correlated ("attention") features and the
sigmoid of the agnostic heatmap logits: 9 maps, each colorized over the
resized image.

Usage:
  python -m faster_orefsdet_tpu_torch.cli.visualize_features \\
      --input image.png --support-index support_index.json \\
      [--params model.npz] [--out feature_maps/] [--device cuda|cpu] [key=value ...]

``feature_maps`` returns the maps as arrays; the command line reads the
image and writes the overlays with cv2.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np

LEVELS = ("p3", "p4", "p5")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="finetune_vovnet")
    p.add_argument("--input", required=True)
    p.add_argument("--support-index", required=True)
    p.add_argument("--params", help="params .npz of either package (random init from seed 0 if omitted)")
    p.add_argument("--out", default="feature_maps")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs="*", help="config overrides key=value")
    return p.parse_args(argv)


def feature_maps(cfg, params, cache, img: np.ndarray, *, device="cuda") -> Dict[str, np.ndarray]:
    """One BGR image's maps {backbone_<l>, attention_<l>, heatmap_<l>}, each
    [H_l, W_l] f32 on the host: the channel means of the backbone and the
    correlated pyramid, and the sigmoid of the heatmap logits. The cache
    must be on `device`."""
    import torch

    from ..pipelines.inference import cache_kernels, make_detector
    from ..pipelines.preprocess import ceil_to, preprocess_host, resize_shortest_edge_size

    inp = cfg.input
    rh, rw = resize_shortest_edge_size(img.shape[0], img.shape[1], inp.min_size_test, inp.max_size_test)
    canvas_hw = (ceil_to(rh, inp.size_divisibility), ceil_to(rw, inp.size_divisibility))
    canvas, _, _ = preprocess_host(img, inp.min_size_test, inp.max_size_test, canvas_hw, inp.pixel_mean,
                                   inp.pixel_std)
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        feats = model.features(canvas[None].to(dev).contiguous())
        pos = model.correlate(feats, cache_kernels(model, cache))
        agn_hms, _ = model.proposal_head(pos)
    maps = {}
    for i, lv in enumerate(LEVELS):
        maps[f"backbone_{lv}"] = feats[lv][0].float().mean(0)
        maps[f"attention_{lv}"] = pos[lv][0].float().mean(0)
        maps[f"heatmap_{lv}"] = torch.sigmoid(agn_hms[i][0, 0].float())
    return {k: v.cpu().numpy() for k, v in maps.items()}


def save_heatmap(arr: np.ndarray, path: str, base_img: Optional[np.ndarray] = None) -> None:
    """[H, W] -> a jet-colorized png, blended half and half over base_img
    (resized to it) when given."""
    import cv2

    a = np.asarray(arr, np.float32)
    a = (a - a.min()) / max(a.max() - a.min(), 1e-8)
    hm = cv2.applyColorMap((a * 255).astype(np.uint8), cv2.COLORMAP_JET)
    if base_img is not None:
        hm = cv2.resize(hm, (base_img.shape[1], base_img.shape[0]))
        hm = (0.5 * hm + 0.5 * base_img).astype(np.uint8)
    cv2.imwrite(path, hm)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from ..config import apply_overrides, get_config
    from ..data.coco import load_support_index
    from ..pipelines.evaluate import encode_support_set
    from ..pipelines.preprocess import resize_shortest_edge_size
    from ..utils.checkpoint import load_params_npz
    from ..utils.device import resolve_device
    from ..utils.params import init_params

    device = resolve_device(args.device)
    import cv2

    cfg = apply_overrides(get_config(args.config), args.opts)
    params = load_params_npz(args.params, batch_stats=True) if args.params else init_params(cfg, seed=0)
    cache = encode_support_set(cfg, params, load_support_index(args.support_index), imread=cv2.imread,
                               device=device)
    img = cv2.imread(args.input)
    if img is None:
        raise SystemExit(f"cannot read {args.input}")
    maps = feature_maps(cfg, params, cache, img, device=device)
    rh, rw = resize_shortest_edge_size(img.shape[0], img.shape[1], cfg.input.min_size_test, cfg.input.max_size_test)
    base = cv2.resize(img, (rw, rh))
    os.makedirs(args.out, exist_ok=True)
    for name, arr in maps.items():
        save_heatmap(arr, os.path.join(args.out, f"{name}.png"), base)
    print(f"wrote {len(maps)} feature maps to {args.out}/")


if __name__ == "__main__":
    main()
