"""Static int8 activation scales for the quantized serving presets
(counterpart of ``faster_orefsdet_tpu/pipelines/quant_calib.py``).

    scales = calibrate_act_scales(cfg, params, canvases, device=dev)
    save_act_scales("scales.json", scales)
    fn = build_inference_fn(cfg, params, device=dev, act_scales=load_act_scales("scales.json"))

The backbone and FPN run over calibration canvases (the serving
preprocessing applied) with dynamic quantization, recording each quantized
module's boundary abs-max; each scale is max(amax / 127, 1e-8). The keys
are the JAX package's module paths, so a scales file serves either package.
Calibrate with the config that will serve: int8_resident adds OSA-input
and conv-output keys.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping

import torch

from ..config import Config
from ..ops.quant import record_act_amax
from .inference import make_detector

_EPS = 1e-8


def chunk_amax(model, chunk: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{module key: abs-max} over one chunk of canvases (the backbone and FPN
    under dynamic quantization). It neither waits for the host nor copies to
    it, so a CUDA graph could hold it; the pass runs it eagerly, since its
    callers calibrate on one chunk (<= 8 images), where two warm-ups and a
    capture cost more than they save."""
    with record_act_amax() as rec:
        model.features(chunk)
    return rec


@torch.inference_mode()
def calibrate_act_scales(cfg: Config, params: Mapping[str, torch.Tensor], images: torch.Tensor,
                         max_batch: int = 8, *, device="cuda") -> Dict[str, float]:
    """{module key: scale} from the abs-max that each quantized module sees
    over `images` [N, 3, Hc, Wc] (normalized canvases), run on `device` in
    chunks of max_batch; a short last chunk is padded by repeating its first
    image (the abs-max is unchanged), so that every chunk has one shape."""
    if cfg.quantize == "none":
        raise ValueError("calibrate_act_scales needs a quantized config (cfg.quantize='int8_static') so "
                         "QuantConv layers record amax")
    n = images.shape[0]
    if n == 0:
        raise ValueError("no calibration images")
    model = make_detector(cfg, params, device=device)
    dev = next(model.parameters()).device
    step = max(1, min(max_batch, n))
    amax: Dict[str, torch.Tensor] = {}
    for i in range(0, n, step):
        chunk = images[i:i + step]
        if chunk.shape[0] < step:
            chunk = torch.cat([chunk, chunk[:1].expand(step - chunk.shape[0], *chunk.shape[1:])])
        rec = chunk_amax(model, chunk.to(dev).contiguous())
        amax = rec if not amax else {k: torch.maximum(amax[k], v) for k, v in rec.items()}
    values = torch.stack([amax[k] for k in amax]).cpu().tolist()  # one read-back
    return {k: max(v / 127.0, _EPS) for k, v in zip(amax, values)}


def save_act_scales(path: str, scales: Mapping[str, float]) -> None:
    with open(path, "w") as f:
        json.dump(dict(scales), f, indent=1, sort_keys=True)


def load_act_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()}
