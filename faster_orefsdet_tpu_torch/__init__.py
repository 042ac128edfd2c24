"""faster_orefsdet_tpu_torch: the PyTorch/CUDA port of faster_orefsdet_tpu.

The published VoVNet-19-slim-eSE few-shot detector and its DLA-34 + BiFPN,
ResNet-50 + FPN and MobileNetV3-small + FPN families in PyTorch: serving
(support cache -> query path -> packed detections) and episodic
fine-tuning, and the AttentionRPN baseline (FsodRCNN over ResNet-50 C4),
with the JAX package's two
Pallas TPU kernels (fused CGM + conv3, greedy NMS) as hand-written CUDA
kernels for Hopper (``csrc/``). Module names follow the JAX package, which
stays the reference the port is tested against; the port imports nothing of
it. Entry points run on the CUDA device unless given ``device="cpu"``, where
the kernels' plain PyTorch twins run instead.
"""

__version__ = "0.1.0"
