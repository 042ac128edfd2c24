"""nn.Modules of the detector (NCHW feature maps)."""

from .vovnet import VoVNet, VOVNET_STAGE_SPECS
from .fpn import FPN
from .sm_block import SMBlock
from .centernet_head import CenterNetHead
from .detector import CenterNet2Detector

__all__ = [
    "VoVNet",
    "VOVNET_STAGE_SPECS",
    "FPN",
    "SMBlock",
    "CenterNetHead",
    "CenterNet2Detector",
]
