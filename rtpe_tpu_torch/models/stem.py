"""The HRNet stem shared by the students (port of
``rtpe_tpu/models/stem.py``; reference ``rtpe/students.py:206-295``).

Two stride-2 3x3 conv-BN-ReLUs to 64 channels and four Bottlenecks to
256 channels at 1/4 resolution.  The submodules keep the teacher's torch
names (``conv1``, ``bn1``, ``conv2``, ``bn2``, ``layer1.{i}``), so the
stem of a W48 state dict loads by name
(:func:`rtpe_tpu_torch.models.factory.load_pretrained_stem`).
"""

import torch
from torch import nn

from .blocks import Bottleneck
from .layers import BatchNorm2d, conv

STEM_OUT_CHANS = 256


class StemHRNet(nn.Module):
    """(B, 3, H, W) -> (B, 256, H/4, W/4) in ``dtype``."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2, 1)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv(64, 64, 3, 2, 1)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(
            Bottleneck(64, 64, 1, True),
            *[Bottleneck(256, 64) for _ in range(3)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        x = torch.relu(self.bn1(self.conv1(x)).to(dtype))
        x = torch.relu(self.bn2(self.conv2(x)).to(dtype))
        return self.layer1(x)
