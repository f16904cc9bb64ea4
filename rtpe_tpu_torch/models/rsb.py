"""Residual Step Block (RSN), port of ``rtpe_tpu/models/rsb.py``.

The live part of the reference ``rtpe/third_party/RSB.py:54-137``: a 1x1
expansion to four branch groups, dense intra-scale step aggregation
(branch i at depth d mixes branch i-1's depth-d output), concat, 1x1
projection, residual.  NCHW ``nn.Module``s named as the JAX modules
(``expand.conv``, ``b2_1.bn``, ``downsample_conv``), float32 parameters,
convolutions in ``dtype``, BatchNorm as :mod:`.layers` says.  The
reference's gradient-checkpoint option is ``torch.utils.checkpoint``
around the call, as JAX wraps it in ``jax.checkpoint`` from outside.
"""

import torch
from torch import nn

from .layers import BatchNorm2d, conv


class ConvBnRelu(nn.Module):
    """conv (with bias, ``RSB.py:22-24``) -> BN -> cast -> ReLU."""

    def __init__(self, in_ch: int, features: int, ksize: int = 3,
                 stride: int = 1, padding: int = 1, has_bn: bool = True,
                 has_relu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.has_relu = has_relu
        self.conv = conv(in_ch, features, ksize, stride, padding, bias=True)
        self.bn = BatchNorm2d(features) if has_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.to(self.dtype))
        if self.bn is not None:
            x = self.bn(x).to(self.dtype)
        if self.has_relu:
            x = torch.relu(x)
        return x


class ResidualStepBlock(nn.Module):
    """(B, in_planes, H, W) -> (B, planes, H, W); the residual needs
    ``in_planes == planes`` unless ``downsample`` (a 1x1 projection)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.branch_ch = bc = in_planes * 26 // 64
        self.expand = ConvBnRelu(in_planes, 4 * bc, ksize=1, stride=stride,
                                 padding=0, dtype=dtype)
        for name in ("b1_1", "b2_1", "b2_2", "b3_1", "b3_2", "b3_3",
                     "b4_1", "b4_2", "b4_3", "b4_4"):
            setattr(self, name, ConvBnRelu(bc, bc, dtype=dtype))
        self.project = ConvBnRelu(4 * bc, planes, ksize=1, padding=0,
                                  has_relu=False, dtype=dtype)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(in_planes, planes, 1, stride, 0,
                                        bias=True)
            self.downsample_bn = BatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bc = self.branch_ch
        out = self.expand(x)
        s0, s1, s2, s3 = (out[:, i * bc:(i + 1) * bc] for i in range(4))
        o11 = self.b1_1(s0)
        o21 = self.b2_1(s1 + o11)
        o22 = self.b2_2(o21)
        o31 = self.b3_1(s2 + o21)
        o32 = self.b3_2(o31 + o22)
        o33 = self.b3_3(o32)
        o41 = self.b4_1(s3 + o31)
        o42 = self.b4_2(o41 + o32)
        o43 = self.b4_3(o42 + o33)
        o44 = self.b4_4(o43)
        out = self.project(torch.cat([o11, o22, o33, o44], 1))
        residual = x
        if self.downsample:
            residual = self.downsample_bn(
                self.downsample_conv(x.to(self.dtype))).to(self.dtype)
        out = out.float() + residual.float()
        return torch.relu(out).to(self.dtype)
