"""Layer helpers with the JAX package's numerics.

Port of ``rtpe_tpu/models/layers.py``.  Convolutions are plain
``nn.Conv2d`` / ``nn.ConvTranspose2d`` (NCHW weights, the reference
torch layout); their weights take the model's compute dtype (bf16 when
serving).  BatchNorm keeps float32 parameters and statistics and always
computes in float32, returning float32 — the caller casts back to the
compute dtype, as the JAX modules do after each ``batch_norm``.
"""

import torch
from torch import nn

BN_MOMENTUM = 0.1  # torch convention (reference pose_higher_hrnet.py:36)
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` computed in float32 whatever the input dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def conv(in_ch: int, out_ch: int, ksize: int = 3, stride: int = 1,
         padding: int = 0, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, ksize, stride, padding, bias=bias)


def conv_bn(in_ch: int, out_ch: int, ksize: int, stride: int,
            padding: int, relu: bool) -> nn.Sequential:
    """``Sequential(conv, bn[, relu])`` — the reference's module layout
    (so the keys read ``<prefix>.0.weight`` / ``<prefix>.1.weight``).
    Run it with :func:`run_conv_bn`, not by calling it."""
    mods = [conv(in_ch, out_ch, ksize, stride, padding), BatchNorm2d(out_ch)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def run_conv_bn(seq: nn.Sequential, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """conv -> fp32 BN -> cast to ``dtype`` -> optional ReLU."""
    y = seq[1](seq[0](x)).to(dtype)
    if len(seq) > 2:
        y = torch.relu(y)
    return y
