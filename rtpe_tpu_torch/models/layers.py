"""Layer helpers with the JAX package's numerics.

Port of ``rtpe_tpu/models/layers.py``.  Convolutions are ``nn.Conv2d``
(NCHW weights, the reference torch layout) that cast their weights to
the input's dtype at use: the teacher holds its weights in the compute
dtype already, and the students keep float32 parameters and compute in
bf16, as flax's ``dtype=bf16, param_dtype=float32`` does, so gradients
land on float32 parameters.

BatchNorm keeps float32 parameters and statistics:

* eval mode is ``nn.BatchNorm2d`` on the float32 input, returning
  float32; the caller casts back to the compute dtype, as the JAX modules
  do after each ``batch_norm``;
* train mode has flax's semantics (``nn.BatchNorm`` with
  ``use_running_average=False``): batch statistics in float32 as
  ``E[x^2] - E[x]^2`` clamped at 0, the running statistics updated with
  flax's momentum 0.9 and the *biased* batch variance (``nn.BatchNorm2d``
  updates ``running_var`` with the unbiased one, a different result),
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, and the
  result in the BN compute dtype (:class:`bn_compute_dtype`: float32, or
  bf16 under the train step's ``bn_dtype``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1  # torch convention (reference pose_higher_hrnet.py:36)
BN_EPS = 1e-5

_BN_COMPUTE_DTYPE = torch.float32


def torch_bn_momentum(torch_momentum: float = BN_MOMENTUM) -> float:
    """torch momentum m means running = (1-m)*running + m*batch; flax
    momentum is the (1-m) factor."""
    return 1.0 - torch_momentum


class bn_compute_dtype:
    """Context manager scoping the train-mode BN output dtype (``None``
    leaves it as it is), as ``rtpe_tpu.models.layers.bn_compute_dtype``
    scopes one trace."""

    def __init__(self, dtype: Optional[torch.dtype]):
        self.dtype = dtype

    def __enter__(self):
        global _BN_COMPUTE_DTYPE
        self._old = _BN_COMPUTE_DTYPE
        if self.dtype is not None:
            _BN_COMPUTE_DTYPE = self.dtype
        return self

    def __exit__(self, *exc):
        global _BN_COMPUTE_DTYPE
        _BN_COMPUTE_DTYPE = self._old
        return False


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """flax's running-statistic update, ``mom * running + (1 - mom) *
    batch`` with the biased batch variance."""
    mom = torch_bn_momentum()
    bn.running_mean.copy_(mom * bn.running_mean + (1 - mom) * mean.float())
    bn.running_var.copy_(mom * bn.running_var + (1 - mom) * var.float())


class BatchNorm2d(nn.BatchNorm2d):
    """Float32 BatchNorm whatever the input dtype; flax's semantics in
    train mode (module docstring)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x.float())
        x32 = x.float()
        mean = x32.mean((0, 2, 3))
        var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean, min=0.0)
        update_running_stats(self, mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(_BN_COMPUTE_DTYPE)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias take the input's dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


def conv(in_ch: int, out_ch: int, ksize: int = 3, stride: int = 1,
         padding: int = 0, bias: bool = False,
         dilation: int = 1) -> nn.Conv2d:
    return Conv2d(in_ch, out_ch, ksize, stride, padding, dilation=dilation,
                  bias=bias)


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
