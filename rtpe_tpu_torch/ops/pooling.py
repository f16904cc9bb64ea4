"""Pooling with torch semantics on NHWC tensors (port of
``rtpe_tpu/ops/pooling.py``).

* ``max_pool`` — torch ``nn.MaxPool2d(k, s, p)``, used by the NMS;
* ``avg_pool`` — ``nn.AvgPool2d`` with ``count_include_pad``, used by
  the students' pyramids (reference ``rtpe/students.py:656-699``);
* ``global_avg_pool`` — ``nn.AdaptiveAvgPool2d(1)`` of the SE layer.

The averages accumulate in float32 and return the input's dtype, as
the JAX versions do.  An NCHW tensor in ``channels_last`` memory, seen
NHWC through ``permute(0, 2, 3, 1)``, goes through without a copy.
"""

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, ksize: int, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
    """NHWC max pool; the border pads with -inf, as torch does."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), ksize, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, ksize: int, stride: int = 1, padding: int = 0,
             count_include_pad: bool = False) -> torch.Tensor:
    """NHWC average pool with torch's ``count_include_pad`` options."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), ksize, stride, padding,
                     count_include_pad=count_include_pad)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C) mean over the spatial dims, float32
    accumulation."""
    return x.float().mean((1, 2)).to(x.dtype)
