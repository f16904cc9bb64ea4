"""Pooling with torch semantics on NHWC tensors (port of
``rtpe_tpu/ops/pooling.py:max_pool``, the one the NMS uses)."""

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, ksize: int, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
    """NHWC max pool; the border pads with -inf, as torch does."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), ksize, stride, padding)
    return y.permute(0, 2, 3, 1)
