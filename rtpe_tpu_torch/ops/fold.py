"""Inference BatchNorm folded into the preceding convolution.

Port of ``rtpe_tpu/ops/rowpack.py:fold_bn``.  The other transforms of
``rowpack.py`` (the row-pack layout that answers the TPU's 128-lane
padding) are not carried over: the packed graph computes the same
function in the dense layout.
"""

from typing import Tuple

import torch

BN_EPS = 1e-5


def fold_bn(weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, out_axis: int = 0,
            eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(conv(x, W) - mean) * scale / sqrt(var + eps) + bias`` becomes
    ``conv(x, W * g) + (bias - mean * g)`` with
    ``g = scale / sqrt(var + eps)``, in float32.

    :param weight: the conv weight; its output channels lie on
      ``out_axis`` (0 for a conv's OIHW, 1 for a transposed conv's
      (in, out, kh, kw)).
    :returns: (folded weight, folded bias), float32.
    """
    f32 = torch.float32
    g = scale.to(f32) / torch.sqrt(var.to(f32) + eps)
    shape = [1] * weight.dim()
    shape[out_axis] = -1
    return weight.to(f32) * g.reshape(shape), bias.to(f32) - mean.to(f32) * g
