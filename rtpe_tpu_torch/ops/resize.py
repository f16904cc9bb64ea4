"""Resampling with torch ``F.interpolate`` semantics, NHWC.

Port of ``rtpe_tpu/ops/resize.py``: bilinear resize for both
``align_corners`` values as two separable interpolation matmuls
(H-contraction then W-contraction, float32 accumulation) — the same
formulation as the JAX version, so the two agree to float32 rounding —
and nearest x2^k upsampling.
"""

from typing import Tuple

import numpy as np
import torch


def _bilinear_taps(in_size: int, out_size: int, align_corners: bool):
    """(lo, frac) of torch's two-tap bilinear interpolation."""
    if in_size == 1:
        return (np.zeros(out_size, np.int64),
                np.zeros(out_size, np.float64))
    if align_corners:
        if out_size == 1:
            return np.zeros(1, np.int64), np.zeros(1, np.float64)
        src = np.arange(out_size, dtype=np.float64) * ((in_size - 1)
                                                       / (out_size - 1))
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    return lo, src - lo


def _bilinear_weight_matrix(in_size: int, out_size: int,
                            align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) interpolation matrix, float32."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    lo, frac = _bilinear_taps(in_size, out_size, align_corners)
    rows = np.arange(len(lo))
    w[rows, lo] = (1.0 - frac).astype(np.float32)
    np.add.at(w, (rows, np.minimum(lo + 1, in_size - 1)),
              frac.astype(np.float32))
    return w


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``out_hw``; returns ``x``'s
    dtype.  Run with TF32 off (``device.set_tf32(False)``) for float32
    accuracy on CUDA."""
    out_h, out_w = out_hw
    _, in_h, in_w, _ = x.shape
    if (out_h, out_w) == (in_h, in_w):
        return x
    wh = torch.from_numpy(
        _bilinear_weight_matrix(in_h, out_h, align_corners)).to(x.device)
    ww = torch.from_numpy(
        _bilinear_weight_matrix(in_w, out_w, align_corners)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", wh, x.float())
    y = torch.einsum("pw,bowc->bopc", ww, y)
    return y.to(x.dtype)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """torch ``nn.Upsample(scale_factor=k, mode='nearest')`` on NHWC."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor,
                                                                dim=2)
