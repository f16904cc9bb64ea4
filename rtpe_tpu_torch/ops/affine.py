"""Affine geometry: transform construction (numpy) + on-device warp.

Port of ``rtpe_tpu/ops/affine.py``.  ``get_affine_transform`` and
``invert_affine`` are this package's own numpy copies (the reference's
center/scale(x200)/rot construction, ``transforms.py:59-93``);
``affine_warp`` is the cv2 ``warpAffine(INTER_LINEAR)`` replacement in
torch, bilinear with a 0 border, with the JAX version's arithmetic.
"""

from typing import Tuple

import numpy as np
import torch


def solve_affine(src_pts: np.ndarray, dst_pts: np.ndarray) -> np.ndarray:
    """2x3 affine matrix mapping three src points to three dst points."""
    src = np.asarray(src_pts, dtype=np.float64)
    dst = np.asarray(dst_pts, dtype=np.float64)
    a = np.concatenate([src, np.ones((3, 1))], axis=1)
    return np.linalg.solve(a, dst).T.astype(np.float32)


def _get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([src_point[0] * cs - src_point[1] * sn,
                     src_point[0] * sn + src_point[1] * cs])


def _get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0), inv=False) -> np.ndarray:
    """``scale`` in units of 200 px, ``rot`` in degrees, ``output_size``
    is (w, h)."""
    center = np.asarray(center, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale])
    scale = np.asarray(scale, dtype=np.float32)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180.0
    src_dir = _get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2:, :] = _get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = _get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return solve_affine(dst, src)
    return solve_affine(src, dst)


def invert_affine(m) -> np.ndarray:
    """Invert a (2, 3) affine matrix."""
    m = np.asarray(m, dtype=np.float64)
    ainv = np.linalg.inv(m[:, :2])
    return np.concatenate([ainv, (-ainv @ m[:, 2])[:, None]],
                          axis=1).astype(np.float32)


def affine_warp(x: torch.Tensor, matrix: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Warp NHWC ``x`` with per-sample forward matrices, bilinear,
    0-border.

    :param x: (B, H, W, C) planes.
    :param matrix: (B, 2, 3) *forward* affine (src -> dst pixel coords),
      cv2's convention; inverted here.
    :returns: (B, out_h, out_w, C) in ``x``'s dtype.
    """
    b, in_h, in_w, c = x.shape
    out_h, out_w = out_hw
    xf = x.float()
    mat = matrix.to(device=x.device, dtype=torch.float32)
    a = mat[:, :, :2]
    t = mat[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = torch.where(det == 0, torch.full_like(det, 1e-12), det)
    inv00 = a[:, 1, 1] / det
    inv01 = -a[:, 0, 1] / det
    inv10 = -a[:, 1, 0] / det
    inv11 = a[:, 0, 0] / det
    itx = -(inv00 * t[:, 0] + inv01 * t[:, 1])
    ity = -(inv10 * t[:, 0] + inv11 * t[:, 1])

    dst_x = torch.arange(out_w, device=x.device,
                         dtype=torch.float32)[None, None, :]
    dst_y = torch.arange(out_h, device=x.device,
                         dtype=torch.float32)[None, :, None]

    def per_batch(v):
        return v[:, None, None]

    src_x = per_batch(inv00) * dst_x + per_batch(inv01) * dst_y \
        + per_batch(itx)
    src_y = per_batch(inv10) * dst_x + per_batch(inv11) * dst_y \
        + per_batch(ity)

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    bidx = torch.arange(b, device=x.device)[:, None, None]

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < in_w) & (yi >= 0) & (yi < in_h)
        xi_c = xi.clamp(0, in_w - 1).long()
        yi_c = yi.clamp(0, in_h - 1).long()
        return xf[bidx, yi_c, xi_c] * valid[..., None].float()

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    return out.to(x.dtype)
