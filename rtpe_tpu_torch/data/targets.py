"""Gaussian keypoint-heatmap target generation.

Port of ``rtpe_tpu/data/targets.py``, two implementations of the
reference ``HWHeatmapGenerator`` (``rtpe/dataloaders.py:30-79``):

* :class:`HeatmapGenerator`: host numpy, blit for blit the reference's
  (int-truncated centres, 6 sigma + 3 window, max-combine);
* :func:`render_heatmaps`: torch on the joints' device over a fixed
  (P, J) joint tensor, JAX's values; the same values as the host blits
  for integer sigma (the only ones the reference uses: 2.0 and 7.0),
  because the window condition reduces to ``|p - x| <= 3 sigma + 1`` on
  the integer grid.

PROVENANCE / LICENSE: :class:`HeatmapGenerator` is a blit-for-blit port
of the reference's ``HWHeatmapGenerator`` (itself derived from the
HigherHRNet data loader, Copyright (c) Microsoft, MIT License; see
``THIRD_PARTY_NOTICES.md``).  It is the host oracle of
:func:`render_heatmaps` and the dataset's target renderer.
"""

import math
from typing import Tuple

import numpy as np
import torch


class HeatmapGenerator:
    """Bit-identical host implementation."""

    def __init__(self, num_joints: int = 17, stddev_pixels: float = 2.0):
        self.num_joints = num_joints
        assert stddev_pixels > 0
        self.sigma = stddev_pixels
        size = 6 * self.sigma + 3
        x = np.arange(0, size, 1, float)
        y = x[:, np.newaxis]
        x0 = y0 = 3 * self.sigma + 1
        self.g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2)
                        / (2 * self.sigma ** 2))

    def __call__(self, joints: np.ndarray,
                 out_shape_hw: Tuple[int, int]) -> np.ndarray:
        sigma = self.sigma
        out_h, out_w = out_shape_hw
        hms = np.zeros((self.num_joints, out_h, out_w), dtype=np.float32)
        for p in joints:
            for idx, pt in enumerate(p):
                if pt[2] > 0:
                    x, y = int(pt[0]), int(pt[1])
                    if x < 0 or y < 0 or x >= out_w or y >= out_h:
                        continue
                    ul = (int(np.round(x - 3 * sigma - 1)),
                          int(np.round(y - 3 * sigma - 1)))
                    br = (int(np.round(x + 3 * sigma + 2)),
                          int(np.round(y + 3 * sigma + 2)))
                    c, d = max(0, -ul[0]), min(br[0], out_w) - ul[0]
                    a, b = max(0, -ul[1]), min(br[1], out_h) - ul[1]
                    cc, dd = max(0, ul[0]), min(br[0], out_w)
                    aa, bb = max(0, ul[1]), min(br[1], out_h)
                    hms[idx, aa:bb, cc:dd] = np.maximum(
                        hms[idx, aa:bb, cc:dd], self.g[a:b, c:d])
        return hms


def render_heatmaps(joints: torch.Tensor, out_hw: Tuple[int, int],
                    sigma: float = 2.0) -> torch.Tensor:
    """Renderer on ``joints``' device: the values of JAX's broadcast
    renderer (``rtpe_tpu/data/targets.py:render_heatmaps``).

    JAX broadcasts a (B, P, J, H, W) Gaussian and takes its max over
    people, which XLA fuses; eager, that is ~13 GB a float32 temporary at
    B=16, P=30, J=17 on a 640 x 640 canvas.  Here the Gaussian is
    evaluated once on the integer offsets of its window with the same
    expression, and each visible joint's window is scattered into the
    output with ``amax``: a max is exact and order-free, so the result is
    bitwise the broadcast renderer's, for B * P * J * (2r + 1)^2 values
    instead of B * P * J * H * W.

    :param joints: (B, P, J, 3) fixed-shape keypoints (x, y, vis); pad
      absent people with vis=0.
    :returns: (B, H, W, J) float32 heatmaps (NHWC), contiguous.
    """
    h, w = out_hw
    b, p, j, _ = joints.shape
    dev = joints.device
    # the reference casts with int(), which truncates toward zero: a
    # visible keypoint at x in (-1, 0) lands on column 0 and is rendered
    # (a floor would send it to -1 and drop it)
    x = joints[..., 0].to(torch.int32).long()
    y = joints[..., 1].to(torch.int32).long()
    vis = ((joints[..., 2] > 0)
           & (x >= 0) & (y >= 0) & (x < w) & (y < h))
    # |d| <= 3 sigma + 1 on the integer grid is |d| <= r
    r = int(math.floor(3 * sigma + 1))
    off = torch.arange(-r, r + 1, device=dev)
    d2 = off.float() ** 2
    g = torch.exp(-(d2[None, :] + d2[:, None]) / (2.0 * sigma ** 2))  # [dy, dx]
    py = y[..., None, None] + off[:, None]          # (B, P, J, 2r+1, 1)
    px = x[..., None, None] + off[None, :]          # (B, P, J, 1, 2r+1)
    valid = (vis[..., None, None] & (py >= 0) & (py < h)
             & (px >= 0) & (px < w))
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    ji = torch.arange(j, device=dev)[None, None, :, None, None]
    idx = torch.where(valid, ((bi * h + py) * w + px) * j + ji, 0)
    val = torch.where(valid, g, torch.zeros((), device=dev))
    out = torch.zeros(b * h * w * j, dtype=torch.float32, device=dev)
    out.scatter_reduce_(0, idx.flatten(), val.flatten(), "amax")
    return out.view(b, h, w, j)
