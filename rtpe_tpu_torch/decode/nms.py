"""Max-pool NMS and per-joint top-k (port of ``rtpe_tpu/decode/nms.py``).

NHWC in, like the JAX package: ``det`` (B, H, W, J), ``tag``
(B, H, W, J*D) or (B, H, W, D).  :func:`top_k` goes through
:func:`rtpe_tpu_torch.ops.nms_topk.nms_topk` — the CUDA kernel for a
CUDA tensor, its plain version on the CPU — then gathers the tags.
"""

from typing import Tuple

import torch

from ..ops.nms_topk import nms_topk
from ..ops.pooling import max_pool

TopK = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def nms_heatmaps(det: torch.Tensor, ksize: int = 5,
                 padding: int = 2) -> torch.Tensor:
    """Zero out non-peak pixels of ``det`` (B, H, W, J)."""
    maxm = max_pool(det, ksize, 1, padding)
    return det * (maxm == det).to(det.dtype)


def top_k(det: torch.Tensor, tag: torch.Tensor, max_people: int = 30,
          ksize: int = 5, padding: int = 2,
          tag_per_joint: bool = True) -> TopK:
    """NMS + per-joint top-k peaks.

    :returns: ``(val_k, loc_k, tag_k)`` of shapes (B, J, K),
      (B, J, K, 2) [x, y int32] and (B, J, K, D).
    """
    if padding != ksize // 2:
        raise ValueError(f"top_k pools 'same': padding {padding} must be "
                         f"ksize // 2 = {ksize // 2}")
    b, h, w, j = det.shape
    val_k, x, y = nms_topk(det, max_people, ksize)
    loc_k = torch.stack([x, y], dim=-1)
    ind = (y * w + x).long()                                 # (B, J, K)
    if tag_per_joint:
        d = tag.shape[-1] // j
        tagj = tag.reshape(b, h * w, j, d).permute(0, 2, 1, 3)
    else:
        d = tag.shape[-1]
        tagj = tag.reshape(b, 1, h * w, d).expand(b, j, h * w, d)
    tag_k = tagj.gather(2, ind[..., None].expand(-1, -1, -1, d))
    return val_k, loc_k, tag_k


def adjust_locs(det: torch.Tensor, loc_k: torch.Tensor) -> torch.Tensor:
    """Quarter-pixel adjust of candidate locations: (B, J, K, 2) int ->
    (B, J, K, 2) float32 (+-0.25 toward the larger neighbour, +0.5)."""
    det = det.float()
    b, h, w, j = det.shape
    xi, yi = loc_k[..., 0].long(), loc_k[..., 1].long()
    bb = torch.arange(b, device=det.device)[:, None, None]
    jj = torch.arange(j, device=det.device)[None, :, None]

    def read(yy, xx):
        return det[bb, yy.clamp(0, h - 1), xx.clamp(0, w - 1), jj]

    right = read(yi, (xi + 1).clamp(max=w - 1))
    left = read(yi, (xi - 1).clamp(min=0))
    down = read((yi + 1).clamp(max=h - 1), xi)
    up = read((yi - 1).clamp(min=0), xi)
    fx = torch.where(right > left, xi + 0.25, xi - 0.25) + 0.5
    fy = torch.where(down > up, yi + 0.25, yi - 0.25) + 0.5
    return torch.stack([fx, fy], dim=-1).float()


def top_k_adjusted(det: torch.Tensor, tag: torch.Tensor,
                   max_people: int = 30, ksize: int = 5, padding: int = 2,
                   tag_per_joint: bool = True) -> TopK:
    """:func:`top_k` with :func:`adjust_locs` applied to ``loc_k``."""
    val_k, loc_k, tag_k = top_k(det, tag, max_people, ksize, padding,
                                tag_per_joint)
    return val_k, adjust_locs(det, loc_k), tag_k
