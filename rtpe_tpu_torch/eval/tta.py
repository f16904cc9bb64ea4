"""Test-time augmentation: flip test and multi-scale aggregation.

Port of ``rtpe_tpu/eval/tta.py`` on NHWC tensors.  The reference's
full-quality validation (the 0.698 AP pipeline) runs flip TTA and
multi-scale aggregation through the HigherHRNet repository
(``legacy/valid_ae1dim.py:166-191``, SURVEY.md §6).  The flipped images
ride with the originals as a doubled leading axis (one forward of 2B
per scale), the heatmaps are averaged after :func:`flip_back`, and the
flip's tags are stacked along the tag dimension as in HigherHRNet, so
that the grouping sees D=2 tag vectors.

The arithmetic is the JAX package's, step for step, because the
decode's peak and threshold tests see its roundings: the per-scale sum
``hms[:B] + flip_back(hms[B:])``, accumulated in scale order, then one
division by the number of contributions.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.coco import COCO_FLIP_PAIRS
from ..ops.resize import resize_bilinear


def _flip_perm(j: int, flip_pairs: Sequence[Tuple[int, int]]) -> List[int]:
    perm = list(range(j))
    for a, b in flip_pairs:
        if a < j and b < j:
            perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_back(hms: torch.Tensor,
              flip_pairs: Sequence[Tuple[int, int]] = COCO_FLIP_PAIRS
              ) -> torch.Tensor:
    """Un-flip the maps of a horizontally flipped input: mirror W and
    swap the left/right joint channels (reference ``transforms.py:16-30``;
    NHWC here)."""
    perm = torch.tensor(_flip_perm(hms.shape[-1], flip_pairs),
                        device=hms.device)
    return hms.flip(2).index_select(3, perm)


def flip_joints(joints: np.ndarray, width: float,
                flip_pairs: Sequence[Tuple[int, int]] = COCO_FLIP_PAIRS
                ) -> np.ndarray:
    """Mirror (P, J, >=3) keypoints horizontally with the L/R channel
    swap (reference ``transforms.py:33-47``)."""
    joints = joints.copy()
    joints[..., 0] = width - joints[..., 0] - 1
    for a, b in flip_pairs:
        joints[:, [a, b]] = joints[:, [b, a]]
    return joints


def tta_forward(apply_fn: Callable, img: torch.Tensor,
                num_joints: int = 17,
                with_flip: bool = True,
                scales: Sequence[float] = (1.0,),
                base_hw: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate heatmaps and tags over flip and scales, batched.

    Every aggregation step is elementwise per image, so a batch gives
    each image what it would get alone.

    :param apply_fn: ``f(batch_nhwc) -> (coarse, refined)``, both NHWC,
      coarse carrying [heatmaps | tags] channels and refined the
      heatmaps (the teacher head contract).
    :param img: (B, H, W, 3) preprocessed inputs at scale 1.
    :param base_hw: the output resolution; by default the refined
      resolution of the first scale in ``scales``, as in the JAX package.
    :returns: ``(heatmaps (B, H', W', J), tags (B, H', W', J*D))``,
      float32; D=2 with flip, the two tags of a joint side by side.
    """
    if 1.0 not in [float(s) for s in scales]:
        raise ValueError(
            f"scales {tuple(scales)} must include 1.0: tags are taken "
            f"from the primary scale only (HigherHRNet TTA contract)")
    b, h, w = img.shape[0:3]
    hm_acc = None
    tag_list: List[torch.Tensor] = []
    n_contrib = 0

    def to_base(t, base_hw):
        # a same-shape resize is the identity: skip it
        if (int(t.shape[1]), int(t.shape[2])) == tuple(base_hw):
            return t
        return resize_bilinear(t, base_hw, align_corners=True)

    for scale in scales:
        if scale == 1.0:
            x = img
        else:
            # Python's round (half to even) on a float, as in JAX
            sh = int(round(h * scale / 64)) * 64
            sw = int(round(w * scale / 64)) * 64
            x = resize_bilinear(img, (sh, sw), align_corners=False)
        batch = torch.cat([x, x.flip(2)]) if with_flip else x
        coarse, refined = apply_fn(batch)
        hms = refined[..., :num_joints].float()
        tags = coarse[..., num_joints:].float()

        if base_hw is None:
            base_hw = (int(refined.shape[1]), int(refined.shape[2]))

        hms = to_base(hms, base_hw)
        if with_flip:
            hm = hms[:b] + flip_back(hms[b:])
            n_contrib += 2
        else:
            hm = hms[:b]
            n_contrib += 1
        hm_acc = hm if hm_acc is None else hm_acc + hm

        if scale == 1.0:  # tags only from the primary scale (HHRNet)
            tags_up = to_base(tags, base_hw)
            tag_list.append(tags_up[:b])
            if with_flip:
                tag_list.append(flip_back(tags_up[b:]))

    hm_avg = hm_acc / float(n_contrib)
    if len(tag_list) == 1:
        return hm_avg, tag_list[0]
    j = tag_list[0].shape[-1]
    stacked = torch.stack(tag_list, dim=-1)              # (B, H', W', J, D)
    return hm_avg, stacked.reshape(*stacked.shape[:3], j * len(tag_list))
