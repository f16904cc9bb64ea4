"""One-matrix batched augmentation (port of ``rtpe_tpu/data/augment.py``).

The reference augments by replaying the same torchvision transform
(flip -> RandomAffine(±45°, ±10% translate, 0.7-1.3 scale) ->
RandomCrop(450)) once per *channel* through PIL images
(``rtpe/helpers.py:214-230``, ``rtpe/dataloaders.py:300-308``,
``distillation.py:234-241``).  Here the same geometry is sampled once
per image as a single 2x3 affine matrix, and the pipeline applies it on
the device to every plane of the sample (image, alt image, masks,
heatmaps, teacher maps) in one batched warp.

The sampler is numpy on an explicit ``np.random.RandomState`` and draws
in JAX's order, so one seed gives JAX's matrices bit for bit.
"""

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Defaults mirror ``distillation.py:67-70,77``."""

    flip_prob: float = 0.5
    max_rotation_deg: float = 45.0
    max_translate: Tuple[float, float] = (0.1, 0.1)
    scale_range: Tuple[float, float] = (0.7, 1.3)
    out_hw: Tuple[int, int] = (450, 450)


def sample_affine_matrices(rng: np.random.RandomState, batch: int,
                           in_hw: Tuple[int, int],
                           cfg: AugmentConfig) -> np.ndarray:
    """Sample (B, 2, 3) forward matrices: src pixel -> out pixel.

    Composition order matches the reference transform stack:
    horizontal flip, then rotate/scale about the image center with
    translation, then a random crop to ``out_hw`` (padded when the
    source is smaller).
    """
    h, w = in_hw
    out_h, out_w = cfg.out_hw
    mats = np.zeros((batch, 2, 3), dtype=np.float32)
    for b in range(batch):
        m = np.eye(3, dtype=np.float64)
        if rng.rand() < cfg.flip_prob:
            f = np.array([[-1, 0, w - 1], [0, 1, 0], [0, 0, 1]],
                         dtype=np.float64)
            m = f @ m
        ang = np.deg2rad(rng.uniform(-cfg.max_rotation_deg,
                                     cfg.max_rotation_deg))
        s = rng.uniform(*cfg.scale_range)
        tx = round(rng.uniform(-cfg.max_translate[0], cfg.max_translate[0])
                   * w)
        ty = round(rng.uniform(-cfg.max_translate[1], cfg.max_translate[1])
                   * h)
        cx, cy = w * 0.5, h * 0.5
        ca, sa = np.cos(ang) * s, np.sin(ang) * s
        aff = np.array([
            [ca, -sa, cx - ca * cx + sa * cy + tx],
            [sa, ca, cy - sa * cx - ca * cy + ty],
            [0, 0, 1]], dtype=np.float64)
        m = aff @ m

        # torchvision RandomCrop(pad_if_needed=True) (reference
        # distillation.py:240): a source smaller than the crop is padded
        # by the shortfall on each side and the offset drawn over the
        # padded extent, so the window start is uniform on [-(out-src), 0]
        def crop_start(src, out):
            if src > out:
                return rng.randint(0, src - out + 1)
            return rng.randint(0, out - src + 1) - (out - src)

        i = crop_start(h, out_h)
        jj = crop_start(w, out_w)
        crop = np.array([[1, 0, -jj], [0, 1, -i], [0, 0, 1]],
                        dtype=np.float64)
        m = crop @ m
        mats[b] = m[:2].astype(np.float32)
    return mats
