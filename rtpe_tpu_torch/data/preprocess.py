"""Inference preprocessing: 64-multiple resize-align and its inverse.

Port of ``rtpe_tpu/data/preprocess.py`` (the reference
``transforms.py`` coordinate math).  The numpy helpers are this
package's own copies; the warp runs in torch on the requested device.
"""

from typing import Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.affine import affine_warp, get_affine_transform

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_multi_scale_size(image_hw: Tuple[int, int], input_size: int,
                         current_scale: float, min_scale: float):
    """:returns: ((w_resized, h_resized), center, scale)."""
    h, w = image_hw
    center = np.array([int(w / 2.0 + 0.5), int(h / 2.0 + 0.5)])

    min_input_size = int((min_scale * input_size + 63) // 64 * 64)
    if w < h:
        w_resized = int(min_input_size * current_scale / min_scale)
        h_resized = int(
            int((min_input_size / w * h + 63) // 64 * 64)
            * current_scale / min_scale)
        scale_w = w / 200.0
        scale_h = h_resized / w_resized * w / 200.0
    else:
        h_resized = int(min_input_size * current_scale / min_scale)
        w_resized = int(
            int((min_input_size / h * w + 63) // 64 * 64)
            * current_scale / min_scale)
        scale_h = h / 200.0
        scale_w = w_resized / h_resized * h / 200.0

    return (w_resized, h_resized), center, np.array([scale_w, scale_h])


def resize_align_multi_scale(image_hwc: np.ndarray, input_size: int = 640,
                             current_scale: float = 1.0,
                             min_scale: float = 1.0,
                             device: DeviceLike = None):
    """:returns: (resized image (h', w', C) float32 tensor on ``device``,
    center, scale)."""
    dev = resolve_device(device)
    size_resized, center, scale = get_multi_scale_size(
        image_hwc.shape[:2], input_size, current_scale, min_scale)
    trans = get_affine_transform(center, scale, 0, size_resized)
    img = torch.from_numpy(np.ascontiguousarray(image_hwc, np.float32))
    out = affine_warp(img.to(dev)[None], torch.from_numpy(trans[None]),
                      (size_resized[1], size_resized[0]))
    return out[0], center, scale


def normalize_image(img_hwc: Union[np.ndarray, torch.Tensor]):
    """[0, 1] RGB -> ImageNet-normalized float32 (numpy or tensor in,
    same kind out)."""
    if isinstance(img_hwc, torch.Tensor):
        mean = torch.from_numpy(IMG_MEAN).to(img_hwc.device)
        std = torch.from_numpy(IMG_STD).to(img_hwc.device)
        return (img_hwc.float() - mean) / std
    return (np.asarray(img_hwc, np.float32) - IMG_MEAN) / IMG_STD


def transform_preds(coords: np.ndarray, center, scale,
                    output_size) -> np.ndarray:
    """Map (N, >=2) heatmap-space coords back to original-image space."""
    target = coords.copy()
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    for p in range(coords.shape[0]):
        xy1 = np.array([coords[p, 0], coords[p, 1], 1.0])
        target[p, 0:2] = (trans @ xy1)[:2]
    return target


def get_final_preds(grouped_joints, center, scale, heatmap_size):
    """Per-person inverse transform (reference ``transforms.py:195-202``)."""
    return [transform_preds(person, center, scale, heatmap_size)
            for person in grouped_joints[0]]
