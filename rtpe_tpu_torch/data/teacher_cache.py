"""Precomputed teacher-prediction cache (.npz per image).

Port of ``rtpe_tpu/data/teacher_cache.py``; the file contract is the
reference corpus's (``teacher_inference.py:67-90``, read at
``dataloaders.py:140-165``): ``{OUT_DIR}/{imgname}.jpg_w48_predictions.npz``,
written by ``np.savez_compressed``, with keys ``pred_heatmaps`` (17, h,
w), ``embeddings`` (tag dims, h, w), ``heatmaps_refined`` (17, 2h, 2w)
and ``heatmaps_order`` (the joint names).  Arrays are CHW float32 on
disk and the loader returns HWC.

The port's forward is NCHW, so :func:`save_teacher_prediction` takes
one image's CHW outputs as they come; every member it writes is byte
for byte what the JAX package writes from the same values in HWC.
"""

import os
from typing import Tuple

import numpy as np

from .coco import COCO_JOINT_NAMES as HEATMAPS_ORDER  # the 17-name joint
# order is part of the corpus's byte contract


def prediction_path(out_dir: str, image_basename: str) -> str:
    return os.path.join(out_dir, image_basename + "_w48_predictions.npz")


def save_teacher_prediction(out_dir: str, image_basename: str,
                            coarse_chw: np.ndarray,
                            refined_chw: np.ndarray,
                            num_joints: int = 17) -> str:
    """Save one image's teacher outputs (CHW, as the NCHW forward gives
    them; written C-ordered, as the JAX package writes its transposes)."""
    path = prediction_path(out_dir, image_basename)
    coarse = np.ascontiguousarray(coarse_chw, np.float32)
    refined = np.ascontiguousarray(refined_chw, np.float32)
    np.savez_compressed(path,
                        pred_heatmaps=coarse[:num_joints],
                        embeddings=coarse[num_joints:],
                        heatmaps_refined=refined,
                        heatmaps_order=HEATMAPS_ORDER)
    return path


def load_teacher_prediction(teacher_dir: str, img_num: str,
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Load ``(heatmaps_refined, embeddings)`` as HWC float32: the two
    arrays the distillation dataset reads (``dataloaders.py:149-154``).

    :param img_num: zero-padded 12-digit image id string.
    """
    npz = np.load(prediction_path(teacher_dir, img_num + ".jpg"))
    t_hms = np.transpose(npz["heatmaps_refined"], (1, 2, 0))
    t_ae = np.transpose(npz["embeddings"], (1, 2, 0))
    return t_hms.astype(np.float32), t_ae.astype(np.float32)
