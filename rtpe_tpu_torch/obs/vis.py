"""Skeleton and heatmap visualization (cv2).

Port of ``rtpe_tpu/obs/vis.py``, the surface of the reference
``rtpe/third_party/vis.py`` that live code uses: per-person skeleton
overlays (:func:`save_valid_image`, used by ``validate_hhrnet.py:104-110``)
and heatmap grids.  ``cv2`` is imported inside each function that draws,
so that importing this module does not need it.
"""

from typing import Optional, Sequence

import numpy as np

# COCO joint order as in data.coco.COCO_JOINT_NAMES; skeleton edges by
# index (the topology the reference draws)
COCO_SKELETON = [
    (0, 1), (1, 2), (2, 0), (1, 3), (2, 4), (3, 5), (4, 6), (5, 6),
    (5, 11), (6, 12), (11, 12), (5, 7), (7, 9), (6, 8), (8, 10),
    (11, 13), (13, 15), (12, 14), (14, 16),
]


def add_joints(image: np.ndarray, joints: np.ndarray, color,
               skeleton=COCO_SKELETON) -> np.ndarray:
    """Draw one person's joints and limbs in place on an HWC uint8 image."""
    import cv2
    for joint in joints:
        if joint[2] > 0:
            cv2.circle(image, (int(joint[0]), int(joint[1])), 1, color, 2)
    for a, b in skeleton:
        if a < len(joints) and b < len(joints):
            ja, jb = joints[a], joints[b]
            if ja[2] > 0 and jb[2] > 0:
                cv2.line(image, (int(ja[0]), int(ja[1])),
                         (int(jb[0]), int(jb[1])), color, 2)
    return image


def save_valid_image(image: np.ndarray, joints: Sequence[np.ndarray],
                     file_name: str, seed: Optional[int] = None) -> None:
    """RGB float/uint8 image + list of (J, >=3) people -> annotated file."""
    import cv2
    img = np.asarray(image)
    if img.dtype != np.uint8:
        lo, hi = img.min(), img.max()
        img = ((img - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)
    img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    rng = np.random.RandomState(seed)
    for person in joints:
        color = [int(c) for c in rng.randint(0, 255, size=3)]
        add_joints(img, np.asarray(person), color)
    cv2.imwrite(file_name, img)


def heatmaps_grid(heatmaps_hwc: np.ndarray, cols: int = 6) -> np.ndarray:
    """(H, W, J) heatmaps -> one (rows*H, cols*W) grayscale grid image."""
    h, w, j = heatmaps_hwc.shape
    rows = (j + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w), dtype=np.float32)
    for i in range(j):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = heatmaps_hwc[:, :, i]
    grid = np.clip(grid, 0.0, 1.0)
    return (grid * 255).astype(np.uint8)
