"""Minimal COCO keypoint-annotation reader (pure JSON, no pycocotools).

Port of ``rtpe_tpu/data/coco.py``, numpy and ``json`` only: the subset
of the pycocotools ``COCO`` API the reference uses
(``rtpe/third_party/COCODataset.py``, ``rtpe/dataloaders.py``): image
and annotation indexing, per-image annotation lookup with crowd
filtering, and mask conversion.
"""

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .rle import segmentation_to_mask

COCO_NUM_JOINTS = 17

# COCO keypoint order (teacher_inference.py:38-40)
COCO_JOINT_NAMES = [
    "nose", "leye", "reye", "lear", "rear", "lshould", "rshould",
    "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip",
    "lknee", "rknee", "lankle", "rankle",
]

# left/right pairs for horizontal flip (standard COCO)
COCO_FLIP_PAIRS = [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                   (13, 14), (15, 16)]


class CocoAnnotations:
    """Indexed view over a ``person_keypoints_*.json`` file."""

    def __init__(self, anno_path: str):
        with open(anno_path) as f:
            data = json.load(f)
        self.imgs: Dict[int, dict] = {im["id"]: im for im in data["images"]}
        self.anns: Dict[int, dict] = {a["id"]: a
                                      for a in data.get("annotations", [])}
        self.img_to_anns: Dict[int, List[int]] = defaultdict(list)
        for a in data.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a["id"])
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.person_cat_id = next(
            (cid for cid, c in self.cats.items() if c["name"] == "person"), 1)
        self.ids = list(self.imgs.keys())

    @classmethod
    def from_root(cls, coco_root: str, dataset: str) -> "CocoAnnotations":
        """Path contract of the reference (``COCODataset.py:69-87``)."""
        return cls(os.path.join(coco_root, "annotations",
                                f"person_keypoints_{dataset}.json"))

    # ------------------------------------------------------------------
    def get_ann_ids(self, img_id: int,
                    iscrowd: Optional[bool] = None) -> List[int]:
        ids = self.img_to_anns.get(img_id, [])
        if iscrowd is None:
            return list(ids)
        return [i for i in ids
                if bool(self.anns[i].get("iscrowd", 0)) == iscrowd]

    def load_anns(self, ann_ids: List[int]) -> List[dict]:
        return [self.anns[i] for i in ann_ids]

    def img_info(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def image_path(self, coco_root: str, dataset: str, img_id: int) -> str:
        file_name = self.imgs[img_id]["file_name"]
        return os.path.join(coco_root, "images", dataset, file_name)

    def ann_to_mask(self, ann: dict, img_id: Optional[int] = None
                    ) -> np.ndarray:
        info = self.imgs[img_id if img_id is not None else ann["image_id"]]
        return segmentation_to_mask(ann["segmentation"],
                                    info["height"], info["width"])


def get_joints(anno: List[dict], num_joints: int = COCO_NUM_JOINTS
               ) -> np.ndarray:
    """(num_people, J, 3) keypoints array (reference
    ``dataloaders.py:203-210``)."""
    joints = np.zeros((len(anno), num_joints, 3))
    for i, obj in enumerate(anno):
        joints[i, :num_joints, :3] = \
            np.array(obj["keypoints"]).reshape([-1, 3])
    return joints


def get_ignore_mask(coco: CocoAnnotations, anno: List[dict],
                    img_id: int) -> np.ndarray:
    """Boolean mask that is False over crowd / unannotated people
    (reference ``get_mask``, ``dataloaders.py:167-181``: regions where
    the accumulated crowd mask >= 0.5 are excluded)."""
    info = coco.img_info(img_id)
    h, w = info["height"], info["width"]
    m = np.zeros((h, w), dtype=np.float64)
    for obj in anno:
        if obj.get("iscrowd"):
            m += segmentation_to_mask(obj["segmentation"], h, w)
        elif obj.get("num_keypoints", 0) == 0:
            m += segmentation_to_mask(obj["segmentation"], h, w)
    return m < 0.5


def get_human_segmentation_mask(coco: CocoAnnotations,
                                img_id: int) -> np.ndarray:
    """Union of all non-crowd person segmentations (reference
    ``get_human_segmentation_mask``, ``dataloaders.py:183-201``)."""
    info = coco.img_info(img_id)
    h, w = info["height"], info["width"]
    mask = np.zeros((h, w), dtype=bool)
    for aid in coco.get_ann_ids(img_id, iscrowd=False):
        a = coco.anns[aid]
        if a["category_id"] == coco.person_cat_id:
            mask |= coco.ann_to_mask(a, img_id).astype(bool)
    return mask


def read_whitelist(path: str) -> List[int]:
    """Minival id list file -> int ids (``distillation.py:221-222``)."""
    with open(path) as f:
        return [int(line.rstrip(".jpg\n")) for line in f if line.strip()]
