"""Distillation dataset: COCO images + targets + teacher predictions.

Port of ``rtpe_tpu/data/dataset.py``, the host-side equivalent of the
reference ``CocoDistillationDataset`` (``rtpe/dataloaders.py:82-257``).
A sample is a dict of numpy arrays (HWC layout) instead of a torch
tuple:

``img_id, img (H,W,3 in [0,1]), mask (H,W), hms (list of (H,W,J)),
teacher_hms (H,W,17), teacher_ae (H,W,D), segm_mask (H,W), joints``,
and ``img_alt`` (H,W,3) with ``alt_colorspace`` ``"LAB"`` or ``"HSV"``
(:mod:`rtpe_tpu_torch.ops.color` on a CPU tensor).

The batched, augmented path on the device is ``pipeline.py``; this
class keeps the reference's per-sample semantics for the evaluation
loops and the minival.
"""

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .coco import (
    CocoAnnotations,
    get_human_segmentation_mask,
    get_ignore_mask,
    get_joints,
)
from ..native import native_bilinear_resize
from ..ops.color import rgb_to_hsv, rgb_to_lab
from ..ops.resize import resize_bilinear_np
from .targets import HeatmapGenerator
from .teacher_cache import load_teacher_prediction

ALT_COLORSPACES = {"LAB": rgb_to_lab, "HSV": rgb_to_hsv}


def _resize_bilinear_host(arr_hwc: np.ndarray, out_hw) -> np.ndarray:
    """Host bilinear resize with torch ``align_corners=True`` semantics
    (the teacher maps are stored at model resolution and upsampled to
    image size, ``dataloaders.py:157-164``): the native loop
    (:mod:`rtpe_tpu_torch.native`), even at equal shapes, as the JAX
    package's ``_resize_bilinear_host``; numpy without it."""
    out = native_bilinear_resize(arr_hwc, tuple(out_hw), align_corners=True)
    if out is not None:
        return out
    return resize_bilinear_np(arr_hwc, tuple(out_hw), align_corners=True)


class CocoDistillationDataset:
    """See module docstring; constructor mirrors the reference."""

    def __init__(self,
                 coco_root_path: str,
                 coco_dataset_name: str,
                 teacher_output_dir: Optional[str] = None,
                 remove_images_without_annotations: bool = False,
                 gt_stddevs_pix: Sequence[float] = (2.0,),
                 num_joints: int = 17,
                 whitelist_ids: Optional[Sequence[int]] = None,
                 alt_colorspace: Optional[str] = None,
                 host_gt_heatmaps: bool = True):
        if alt_colorspace is not None and \
                alt_colorspace not in ALT_COLORSPACES:
            raise ValueError(f"alt_colorspace {alt_colorspace!r} is not one "
                             f"of {sorted(ALT_COLORSPACES)}")
        self.root = coco_root_path
        self.dataset = coco_dataset_name
        self.coco = CocoAnnotations.from_root(coco_root_path,
                                              coco_dataset_name)
        self.num_joints = num_joints
        self.heatmap_generators = [HeatmapGenerator(num_joints, s)
                                   for s in gt_stddevs_pix]
        self.teacher_dir = teacher_output_dir
        self.alt_colorspace = alt_colorspace
        # the device pipeline renders targets from joints on device;
        # setting this False skips the (unused) host gaussian blits
        self.host_gt_heatmaps = host_gt_heatmaps

        self.ids: List[int] = list(self.coco.ids)
        if remove_images_without_annotations:
            self.ids = [i for i in self.ids
                        if len(self.coco.get_ann_ids(i)) > 0]
        if whitelist_ids is not None:
            idset = set(self.ids)
            self.ids = [x for x in whitelist_ids if x in idset]

    def __len__(self) -> int:
        return len(self.ids)

    # ------------------------------------------------------------------
    def load_image(self, img_id: int) -> np.ndarray:
        """RGB float32 in [0, 1] (reference reads BGR via cv2 and flips,
        ``COCODataset.py:118-123``)."""
        import cv2
        path = self.coco.image_path(self.root, self.dataset, img_id)
        img = cv2.imread(path,
                         cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img.astype(np.float32) / 255.0

    def __getitem__(self, idx: int) -> dict:
        img_id = self.ids[idx]
        img = self.load_image(img_id)
        anno = self.coco.load_anns(self.coco.get_ann_ids(img_id))
        mask = get_ignore_mask(self.coco, anno, img_id).astype(np.float32)
        anno = [a for a in anno
                if a.get("iscrowd", 0) == 0 or a.get("num_keypoints", 0) > 0]
        joints = get_joints(anno, self.num_joints)
        hms = [np.transpose(g(joints, mask.shape), (1, 2, 0))
               for g in self.heatmap_generators] \
            if self.host_gt_heatmaps else []

        if self.teacher_dir is not None:
            img_num = "{:012d}".format(img_id)
            t_hms, t_ae = load_teacher_prediction(self.teacher_dir, img_num)
            # the maps are stored at model resolution and upsampled to
            # image size (dataloaders.py:157-164)
            t_hms = _resize_bilinear_host(t_hms, mask.shape)
            t_ae = _resize_bilinear_host(t_ae, mask.shape)
        else:
            t_hms = np.zeros((0,), np.float32)
            t_ae = np.zeros((0,), np.float32)

        segm_mask = get_human_segmentation_mask(
            self.coco, img_id).astype(np.float32)

        sample = {
            "img_id": img_id,
            "img": img,
            "mask": mask,
            "hms": hms,
            "teacher_hms": t_hms,
            "teacher_ae": t_ae,
            "segm_mask": segm_mask,
            "joints": joints,
        }
        if self.alt_colorspace is not None:
            fn = ALT_COLORSPACES[self.alt_colorspace]
            sample["img_alt"] = fn(torch.from_numpy(img)).numpy()
        return sample

    # ------------------------------------------------------------------
    def evaluate(self, all_preds, all_scores,
                 output_dir: Optional[str] = None,
                 img_ids: Optional[list] = None) -> dict:
        """COCO keypoint AP over this dataset's (possibly whitelisted)
        ids — mirrors the reference evaluation path
        (``COCODataset.py:160-222`` + the imgIds restriction of
        ``dataloaders.py:212-232``).

        :param all_preds: per evaluated image (in ``self.ids`` order), a
          list of (J, >=3) arrays [x, y, score, ...].
        :param all_scores: per image, list of person scores.
        :param img_ids: evaluate over exactly these image ids (in
          ``all_preds`` order).  Default: ``self.ids`` — which REQUIRES
          predictions for every id; evaluating a prefix subset against
          the full id list would silently count the never-predicted
          images as total misses and deflate AP.
        """
        from ..eval.cocoeval import KeypointEvaluator

        eval_ids = list(img_ids) if img_ids is not None else self.ids
        if len(all_preds) != len(eval_ids):
            raise ValueError(
                f"{len(all_preds)} predictions for {len(eval_ids)} "
                f"images — pass img_ids for the subset actually "
                f"evaluated (AP over a mismatched id set is silently "
                f"wrong)")
        if len(all_scores) != len(all_preds):
            raise ValueError(
                f"{len(all_scores)} score lists for {len(all_preds)} "
                f"predictions (zip would silently drop the tail)")
        detections = []
        for idx, (people, scores) in enumerate(zip(all_preds, all_scores)):
            img_id = eval_ids[idx]
            for kpt, score in zip(people, scores):
                kpt = np.asarray(kpt, dtype=np.float64)
                flat = kpt[:, :3].reshape(-1).tolist()
                detections.append({
                    "image_id": int(img_id),
                    "keypoints": flat,
                    "score": float(score),
                })
        if output_dir is not None:
            # reference result-file contract
            # (COCODataset.py:168-172,224-249)
            import json
            res_folder = os.path.join(output_dir, "results")
            os.makedirs(res_folder, exist_ok=True)
            res_file = os.path.join(
                res_folder, f"keypoints_{self.dataset}_results.json")
            with open(res_file, "w") as f:
                json.dump(detections, f, sort_keys=True, indent=4)

        ev = KeypointEvaluator(self.coco, img_ids=eval_ids)
        stats = ev.evaluate(detections)
        return stats
