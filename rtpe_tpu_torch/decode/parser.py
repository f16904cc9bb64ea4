"""HeatmapParser: the full decode pipeline with the reference's API.

Port of ``rtpe_tpu/decode/parser.py`` (the reference's
``group.py:125-287``).  Inputs are NHWC tensors: ``det`` (B, H, W, J),
``tag`` (B, H, W, J*D or D); everything on the device runs on theirs.

* :meth:`HeatmapParser.parse` / :meth:`~HeatmapParser.parse_batch`:
  NMS + top-k on the device (the ``csrc/nms_topk.cu`` kernel on CUDA),
  grouping on the host (:mod:`.group` / :mod:`.group_fast`, munkres
  semantics through scipy), then adjust + refine on the host or the
  device;
* :meth:`~HeatmapParser.parse_fused` /
  :meth:`~HeatmapParser.parse_fused_batch`: the whole decode on the
  device (:mod:`.fused`), one host pull.

``adjust_people`` / ``refine_person`` are the host transliterations of
the HigherHRNet adjust / refine steps (Copyright (c) Microsoft, MIT
License — see ``THIRD_PARTY_NOTICES.md``), kept as the oracles of the
device versions in :mod:`.refine_device`.
"""

from typing import List, Tuple

import numpy as np
import torch

from .fused import _tag_image_batch, decode_full, decode_full_batch
from .group import GroupingParams, match_by_tag
from .group_fast import match_by_tag_fast
from .nms import top_k, top_k_adjusted
from .refine_device import adjust_refine_device, refine_batch_device

__all__ = ["GroupingParams", "HeatmapParser", "adjust_people",
           "refine_person"]

Parsed = Tuple[List[List[np.ndarray]], List[List[float]]]


def adjust_people(people: np.ndarray, det_hw_j: np.ndarray) -> np.ndarray:
    """Quarter-pixel adjust toward the heatmap gradient + 0.5 centering
    (reference ``HeatmapParser.adjust``, ``group.py:181-200``), in place.

    :param people: (P, J, 3+D) grouped joints, x/y in columns 0/1.
    :param det_hw_j: (H, W, J) heatmaps.
    """
    h, w, _ = det_hw_j.shape
    for person in people:
        for joint_id, joint in enumerate(person):
            if joint[2] > 0:
                xf, yf = joint[0:2]
                xi, yi = int(xf), int(yf)
                tmp = det_hw_j[:, :, joint_id]
                if tmp[yi, min(xi + 1, w - 1)] > tmp[yi, max(xi - 1, 0)]:
                    xf += 0.25
                else:
                    xf -= 0.25
                if tmp[min(yi + 1, h - 1), xi] > tmp[max(0, yi - 1), xi]:
                    yf += 0.25
                else:
                    yf -= 0.25
                joint[0:2] = (xf + 0.5, yf + 0.5)
    return people


def refine_person(det: np.ndarray, tag: np.ndarray,
                  keypoints: np.ndarray) -> np.ndarray:
    """Recover the missed joints of one person by a tag-distance
    penalised argmax (reference ``HeatmapParser.refine``,
    ``group.py:202-264``).

    :param det: (H, W, J) heatmaps; tag: (H, W, J, D) or (H, W, J).
    :param keypoints: (J, 3+D) this person's joints, modified and
      returned.
    """
    h, w, num_joints = det.shape
    if tag.ndim == 3:
        tag = tag[:, :, :, None]
    tags = []
    for i in range(keypoints.shape[0]):
        if keypoints[i, 2] > 0:
            x, y = keypoints[i][:2].astype(np.int32)
            tags.append(tag[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1), i])
    if not tags:
        return keypoints
    prev_tag = np.mean(tags, axis=0)

    ans = []
    for i in range(keypoints.shape[0]):
        tmp = det[:, :, i]
        tt = np.sqrt(((tag[:, :, i] - prev_tag[None, None, :]) ** 2)
                     .sum(axis=2))
        y, x = np.unravel_index(np.argmax(tmp - np.round(tt)), tmp.shape)
        xx, yy = x, y
        val = tmp[y, x]
        x = x + 0.5
        y = y + 0.5
        if tmp[yy, min(xx + 1, w - 1)] > tmp[yy, max(xx - 1, 0)]:
            x += 0.25
        else:
            x -= 0.25
        if tmp[min(yy + 1, h - 1), xx] > tmp[max(0, yy - 1), xx]:
            y += 0.25
        else:
            y -= 0.25
        ans.append((x, y, val))
    ans = np.array(ans)
    for i in range(num_joints):
        if ans[i, 2] > 0 and keypoints[i, 2] == 0:
            keypoints[i, :2] = ans[i, :2]
            keypoints[i, 2] = ans[i, 2]
    return keypoints


def _unpack(people: torch.Tensor, n_people: torch.Tensor,
            scores: torch.Tensor) -> Parsed:
    """(B, p_max, J, 3+D) people, (B,) counts, (B, p_max) scores on any
    device -> per image a list of its first n people and their scores."""
    people = people.cpu().numpy()
    n_people = n_people.cpu().numpy()
    scores = scores.cpu().numpy()
    out_p: List[List[np.ndarray]] = []
    out_s: List[List[float]] = []
    for i in range(people.shape[0]):
        n = int(n_people[i])
        out_p.append(list(people[i, :n]))
        out_s.append([float(s) for s in scores[i, :n]])
    return out_p, out_s


class HeatmapParser:
    """Same constructor surface as the reference class (``group.py:125``)."""

    def __init__(self, num_joints=17, max_num_people=30,
                 detection_threshold=0.1, tag_threshold=1.0,
                 use_detection_val=True, ignore_too_much=False,
                 tag_per_joint=True, nms_ksize=5, nms_padding=2):
        self.params = GroupingParams(num_joints, max_num_people,
                                     detection_threshold, tag_threshold,
                                     use_detection_val, ignore_too_much)
        self.tag_per_joint = tag_per_joint
        self.nms_ksize = nms_ksize
        self.nms_padding = nms_padding

    def _fused_kwargs(self) -> dict:
        p = self.params
        return dict(max_num_people=p.max_num_people,
                    detection_threshold=p.detection_threshold,
                    tag_threshold=p.tag_threshold,
                    use_detection_val=p.use_detection_val,
                    ignore_too_much=p.ignore_too_much,
                    tag_per_joint=self.tag_per_joint,
                    nms_ksize=self.nms_ksize, nms_padding=self.nms_padding)

    def top_k(self, det: torch.Tensor, tag: torch.Tensor):
        """NMS + top-k on ``det``'s device, pulled to the host in one go.

        :returns: numpy ``(val_k (B, J, K) float32, loc_k (B, J, K, 2)
          int32, tag_k (B, J, K, D) float32)``.
        """
        val_k, loc_k, tag_k = top_k(det, tag, self.params.max_num_people,
                                    self.nms_ksize, self.nms_padding,
                                    self.tag_per_joint)
        return (val_k.float().cpu().numpy(),
                loc_k.to(torch.int32).cpu().numpy(),
                tag_k.float().cpu().numpy())

    def match(self, val_k, loc_k, tag_k) -> List[np.ndarray]:
        """Host grouping (the oracle) of every image's top-k."""
        return [match_by_tag(t, l, v, self.params)
                for t, l, v in zip(tag_k, loc_k, val_k)]

    def parse(self, det: torch.Tensor, tag: torch.Tensor,
              adjust: bool = True, refine: bool = True, on_device=None
              ) -> Tuple[List[np.ndarray], List[float]]:
        """Full decode of a batch-1 heatmap/tag pair with host grouping.

        :param on_device: when both adjust and refine are asked for, run
          them on ``det``'s device (:meth:`_finish_on_device`); only the
          grouped people cross to the host and back.  ``None`` picks the
          device beyond 32 MB of heatmaps, where pulling them dominates.
        :returns: ``([people], scores)``: people (P, J, 3+D) float32;
          scores are per-person mean joint values before the refine,
          as in the reference (``group.py:272``).
        """
        val_k, loc_k, tag_k = self.top_k(det, tag)
        ans = self.match(val_k, loc_k, tag_k)
        if on_device is None:
            on_device = (det.numel() + tag.numel()) * 4 > 32 * 1024 * 1024
        if on_device and adjust and refine:
            return self._finish_on_device(det, tag, ans[0])

        det_np = det.float().cpu().numpy()
        tag_np = tag.float().cpu().numpy()
        if adjust:
            for b, people in enumerate(ans):
                ans[b] = adjust_people(people, det_np[b])
        scores = [float(person[:, 2].mean()) for person in ans[0]]
        if refine:
            people = ans[0]
            tag_img = self._tag_image(tag_np[0], det_np[0].shape[-1])
            for i in range(len(people)):
                people[i] = refine_person(det_np[0], tag_img, people[i])
            ans = [people]
        return ans, scores

    def parse_batch(self, det: torch.Tensor, tag: torch.Tensor,
                    adjust: bool = True, refine: bool = True,
                    fast: bool = True) -> Parsed:
        """Production batched decode with host grouping.

        The quarter-pixel adjust of every candidate runs with the top-k
        on the device (exact: grouping never moves coordinates);
        grouping runs on the host per image (:func:`match_by_tag_fast`
        unless ``fast=False``); the refine runs on the device for only
        the people with a missing joint, all images at once
        (:func:`refine_batch_device`).

        :param det: (B, H, W, J) heatmaps; tag (B, H, W, J*D or D).
        :returns: ``(people, scores)``: per image, a list of (J, 3+D)
          person arrays and a list of per-person scores.
        """
        fn = top_k_adjusted if adjust else top_k
        val_k, loc_k, tag_k = (t.cpu().numpy() for t in fn(
            det, tag, self.params.max_num_people, self.nms_ksize,
            self.nms_padding, self.tag_per_joint))
        matcher = match_by_tag_fast if fast else match_by_tag
        ans = [list(matcher(t, l, v, self.params))
               for t, l, v in zip(tag_k, loc_k, val_k)]
        scores = [[float(p[:, 2].mean()) for p in people] for people in ans]

        needy = [[k for k, p in enumerate(people) if (p[:, 2] == 0).any()]
                 for people in ans]
        if refine and any(needy):
            b = len(ans)
            j = self.params.num_joints
            d = tag_k.shape[-1]
            padded = np.zeros((b, max(len(ks) for ks in needy), j, 3 + d),
                              np.float32)
            for i, ks in enumerate(needy):
                for slot, k in enumerate(ks):
                    padded[i, slot] = ans[i][k]
            refined = refine_batch_device(
                det, _tag_image_batch(tag, j, self.tag_per_joint),
                torch.from_numpy(padded).to(det.device)).cpu().numpy()
            for i, ks in enumerate(needy):
                for slot, k in enumerate(ks):
                    ans[i][k] = refined[i, slot]
        return ans, scores

    def parse_fused(self, det: torch.Tensor, tag: torch.Tensor
                    ) -> Tuple[List[np.ndarray], List[float]]:
        """Single-image decode on ``det``'s device
        (:func:`~.fused.decode_full`: on CUDA the grouping mega-kernel
        with the greedy solver) + one host pull.  Output contract of
        :meth:`parse` with adjust + refine; assignment ties may pair
        differently from munkres (same total cost)."""
        people, n_people, scores = decode_full(det, tag,
                                               **self._fused_kwargs())
        out_p, out_s = _unpack(people[None], n_people[None], scores[None])
        return out_p, out_s[0]

    def parse_fused_batch(self, det: torch.Tensor, tag: torch.Tensor
                          ) -> Parsed:
        """Whole batch decode on ``det``'s device
        (:func:`~.fused.decode_full_batch`) + one host pull.

        :param det: (B, H, W, J) heatmaps; tag (B, H, W, J*D or D).
        :returns: ``(people, scores)`` — per image, a list of (J, 3+D)
          person arrays (adjusted and refined) and a list of per-person
          scores.
        """
        return _unpack(*decode_full_batch(det, tag, **self._fused_kwargs()))

    def _tag_image(self, tag_hwt: np.ndarray, j: int) -> np.ndarray:
        """(H, W, J*D or D) host tag planes -> (H, W, J, D)."""
        h, w = tag_hwt.shape[:2]
        if self.tag_per_joint:
            return tag_hwt.reshape(h, w, j, tag_hwt.shape[-1] // j)
        d = tag_hwt.shape[-1]
        return np.broadcast_to(tag_hwt[:, :, None, :], (h, w, j, d))

    def _finish_on_device(self, det: torch.Tensor, tag: torch.Tensor,
                          people: List[np.ndarray]):
        """Adjust + scores + refine of one image's grouped people on
        ``det``'s device (:func:`adjust_refine_device`)."""
        j = self.params.num_joints
        if len(people) == 0:
            d = tag.shape[-1] // j if self.tag_per_joint else tag.shape[-1]
            return [np.zeros((0, j, 3 + d), np.float32)], []
        stacked = torch.from_numpy(np.stack(people)).to(det.device)
        tag_img = _tag_image_batch(tag[:1], j, self.tag_per_joint)[0]
        out, scores = adjust_refine_device(det[0], tag_img, stacked)
        return [list(out.cpu().numpy())], [float(s) for s in scores.cpu()]
