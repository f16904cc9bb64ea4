"""HeatmapParser: the decode entry point with the reference's API.

Port of ``rtpe_tpu/decode/parser.py`` — this slice carries the batched
device decode, :meth:`HeatmapParser.parse_fused_batch`.  The host
paths (``parse``, ``parse_batch``, munkres grouping) come with a later
slice of the port.
"""

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .fused import decode_full_batch


@dataclasses.dataclass(frozen=True)
class GroupingParams:
    """Mirror of the reference ``Params`` object (``group.py:100-122``)."""

    num_joints: int = 17
    max_num_people: int = 30
    detection_threshold: float = 0.1
    tag_threshold: float = 1.0
    use_detection_val: bool = True
    ignore_too_much: bool = False


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

    def parse_fused_batch(self, det: torch.Tensor, tag: torch.Tensor
                          ) -> Tuple[List[List[np.ndarray]],
                                     List[List[float]]]:
        """Whole batch decode on ``det``'s device + one host pull.

        :param det: (B, H, W, J) heatmaps; tag (B, H, W, J*D or D).
        :returns: ``(people, scores)`` — per image, a list of (J, 3+D)
          person arrays (adjusted and refined) and a list of per-person
          scores.
        """
        p = self.params
        people, n_people, scores = decode_full_batch(
            det, tag, max_num_people=p.max_num_people,
            detection_threshold=p.detection_threshold,
            tag_threshold=p.tag_threshold,
            use_detection_val=p.use_detection_val,
            ignore_too_much=p.ignore_too_much,
            tag_per_joint=self.tag_per_joint, nms_ksize=self.nms_ksize,
            nms_padding=self.nms_padding)
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
