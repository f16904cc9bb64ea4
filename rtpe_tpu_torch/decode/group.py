"""Associative-embedding grouping on the host (numpy): the oracle.

Port of ``rtpe_tpu/decode/group.py``, the decision procedure of the
reference ``match_by_tag`` (``rtpe/third_party/group.py:26-97``):
joints in order; detections above ``detection_threshold`` are matched
to existing people by L2 tag distance through a Hungarian assignment
(with the ``round(dist) * 100 - val`` tie-break), gated by
``tag_threshold``; unmatched detections found new people keyed by
their first tag value.

:func:`munkres_assign` solves the zero-padded square assignment with
``scipy.optimize.linear_sum_assignment``, the JAX package's documented
fallback when its native solver (``rtpe_tpu/native/lap.cpp``) is not
built.  On exact cost ties it may pair differently from that solver
and from munkres (the total cost is the same), the caveat the JAX
package states.
"""

import dataclasses
from typing import List

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclasses.dataclass(frozen=True)
class GroupingParams:
    """Mirror of the reference ``Params`` object (``group.py:100-122``)."""

    num_joints: int = 17
    max_num_people: int = 30
    detection_threshold: float = 0.1
    tag_threshold: float = 1.0
    use_detection_val: bool = True
    ignore_too_much: bool = False

    @property
    def joint_order(self) -> List[int]:
        return list(range(self.num_joints))


def munkres_assign(cost: np.ndarray) -> np.ndarray:
    """All (row, col) pairs of the optimal square assignment of ``cost``
    zero-padded to square: munkres-compatible output, (k, 2) int32."""
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    k = max(n, m)
    sq = np.zeros((k, k), dtype=np.float64)
    sq[:n, :m] = cost
    rows, cols = linear_sum_assignment(sq)
    return np.stack([rows, cols], axis=1).astype(np.int32)


def match_by_tag(tag_k: np.ndarray, loc_k: np.ndarray, val_k: np.ndarray,
                 params: GroupingParams) -> np.ndarray:
    """Group one image's top-k detections into people.

    :param tag_k: (J, K, D) tag vectors of the top-k peaks per joint.
    :param loc_k: (J, K, 2) x, y peak locations.
    :param val_k: (J, K) peak scores.
    :returns: (P, J, 3 + D) float32: per person per joint
      (x, y, score, tags...); (0, J, 3 + D) when nothing is detected.
    """
    tag_k = np.asarray(tag_k, dtype=np.float64)
    loc_k = np.asarray(loc_k, dtype=np.float64)
    val_k = np.asarray(val_k, dtype=np.float64)
    d = tag_k.shape[2]
    default = np.zeros((params.num_joints, 3 + d))

    joint_dict = {}
    tag_dict = {}
    for i in range(params.num_joints):
        idx = params.joint_order[i]
        tags = tag_k[idx]
        joints = np.concatenate(
            (loc_k[idx], val_k[idx, :, None], tags), axis=1)
        mask = joints[:, 2] > params.detection_threshold
        tags = tags[mask]
        joints = joints[mask]
        if joints.shape[0] == 0:
            continue

        if i == 0 or len(joint_dict) == 0:
            for tag, joint in zip(tags, joints):
                key = tag[0]
                joint_dict.setdefault(key, np.copy(default))[idx] = joint
                tag_dict[key] = [tag]
            continue

        grouped_keys = list(joint_dict.keys())[:params.max_num_people]
        grouped_tags = [np.mean(tag_dict[k], axis=0) for k in grouped_keys]
        if (params.ignore_too_much
                and len(grouped_keys) == params.max_num_people):
            continue

        diff = joints[:, None, 3:] - np.array(grouped_tags)[None, :, :]
        diff_normed = np.linalg.norm(diff, ord=2, axis=2)
        diff_saved = np.copy(diff_normed)
        if params.use_detection_val:
            diff_normed = np.round(diff_normed) * 100 - joints[:, 2:3]

        num_added = diff.shape[0]
        num_grouped = diff.shape[1]
        if num_added > num_grouped:
            diff_normed = np.concatenate(
                (diff_normed,
                 np.zeros((num_added, num_added - num_grouped)) + 1e10),
                axis=1)

        for row, col in munkres_assign(diff_normed):
            if (row < num_added and col < num_grouped
                    and diff_saved[row][col] < params.tag_threshold):
                key = grouped_keys[col]
                joint_dict[key][idx] = joints[row]
                tag_dict[key].append(tags[row])
            else:
                if row >= num_added:
                    continue
                key = tags[row][0]
                joint_dict.setdefault(key, np.copy(default))[idx] = \
                    joints[row]
                tag_dict[key] = [tags[row]]

    if not joint_dict:
        return np.zeros((0, params.num_joints, 3 + d), dtype=np.float32)
    return np.array([joint_dict[k] for k in joint_dict]).astype(np.float32)
