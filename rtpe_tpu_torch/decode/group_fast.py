"""Array-based associative-embedding grouping (the production host path).

Port of ``rtpe_tpu/decode/group_fast.py``: the decision procedure of
:func:`~.group.match_by_tag`, with people in preallocated arrays and
running float64 tag sums instead of dicts of lists, and O(1) numpy
calls per joint.

Numerics: the oracle takes person tag means with ``np.mean`` over the
tag history (pairwise summation); here they are ``running_sum /
count``.  Both are float64 and can differ in the last ulp, which could
only change a decision on an exact tie of rounded tag distances.
"""

import numpy as np

from .group import GroupingParams, munkres_assign

__all__ = ["match_by_tag_fast"]


def match_by_tag_fast(tag_k: np.ndarray, loc_k: np.ndarray,
                      val_k: np.ndarray,
                      params: GroupingParams) -> np.ndarray:
    """Group one image's top-k detections into people.

    Same contract as :func:`~.group.match_by_tag`: tag_k (J, K, D),
    loc_k (J, K, 2), val_k (J, K) -> (P, J, 3+D) float32.
    """
    tag_k = np.asarray(tag_k, dtype=np.float64)
    loc_k = np.asarray(loc_k, dtype=np.float64)
    val_k = np.asarray(val_k, dtype=np.float64)
    j_total, k, d = tag_k.shape
    cap = j_total * k  # every detection could found a person
    joints_out = np.zeros((cap, params.num_joints, 3 + d))
    tag_sum = np.zeros((cap, d))
    tag_cnt = np.zeros(cap, dtype=np.int64)
    key_to_idx = {}
    n_people = 0

    def new_person(key, idx, joint, tag):
        nonlocal n_people
        pi = key_to_idx.get(key)
        if pi is None:  # duplicate keys merge, like dict.setdefault
            pi = n_people
            key_to_idx[key] = pi
            n_people += 1
        joints_out[pi, idx] = joint
        # the oracle RESETS the tag history when a key is re-founded
        tag_sum[pi] = tag
        tag_cnt[pi] = 1

    for i in range(params.num_joints):
        idx = params.joint_order[i]
        mask = val_k[idx] > params.detection_threshold
        if not mask.any():
            continue
        tags = tag_k[idx][mask]                    # (n, D)
        joints = np.concatenate(
            (loc_k[idx][mask], val_k[idx][mask][:, None], tags), axis=1)

        if i == 0 or n_people == 0:
            for row in range(joints.shape[0]):
                new_person(tags[row, 0], idx, joints[row], tags[row])
            continue

        g = min(n_people, params.max_num_people)
        if params.ignore_too_much and g == params.max_num_people:
            continue
        means = tag_sum[:g] / tag_cnt[:g, None]    # (g, D)
        diff = joints[:, None, 3:] - means[None, :, :]
        diff_normed = np.linalg.norm(diff, ord=2, axis=2)
        diff_saved = diff_normed
        if params.use_detection_val:
            diff_normed = np.round(diff_normed) * 100 - joints[:, 2:3]
        n = diff_normed.shape[0]
        if n > g:
            diff_normed = np.concatenate(
                (diff_normed, np.full((n, n - g), 1e10)), axis=1)
        for row, col in munkres_assign(diff_normed):
            if row >= n:
                continue
            if col < g and diff_saved[row][col] < params.tag_threshold:
                joints_out[col, idx] = joints[row]
                tag_sum[col] += tags[row]
                tag_cnt[col] += 1
            else:
                new_person(tags[row, 0], idx, joints[row], tags[row])

    if n_people == 0:
        return np.zeros((0, params.num_joints, 3 + d), dtype=np.float32)
    return joints_out[:n_people].astype(np.float32)
