"""Per-joint associative-embedding grouping with an exact LAP solver.

Port of ``rtpe_tpu/decode/group_jit.py:match_by_tag_jit``: a fixed
people table updated joint by joint; each joint builds a rectangular
(K detections x 2m) cost — real person columns at
``round(dist) * 100 - val`` clamped at ``COST_CLAMP`` plus the tie bias
``((2m - r) * c) * 1e-8``, dummy "new person" columns at ``BIG``,
forbidden cells at ``HUGE`` — solves it with every one of its K rows
inserted, then updates the table row by row (the float-key setdefault
merge, last writer wins).  Unlike the JAX function, which ``vmap``
batches, this one takes a batch directly: the images share each
joint's solve.

``lap="xla"`` solves with :func:`~.hungarian_jit.hungarian_rect` in
plain PyTorch; ``lap="pallas"`` with :func:`~..ops.lap.lap_rect`, the
per-joint LAP kernel on CUDA (one launch per joint for the whole
batch, no host sync in the joint loop).

Known divergence from the host grouping (``decode/group.py``): on
exact cost ties the LAP may pick another optimal assignment than
munkres (same total cost).
"""

from typing import Tuple

import torch

from ..ops.group import PeopleState, joint_cost, tie_bias, update_rows
from ..ops.lap import lap_rect
from .hungarian_jit import hungarian_rect

LAPS = ("xla", "pallas")


def match_by_tag_jit(tag_k: torch.Tensor, loc_k: torch.Tensor,
                     val_k: torch.Tensor, max_num_people: int = 30,
                     detection_threshold: float = 0.1,
                     tag_threshold: float = 1.0,
                     use_detection_val: bool = True,
                     ignore_too_much: bool = False,
                     p_max: int = 90,
                     lap: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Group top-k detections.

    :param tag_k: (J, K, D) or (B, J, K, D); loc_k (..., J, K, 2);
      val_k (..., J, K).
    :param lap: ``"xla"`` (plain PyTorch Hungarian) or ``"pallas"``
      (the LAP kernel on CUDA, its plain version on the CPU).
    :returns: (people (..., p_max, J, 3+D), n_people (...,) int32);
      people rows beyond n_people are zeros.
    """
    if lap not in LAPS:
        raise ValueError(f"lap must be one of {LAPS}, got {lap!r}")
    single = tag_k.dim() == 3
    if single:
        tag_k, loc_k, val_k = tag_k[None], loc_k[None], val_k[None]
    b, j, k, d = tag_k.shape
    m = max_num_people
    if k > 2 * m:
        raise ValueError(f"K={k} detections exceed the 2m={2 * m} columns")
    f32 = torch.float32
    dev = tag_k.device
    tag = tag_k.to(f32)
    val = val_k.to(f32)
    rowvec = torch.cat([loc_k.to(f32), val[..., None], tag], dim=-1)
    tag_thr = torch.tensor(tag_threshold, dtype=f32, device=dev)
    det_valid_all = val > torch.tensor(detection_threshold, dtype=f32,
                                       device=dev)
    tie = tie_bias(k, m, dev)
    solve = hungarian_rect if lap == "xla" else lap_rect
    st = PeopleState(b, j, d, p_max, max(p_max, m), dev)
    # no host sync in the joint loop: with lap="pallas" on CUDA it only
    # queues work (17 LAP launches and the update's tensor ops)
    for jj in range(j):
        p_cur = st.npv.clamp(max=m)
        skip_all = (p_cur == m) & ignore_too_much
        det_valid = det_valid_all[:, jj]
        cost, diff = joint_cost(st.means(m), tag[:, jj], val[:, jj],
                                det_valid, p_cur, tie, use_detection_val)
        cols = solve(cost).to(torch.int64)                   # (B, K)
        active = det_valid & ~skip_all[:, None]
        d_at = diff.gather(2, cols.clamp(0, m - 1)[..., None])[..., 0]
        matched = active & (cols < p_cur[:, None]) & (d_at < tag_thr)
        update_rows(st, jj, rowvec[:, jj], tag[:, jj], cols, matched,
                    active & ~matched)
    people, n = st.people, st.npv.to(torch.int32)
    return (people[0], n[0]) if single else (people, n)
