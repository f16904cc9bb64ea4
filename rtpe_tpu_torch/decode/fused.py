"""Batched device decode: NMS + top-k -> grouping -> adjust -> refine.

Port of ``rtpe_tpu/decode/fused.py:decode_full_batch``.  On CUDA every
step runs on the device: the NMS + top-k kernel
(``csrc/nms_topk.cu``), the lockstep grouping kernel
(``csrc/group_lockstep.cu``), then the adjust + capped refine in plain
PyTorch; the host gets the people table, the counts and the scores.

Unlike the JAX package there is no one-time kernel self-check that can
demote ``lap="auto"``: on CUDA ``auto`` *is* the lockstep kernel, and
the kernel-vs-plain check lives in ``chip_smoke.py``.  The NMS + top-k
kernel and the grouping kernel run in the same decode; the JAX
package's rule against that (a TPU compiler fault) does not apply.
"""

from typing import Tuple

import torch

from ..ops.group_lockstep import match_by_tag_lockstep
from .nms import top_k
from .refine_device import adjust_refine_batch

_LATER = {
    "kernel": "the grouping mega-kernel (exact LAP)",
    "greedy": "the grouping mega-kernel (greedy)",
    "pallas": "the per-joint LAP kernel",
    "xla": "the jit Hungarian grouping",
}


def _resolve_lap(lap: str) -> str:
    if lap in ("auto", "lockstep"):
        return "lockstep"
    what = _LATER.get(lap.replace("_interpret", ""), repr(lap))
    raise NotImplementedError(
        f"lap={lap!r} needs {what}, which a later slice of the port "
        "brings; this slice has lap='auto' / 'lockstep'")


def _tag_image_batch(tag: torch.Tensor, j: int,
                     tag_per_joint: bool) -> torch.Tensor:
    """(B, H, W, J*D or D) tag planes -> (B, H, W, J, D) float32."""
    b, h, w, _ = tag.shape
    t = tag.float()
    if tag_per_joint:
        return t.reshape(b, h, w, j, t.shape[-1] // j)
    return t[:, :, :, None, :].expand(b, h, w, j, t.shape[-1])


def _refine_tail(det: torch.Tensor, tag: torch.Tensor,
                 people_b: torch.Tensor, n_b: torch.Tensor, j: int,
                 tag_per_joint: bool, p_max: int, refine_cap: int):
    """Batched adjust + scores + capped refine; zeroes the slots beyond
    each image's ``n_people``."""
    tag_img = _tag_image_batch(tag, j, tag_per_joint)
    people_b, scores_b = adjust_refine_batch(det.float(), tag_img, people_b,
                                             n_b, cap=refine_cap)
    slot_valid = (torch.arange(p_max, device=det.device)[None, :]
                  < n_b[:, None])
    people_b = torch.where(slot_valid[..., None, None], people_b, 0.0)
    scores_b = torch.where(slot_valid, scores_b, 0.0)
    return people_b, n_b, scores_b


def decode_full_batch(det: torch.Tensor, tag: torch.Tensor,
                      max_num_people: int = 30,
                      detection_threshold: float = 0.1,
                      tag_threshold: float = 1.0,
                      use_detection_val: bool = True,
                      ignore_too_much: bool = False,
                      tag_per_joint: bool = True,
                      nms_ksize: int = 5, nms_padding: int = 2,
                      p_max: int = 90,
                      lap: str = "auto",
                      refine_cap: int = 32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:param det: (B, H, W, J); tag: (B, H, W, J*D or D).
    :param lap: ``"auto"`` / ``"lockstep"`` (the same thing here); the
      other solvers of the JAX package raise ``NotImplementedError``.
    :returns: (people (B, p_max, J, 3+D), n_people (B,) int32,
      scores (B, p_max)), on ``det``'s device.
    """
    _resolve_lap(lap)
    j = det.shape[-1]
    val_k, loc_k, tag_k = top_k(det, tag, max_num_people, nms_ksize,
                                nms_padding, tag_per_joint)
    people_b, n_b = match_by_tag_lockstep(
        tag_k, loc_k, val_k, max_num_people=max_num_people,
        detection_threshold=detection_threshold,
        tag_threshold=tag_threshold, use_detection_val=use_detection_val,
        ignore_too_much=ignore_too_much, p_max=p_max)
    return _refine_tail(det, tag, people_b, n_b, j, tag_per_joint, p_max,
                        refine_cap)
