"""Device decode: NMS + top-k -> grouping -> adjust -> refine.

Port of ``rtpe_tpu/decode/fused.py``: :func:`decode_full` (one image)
and :func:`decode_full_batch`.  On CUDA every step runs on the device:
the NMS + top-k kernel (``csrc/nms_topk.cu``), the grouping chosen by
``lap``, then the adjust + capped refine in plain PyTorch; the host
gets the people table, the counts and the scores.

Grouping solvers (``lap``):

* ``"greedy"`` / ``"kernel"``: the grouping mega-kernel
  (``csrc/group_mega.cu``) with its greedy / exact LAP solver;
* ``"lockstep"``: the lockstep greedy kernel (``csrc/group_lockstep.cu``);
* ``"pallas"``: per-joint grouping with the LAP kernel
  (``csrc/lap_rect.cu``), one launch per joint;
* ``"xla"``: per-joint grouping with the plain PyTorch Hungarian;
* ``"auto"``: on CUDA the greedy mega-kernel for :func:`decode_full`
  and the lockstep kernel for :func:`decode_full_batch`, each after a
  one-time self-check against ``"xla"`` (:func:`kernel_selfcheck`)
  that demotes ``auto`` to ``"pallas"`` when the kernel fails it; on
  the CPU the same two solvers' plain versions, unchecked.

The kernels' plain versions serve CPU tensors.  The NMS + top-k kernel
and the grouping kernels run in the same decode; the JAX package's rule
against that (a TPU compiler fault) does not apply.
"""

import os
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import group as mega
from ..ops.group_lockstep import match_by_tag_lockstep
from .group_jit import match_by_tag_jit
from .nms import top_k
from .refine_device import adjust_refine_batch

LAPS = ("auto", "greedy", "kernel", "lockstep", "pallas", "xla")
Decoded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_SELFCHECK_CACHE: Dict[tuple, bool] = {}


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


def _kernel_fits(k: int, m: int, p_max: int) -> bool:
    """Shape envelope of the grouping mega-kernel."""
    return mega.fits(k, m, p_max)


def _group(tag_k, loc_k, val_k, lap: str, **kw):
    """(B, J, K, ...) top-k -> (people (B, p_max, J, 3+D), n (B,))."""
    if lap == "lockstep":
        return match_by_tag_lockstep(tag_k, loc_k, val_k, **kw)
    if lap in ("greedy", "kernel"):
        return mega.match_by_tag_kernel(
            tag_k, loc_k, val_k, solver="greedy" if lap == "greedy" else "lap",
            **kw)
    return match_by_tag_jit(tag_k, loc_k, val_k, lap=lap, **kw)


def kernel_selfcheck(max_num_people: int = 30, p_max: int = 90,
                     num_joints: int = 17, d: int = 1, solver: str = "lap",
                     device="cuda") -> bool:
    """One-time parity probe of a grouping kernel against ``"xla"``.

    Runs the grouping ``solver`` (``"lap"`` / ``"greedy"``: the
    mega-kernel; ``"lockstep"``: the lockstep kernel) and
    ``match_by_tag_jit(lap="xla")`` on ``device`` over a fixture of
    well-separated tag clusters (a unique optimal assignment, so no tie
    can legitimately diverge) and caches the verdict per shapes, solver
    and device.  A mismatch or an exception warns and returns False,
    which demotes ``lap="auto"`` to ``"pallas"``.  ``auto`` runs it only
    on CUDA (see :func:`_resolve_auto_lap`).
    """
    device = torch.device(device)
    key = (max_num_people, p_max, num_joints, d, solver, str(device))
    if key in _SELFCHECK_CACHE:
        return _SELFCHECK_CACHE[key]
    rng = np.random.default_rng(0)
    centers = np.linspace(-6.0, 6.0, 5)
    tags = np.zeros((1, num_joints, max_num_people, d), np.float32)
    for k in range(max_num_people):
        tags[0, :, k, :] = (centers[k % 5]
                            + rng.normal(size=(num_joints, d)) * 0.05)
    locs = rng.uniform(0, 128, size=(1, num_joints, max_num_people, 2)
                       ).astype(np.float32)
    vals = rng.uniform(0.2, 1.0, size=(1, num_joints, max_num_people)
                       ).astype(np.float32)
    vals[0, :, max(1, max_num_people * 2 // 5):] = -1.0  # sub-threshold
    args = [torch.from_numpy(a) for a in (tags, locs, vals)]
    kw = dict(max_num_people=max_num_people, p_max=p_max)
    try:
        args = [a.to(device) for a in args]
        lap = {"lap": "kernel", "greedy": "greedy",
               "lockstep": "lockstep"}[solver]
        p_k, n_k = _group(*args, lap, **kw)
        p_x, n_x = match_by_tag_jit(*args, lap="xla", **kw)
        ok = bool(torch.equal(n_k.cpu(), n_x.cpu())
                  and torch.allclose(p_k.cpu(), p_x.cpu(), atol=1e-4))
        if not ok:
            warnings.warn(
                f"grouping kernel ({solver}) failed the parity self-check "
                "against the 'xla' solver; lap='auto' demoted to 'pallas'")
    except Exception as e:  # any kernel fault demotes, as in JAX
        warnings.warn(f"grouping kernel ({solver}) self-check errored "
                      f"({e!r}); lap='auto' demoted to 'pallas'")
        ok = False
    _SELFCHECK_CACHE[key] = ok
    return ok


def _resolve_auto_lap(max_num_people: int, p_max: int, num_joints: int,
                      d: int, single_image: bool = False,
                      device="cuda") -> str:
    """``auto``: the greedy mega-kernel for one image, the lockstep
    kernel for a batch.  On CUDA the choice must fit the kernel's shape
    envelope and pass :func:`kernel_selfcheck` (unless
    ``RTPE_LAP_SELFCHECK=0``), else it is demoted to ``"pallas"``.  On
    the CPU (the plain versions stand in for the card) no check runs."""
    solver = "greedy" if single_image else "lockstep"
    if torch.device(device).type != "cuda":
        return solver
    if not _kernel_fits(max_num_people, max_num_people, p_max):
        return "pallas"
    if os.environ.get("RTPE_LAP_SELFCHECK", "1") != "0" and \
            not kernel_selfcheck(max_num_people, p_max, num_joints, d,
                                 solver=solver, device=device):
        return "pallas"
    return solver


def _decode(det, tag, max_num_people, detection_threshold, tag_threshold,
            use_detection_val, ignore_too_much, tag_per_joint, nms_ksize,
            nms_padding, p_max, lap, refine_cap, single_image) -> Decoded:
    if lap not in LAPS:
        raise ValueError(f"lap must be one of {LAPS}, got {lap!r}")
    j = det.shape[-1]
    if lap == "auto":
        d = tag.shape[-1] // j if tag_per_joint else tag.shape[-1]
        lap = _resolve_auto_lap(max_num_people, p_max, j, d,
                                single_image=single_image,
                                device=det.device)
    val_k, loc_k, tag_k = top_k(det, tag, max_num_people, nms_ksize,
                                nms_padding, tag_per_joint)
    people_b, n_b = _group(
        tag_k, loc_k, val_k, lap, max_num_people=max_num_people,
        detection_threshold=detection_threshold,
        tag_threshold=tag_threshold, use_detection_val=use_detection_val,
        ignore_too_much=ignore_too_much, p_max=p_max)
    return _refine_tail(det, tag, people_b, n_b, j, tag_per_joint, p_max,
                        refine_cap)


def decode_full(det: torch.Tensor, tag: torch.Tensor,
                max_num_people: int = 30,
                detection_threshold: float = 0.1,
                tag_threshold: float = 1.0,
                use_detection_val: bool = True,
                ignore_too_much: bool = False,
                tag_per_joint: bool = True,
                nms_ksize: int = 5, nms_padding: int = 2,
                p_max: int = 90,
                lap: str = "auto",
                refine_cap: int = 32) -> Decoded:
    """Single-image decode.

    :param det: (1, H, W, J); tag: (1, H, W, J*D or D).
    :param lap: grouping solver (module docstring); ``"auto"`` is the
      greedy mega-kernel.
    :param refine_cap: refine only the first ``refine_cap`` people slots
      when ``n_people`` fits them; 0 disables the cap.
    :returns: (people (p_max, J, 3+D), n_people () int32,
      scores (p_max,)), on ``det``'s device.
    """
    if det.shape[0] != 1:
        raise ValueError(f"decode_full takes one image, got batch "
                         f"{det.shape[0]}: use decode_full_batch")
    people, n, scores = _decode(
        det, tag, max_num_people, detection_threshold, tag_threshold,
        use_detection_val, ignore_too_much, tag_per_joint, nms_ksize,
        nms_padding, p_max, lap, refine_cap, single_image=True)
    return people[0], n[0], scores[0]


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
                      refine_cap: int = 32) -> Decoded:
    """Batched decode.

    :param det: (B, H, W, J); tag: (B, H, W, J*D or D).
    :param lap: grouping solver (module docstring); ``"auto"`` is the
      lockstep kernel.
    :returns: (people (B, p_max, J, 3+D), n_people (B,) int32,
      scores (B, p_max)), on ``det``'s device.
    """
    return _decode(det, tag, max_num_people, detection_threshold,
                   tag_threshold, use_detection_val, ignore_too_much,
                   tag_per_joint, nms_ksize, nms_padding, p_max, lap,
                   refine_cap, single_image=False)
