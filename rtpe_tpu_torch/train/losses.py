"""Loss functions (port of ``rtpe_tpu/train/losses.py``; reference
``rtpe/optimization.py:114-257``), all in float32.

* :func:`masked_mse` — MSE of mask-multiplied inputs;
* :func:`bce_with_logits` / :func:`masked_bce_with_logits` — torch's
  ``BCEWithLogitsLoss`` with ``pos_weight``; the masked form multiplies
  the *logits* by the mask (a reference quirk, kept);
* :func:`distillation_loss` — ``alpha * L(student, teacher) + (1 - alpha)
  * L(student, gt)``, MSE flavour, and its keypoint-mining variant;
* :func:`distillation_bce_loss_keypoint_mining` — the detection loss of
  the distillation step: min-max normalised gt and teacher maps,
  background (gt == 0) mask scaling, BCE.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.dist import all_reduce_extreme, stats_group


def masked_mse(pred: torch.Tensor, gt: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    pred, gt = pred.float(), gt.float()
    if mask is not None:
        mask = mask.float()
        pred, gt = pred * mask, gt * mask
    return torch.mean((pred - gt) ** 2)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Mean of ``-[w y log s(x) + (1 - y) log(1 - s(x))]`` with the stable
    log-sigmoid."""
    x, y = logits.float(), targets.float()
    loss = -(pos_weight * y * F.logsigmoid(x)
             + (1.0 - y) * F.logsigmoid(-x))
    return torch.mean(loss)


def masked_bce_with_logits(pred: torch.Tensor, gt: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           pos_weight: float = 1.0) -> torch.Tensor:
    if mask is not None:
        mask = mask.float()
        pred = pred.float() * mask  # quirk: masks the logits
        gt = gt.float() * mask
    return bce_with_logits(pred, gt, pos_weight)


def distillation_loss(student_pred, teacher_pred, gt, alpha=0.5, mask=None):
    """MSE flavour (reference ``DistillationLoss.forward``)."""
    t = masked_mse(student_pred, teacher_pred, mask)
    g = masked_mse(student_pred, gt, mask)
    return alpha * t + (1.0 - alpha) * g


def mining_mask(gt: torch.Tensor, mask: torch.Tensor,
                background_factor: float) -> torch.Tensor:
    """Scale the mask where gt == 0 (keypoint mining,
    ``optimization.py:199-202``)."""
    gt, mask = gt.float(), mask.float()
    return torch.where(gt == 0, mask * background_factor, mask)


def distillation_loss_keypoint_mining(student_pred, teacher_pred, gt,
                                      alpha=0.5, mask=None,
                                      background_factor=0.0):
    if mask is not None:
        mask = mining_mask(gt, mask, background_factor)
    return distillation_loss(student_pred, teacher_pred, gt, alpha, mask)


def _minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """Sequential shift-then-scale of ``optimization.py:238-246``; the
    minimum and maximum are the global batch's inside
    :class:`~rtpe_tpu_torch.parallel.dist.global_batch_stats` (the
    callers detach the result)."""
    x = x.float()
    group = stats_group()
    xmin = torch.min(x)
    if group is not None:
        xmin = all_reduce_extreme(xmin, group, "min")
    x = torch.where(xmin < 0, x - xmin, x)
    xmax = torch.max(x)
    if group is not None:
        xmax = all_reduce_extreme(xmax, group, "max")
    return torch.where(xmax > 1, x / xmax, x)


def distillation_bce_loss_keypoint_mining(student_pred, teacher_pred, gt,
                                          alpha=0.5, mask=None,
                                          background_factor=0.0,
                                          teacher_pos_weight=1.0,
                                          gt_pos_weight=1.0):
    """The detection loss of ``distillation.py:200,331-336``."""
    gt = _minmax_normalize(gt).detach()
    teacher_pred = _minmax_normalize(teacher_pred).detach()
    if mask is not None:
        mask = mining_mask(gt, mask, background_factor).detach()
    t = masked_bce_with_logits(student_pred, teacher_pred, mask,
                               teacher_pos_weight)
    g = masked_bce_with_logits(student_pred, gt, mask, gt_pos_weight)
    return alpha * t + (1.0 - alpha) * g
