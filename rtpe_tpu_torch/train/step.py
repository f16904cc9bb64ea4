"""The distillation train step: dual loss, two SGD groups (port of
``rtpe_tpu/train/step.py``; reference ``distillation.py:289-336``).

* attention parameters (``att``, ``att_top``) step on the segmentation
  BCE (pos_weight 7) against the human-segmentation masks;
* detection parameters (``step0-2``, the alt-image stem, ``det_top``)
  step on the distillation BCE keypoint-mining loss (pos_weight 100,
  alpha 0.8);
* the frozen stem and ``mid_stem`` get no update (they are in no
  optimizer group: no weight decay, no momentum buffer);
* both groups are ``torch.optim.SGD`` (momentum 0.9, weight decay 3e-4,
  dampening 0), which is optax's ``add_decayed_weights -> trace ->
  scale_by_learning_rate`` of the JAX step, first step included (the
  momentum buffer starts as the gradient), each group's lr set to its
  SGDR schedule at the step before ``optimizer.step()``.

One backward computes both gradient sets: the model's
``detach_att_for_det`` blocks the detection loss's gradient into the
attention branch, which the reference computes but never applies.
"""

import dataclasses
from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from ..models.layers import bn_compute_dtype
from ..ops.resize import resize_bilinear
from .losses import bce_with_logits, distillation_bce_loss_keypoint_mining
from .schedules import SgdrConfig, sgdr_schedule


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Hyperparameters, defaults from ``distillation.py:36-101``."""

    distillation_alpha: float = 0.8
    det_pos_weight: float = 100.0
    att_pos_weight: float = 7.0
    background_factor: float = 1.0
    momentum: float = 0.9
    weight_decay: float = 0.0003
    att_sgdr: SgdrConfig = SgdrConfig()
    det_sgdr: SgdrConfig = SgdrConfig()
    # attention-divisor decay (DecayingDivisor, distillation.py:103-121)
    att_div_initial: float = 20.0
    att_div_decay: float = 0.001


ATT_PREFIXES = ("att", "att_top")
DET_PREFIXES = ("alt_stem_conv0", "alt_stem_bn0", "alt_stem_conv1",
                "alt_stem_bn1", "step0", "step1", "step2", "det_top")


def label_params(named: Iterable[Tuple[str, object]]) -> Dict[str, str]:
    """'att' / 'det' / 'frozen' for each parameter name (of
    ``model.named_parameters()``), by its top-level module."""
    labels = {}
    for name, _ in named:
        top = name.split(".")[0]
        labels[name] = ("att" if top in ATT_PREFIXES else
                        "det" if top in DET_PREFIXES else "frozen")
    return labels


def make_distill_optimizer(model: nn.Module, cfg: DistillConfig):
    """SGD with the 'att' and 'det' groups (lr set per step), and the two
    schedules."""
    labels = label_params(model.named_parameters())
    groups = [[p for n, p in model.named_parameters() if labels[n] == g]
              for g in ("att", "det")]
    opt = torch.optim.SGD([{"params": groups[0], "name": "att"},
                           {"params": groups[1], "name": "det"}],
                          lr=0.0, momentum=cfg.momentum, dampening=0.0,
                          weight_decay=cfg.weight_decay, nesterov=False)
    return opt, sgdr_schedule(cfg.att_sgdr), sgdr_schedule(cfg.det_sgdr)


@dataclasses.dataclass
class DistillTrainState:
    """The step count, the model (parameters and BN running statistics)
    and the optimizer (its momentum buffers); the train step updates it
    in place and returns it."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, model: nn.Module, cfg: DistillConfig):
        opt, _, _ = make_distill_optimizer(model, cfg)
        return cls(step=0, model=model, optimizer=opt)


def att_divisor_at(step: int, cfg: DistillConfig) -> torch.Tensor:
    """1 + v0 * exp(-decay * step) in float32 (``distillation.py:116-121``)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return 1.0 + cfg.att_div_initial * torch.exp(-cfg.att_div_decay * t)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def make_distill_train_step(model: nn.Module, cfg: DistillConfig,
                            grad_accum: int = 1, bn_dtype=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` (NHWC, on the model's device): ``img`` (B,H,W,3) normalised,
    ``img_alt`` (B,H,W,3), ``segm_mask`` (B,H,W,1), ``gt_hms`` and
    ``teacher_hms`` (B,H,W,17), ``mask`` (B,H,W,1).  Targets are resized to
    the prediction size with ``resize_bilinear(align_corners=False)``
    inside the step (reference ``distillation.py:315-324``).

    :param grad_accum: with N > 1 the batch runs as N sequential
      micro-batches; their gradients are averaged and one optimizer update
      is applied.  Each micro-batch normalises with its own batch
      statistics, and the running statistics carry from one to the next.
    :param bn_dtype: the train-mode BN output dtype inside the step
      (:class:`rtpe_tpu_torch.models.layers.bn_compute_dtype`); the
      statistics stay float32.
    """
    _, att_sched, det_sched = make_distill_optimizer(model, cfg)

    def losses(outputs, mb):
        att, det = (_nhwc(t) for t in outputs)
        att_hw, det_hw = tuple(att.shape[1:3]), tuple(det.shape[1:3])
        segm = resize_bilinear(mb["segm_mask"], att_hw, align_corners=False)
        gt = resize_bilinear(mb["gt_hms"], det_hw, align_corners=False)
        teacher = resize_bilinear(mb["teacher_hms"], det_hw,
                                  align_corners=False)
        mask = resize_bilinear(mb["mask"], det_hw, align_corners=False)
        mask = torch.broadcast_to(mask, gt.shape)
        # quirk preserved: the reference feeds the *sigmoided* attention
        # map to BCEWithLogits (distillation.py:201-202,326)
        seg = bce_with_logits(att, segm, cfg.att_pos_weight)
        det_loss = distillation_bce_loss_keypoint_mining(
            det, teacher, gt, alpha=cfg.distillation_alpha, mask=mask,
            background_factor=cfg.background_factor,
            teacher_pos_weight=cfg.det_pos_weight,
            gt_pos_weight=cfg.det_pos_weight)
        return seg, det_loss

    def train_step(state: DistillTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[DistillTrainState, Dict[str, float]]:
        net, opt = state.model, state.optimizer
        net.train()
        opt.zero_grad(set_to_none=True)
        b = batch["img"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} "
                             "micro-batches")
        m = b // grad_accum
        divisor = att_divisor_at(state.step, cfg).to(batch["img"].device)
        segs, dets = [], []
        for k in range(grad_accum):
            mb = {key: v[k * m:(k + 1) * m] for key, v in batch.items()}
            with bn_compute_dtype(bn_dtype):
                out = net(_nchw(mb["img"]), _nchw(mb["img_alt"]),
                          att_divisor=divisor)
            seg, det = losses(out, mb)
            (seg + det).backward()
            segs.append(seg.detach())
            dets.append(det.detach())
        if grad_accum > 1:
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
        att_lr, det_lr = att_sched(state.step), det_sched(state.step)
        opt.param_groups[0]["lr"] = float(att_lr)
        opt.param_groups[1]["lr"] = float(det_lr)
        opt.step()
        metrics = {"attention_loss": torch.stack(segs).mean(),
                   "keypoints_loss": torch.stack(dets).mean(),
                   "att_lr": float(att_lr), "det_lr": float(det_lr)}
        state.step += 1
        return state, metrics

    return train_step
