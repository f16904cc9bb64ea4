"""The train step of the legacy students (port of
``rtpe_tpu/train/legacy_steps.py``).

The reference's legacy scripts each pair one student with one loss:
``RefinerStudent`` / ``MultistageStudent`` with the MSE
``DistillationLoss`` and ``CamStudent`` with
``DistillationLossKeypointMining`` at ``background_factor=0.01``
(``legacy/distillation_pcr.py:278``).  One step covers the family: a
single-output student trains on its map, a multi-output one on the sum
of its stages' losses (intermediate supervision).

The optimizer is JAX's ``add_decayed_weights -> trace ->
scale_by_learning_rate(sgdr)`` on every parameter outside the stem,
which is ``torch.optim.SGD`` (momentum 0.9, dampening 0, weight decay
3e-4, not Nesterov), its lr set to the SGDR schedule at the step before
``optimizer.step()``; the stem is in no group.  A parameter of that
group that gets no gradient (``CamStudent``'s ``mid_stem``, frozen
behind the stem) gets a zero gradient, so that it decays and builds
momentum as under optax; ``SGD`` would skip it.

With ``dynamic_loss_scale`` the step follows the reference's
``FP16_Optimizer``: the loss is multiplied by the scaler's power-of-two
scale before the backward, the gradients are divided by it, and on a
non-finite gradient the parameters and the momentum keep their values
while the scale halves; the schedule's step still advances and the BN
running statistics keep the forward's update, as in JAX.

With a ``group`` the step is data-parallel as the distillation step's
(``train/step.py``): the batch reductions over the group, the
gradients averaged over it, the loss the group's mean.
"""

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from ..parallel.dist import (average_gradients, check_equal_shards,
                             global_batch_stats, mean_over_group)
from .loss_scaling import (DynamicScalerState, has_overflow,
                           init_dynamic_scaler, update_scaler)
from .losses import distillation_loss_keypoint_mining
from .schedules import SgdrConfig, sgdr_schedule


@dataclasses.dataclass(frozen=True)
class StudentDistillConfig:
    distillation_alpha: float = 0.5
    background_factor: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0003
    sgdr: SgdrConfig = SgdrConfig()


def student_labels(named: Iterable[Tuple[str, object]]) -> Dict[str, str]:
    """'frozen' for the stem's parameters, 'train' for every other one
    (the legacy scripts train all non-stem parameters with one
    optimizer)."""
    return {name: ("frozen" if name.split(".")[0] == "stem" else "train")
            for name, _ in named}


def make_student_optimizer(model: nn.Module, cfg: StudentDistillConfig):
    """SGD over the 'train' parameters (lr set each step) and the
    schedule."""
    labels = student_labels(model.named_parameters())
    params = [p for n, p in model.named_parameters()
              if labels[n] == "train"]
    opt = torch.optim.SGD(params, lr=0.0, momentum=cfg.momentum,
                          dampening=0.0, weight_decay=cfg.weight_decay,
                          nesterov=False)
    return opt, sgdr_schedule(cfg.sgdr)


@dataclasses.dataclass
class StudentTrainState:
    """The step count, the model (parameters and BN running statistics),
    the optimizer (its momentum buffers) and, under dynamic loss
    scaling, the scaler's state; the train step updates it in place and
    returns it."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scaler: Optional[DynamicScalerState] = None

    @classmethod
    def create(cls, model: nn.Module, cfg: StudentDistillConfig,
               dynamic_loss_scale: bool = False,
               init_scale: float = 2.0 ** 15):
        opt, _ = make_student_optimizer(model, cfg)
        dev = next(model.parameters()).device
        return cls(step=0, model=model, optimizer=opt,
                   scaler=(init_dynamic_scaler(init_scale, dev)
                           if dynamic_loss_scale else None))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def make_student_train_step(model: nn.Module, cfg: StudentDistillConfig,
                            out_hw: Optional[Tuple[int, int]] = None,
                            dynamic_loss_scale: bool = False, group=None):
    """Build ``train_step(state, batch) -> (state, metrics)`` for the
    Refiner / Multistage / Cam students (eager: nothing is compiled).

    ``batch`` (NHWC, on the model's device): ``img`` (B,H,W,3), ``gt_hms``
    and ``teacher_hms`` (B,H,W,C), ``mask`` (B,H,W,1); each output's
    loss takes its first C' channels after a ``resize_bilinear(
    align_corners=False)`` of the targets to its size.  ``metrics``:
    ``loss`` (a float32 tensor) and ``lr``, and under
    ``dynamic_loss_scale`` (the state made with
    ``StudentTrainState.create(..., dynamic_loss_scale=True)``) the new
    ``loss_scale`` and ``overflow`` (1.0 when the update was skipped).
    ``group``: the data-parallel process group (None: this process
    alone), ``batch`` this process's equal share of the global batch.
    """
    _, sched = make_student_optimizer(model, cfg)
    checked = set()

    def loss_of(out, batch):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["img"].device)
        for pred in outs:
            pred = _nhwc(pred)
            hw = tuple(pred.shape[1:3])
            gt = resize_bilinear(batch["gt_hms"], hw, align_corners=False)
            teacher = resize_bilinear(batch["teacher_hms"], hw,
                                      align_corners=False)
            mask = resize_bilinear(batch["mask"], hw, align_corners=False)
            c = pred.shape[-1]
            total = total + distillation_loss_keypoint_mining(
                pred, teacher[..., :c], gt[..., :c],
                alpha=cfg.distillation_alpha,
                mask=torch.broadcast_to(mask, gt[..., :c].shape),
                background_factor=cfg.background_factor)
        return total

    def train_step(state: StudentTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[StudentTrainState, Dict[str, object]]:
        net, opt = state.model, state.optimizer
        net.train()
        opt.zero_grad(set_to_none=True)
        kw = {} if out_hw is None else {"out_hw": tuple(out_hw)}
        b = batch["img"].shape[0]
        if group is not None and b not in checked:
            check_equal_shards(b, group, batch["img"].device)
            checked.add(b)
        with global_batch_stats(group):
            loss = loss_of(net(_nchw(batch["img"]), **kw), batch)
        base = getattr(opt, "base", opt)
        params = base.param_groups[0]["params"]
        if dynamic_loss_scale:
            scale = state.scaler.scale
            (loss * scale).backward()
            for p in params:
                if p.grad is not None:
                    p.grad.div_(scale)
        else:
            loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if group is not None:
            average_gradients(params, group)
            loss = mean_over_group((loss,), group)[0]
        if dynamic_loss_scale:
            overflow = has_overflow([p.grad for p in params])
        lr = sched(state.step)
        opt.param_groups[0]["lr"] = float(lr)
        metrics = {"loss": loss.detach(), "lr": float(lr)}
        if dynamic_loss_scale:
            if not bool(overflow):
                opt.step()
            state.scaler = update_scaler(state.scaler, overflow)
            metrics["loss_scale"] = state.scaler.scale
            metrics["overflow"] = overflow.float()
        else:
            opt.step()
        state.step += 1
        return state, metrics

    return train_step
