"""Loss scaling, static and dynamic (port of
``rtpe_tpu/train/loss_scaling.py``).

bf16 training needs no loss scaling: bf16 has float32's exponent range.
This module exists for parity with the reference's fp16 machinery
(``rtpe/third_party/fp16_utils/loss_scaler.py``): a static scaler, and
a dynamic one that halves its scale on a non-finite gradient (the step
is skipped) and doubles it after 1000 clean steps.

The dynamic state is two 0-dim tensors on the gradients' device, updated
with ``torch.where`` as JAX's ``jnp.where``; ``grads`` is a tensor, or a
list, tuple or dict of them (``None`` entries skipped).
"""

from typing import NamedTuple

import torch

from ..device import DeviceLike, resolve_device


class DynamicScalerState(NamedTuple):
    scale: torch.Tensor       # float32: the current loss scale
    good_steps: torch.Tensor  # int32: consecutive overflow-free steps


def init_dynamic_scaler(init_scale: float = 2.0 ** 32,
                        device: DeviceLike = None) -> DynamicScalerState:
    """The dynamic state on ``device`` (``None``: CUDA, raising without
    it; the CPU only when asked for)."""
    device = resolve_device(device)
    return DynamicScalerState(
        scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device))


def _leaves(grads):
    if isinstance(grads, torch.Tensor):
        return [grads]
    if isinstance(grads, dict):
        grads = list(grads.values())
    return [t for g in grads if g is not None for t in _leaves(g)]


def _map(fn, grads):
    if grads is None:
        return None
    if isinstance(grads, torch.Tensor):
        return fn(grads)
    if isinstance(grads, dict):
        return {k: _map(fn, v) for k, v in grads.items()}
    return type(grads)(_map(fn, g) for g in grads)


def has_overflow(grads) -> torch.Tensor:
    """True (a 0-dim bool tensor) if any gradient entry is non-finite
    (reference ``loss_scaler.py:127-145``)."""
    flags = [~torch.isfinite(g.float()).all() for g in _leaves(grads)]
    return torch.stack(flags).any() if flags else torch.tensor(False)


def update_scaler(state: DynamicScalerState, overflow: torch.Tensor,
                  scale_window: int = 1000, scale_factor: float = 2.0,
                  min_scale: float = 1.0) -> DynamicScalerState:
    """Reference dynamics (``loss_scaler.py:145-167``): halve (floored at
    ``min_scale``) on overflow and reset the window; double every
    ``scale_window`` clean steps."""
    overflow = torch.as_tensor(overflow, device=state.scale.device)
    full = state.good_steps + 1 >= scale_window
    new_scale = torch.where(
        overflow, torch.clamp(state.scale / scale_factor, min=min_scale),
        torch.where(full, state.scale * scale_factor, state.scale))
    new_good = torch.where(overflow | full,
                           torch.zeros_like(state.good_steps),
                           state.good_steps + 1)
    return DynamicScalerState(scale=new_scale.to(torch.float32),
                              good_steps=new_good.to(torch.int32))


def scaled_grads_or_skip(grads, state: DynamicScalerState):
    """Unscale the gradients, or zero them all on overflow (the skip of
    ``fp16_optimizer.py:369-375``).

    :returns: (float32 unscaled-or-zero grads, new scaler state, the
      overflow flag)
    """
    overflow = has_overflow(grads)
    inv = 1.0 / state.scale
    out = _map(lambda g: torch.where(overflow, torch.zeros_like(
        g, dtype=torch.float32), g.float() * inv), grads)
    return out, update_scaler(state, overflow), overflow


class StaticScaler:
    """Reference static scaler (``loss_scaler.py:45-78``): a constant
    scale, overflow never checked."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def scale_loss(self, loss):
        return loss * self.scale

    def unscale_grads(self, grads):
        if self.scale == 1.0:
            return grads
        inv = 1.0 / self.scale
        return _map(lambda g: g * inv, grads)
