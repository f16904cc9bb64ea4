"""SGDR: cosine annealing with warm restarts and per-cycle rescaling
(port of ``rtpe_tpu/train/schedules.py``; reference ``SgdrScheduler``,
``rtpe/optimization.py:43-108``).

A cosine from ``max_lr`` to ``min_lr`` over ``period`` steps; at every
restart ``max_lr``, ``min_lr`` and ``period`` are multiplied by their
scale factors.  The cycle index is recovered in closed form, in float32
like the JAX version, so the schedule is a pure function of the step.
"""

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SgdrConfig:
    """Defaults mirror ``distillation.py:83-88``."""

    max_lr: float = 0.025
    min_lr: float = 0.003
    period: float = 700.0
    scale_max_lr: float = 1.02
    scale_min_lr: float = 1.0
    scale_period: float = 1.01


def _boundary(p0: float, s: float, k):
    """Cumulative start of cycle k: p0 * (s^k - 1) / (s - 1), float32."""
    f32 = np.float32
    return f32(p0) * (np.power(f32(s), k) - f32(1.0)) / f32(s - 1.0)


def sgdr_schedule(cfg: SgdrConfig):
    """``f(step) -> lr`` as a numpy float32 scalar."""
    f32 = np.float32
    p0 = float(cfg.period)
    s = float(cfg.scale_period)

    def schedule(step):
        t = f32(step)
        if abs(s - 1.0) < 1e-9:
            k = np.floor(t / f32(p0))
            boundary = k * f32(p0)
            period_k = f32(p0)
        else:
            k = np.floor(np.log1p(t * f32(s - 1.0) / f32(p0))
                         / f32(math.log(s)))
            k = np.maximum(k, f32(0.0))
            boundary = _boundary(p0, s, k)
            # float-edge guard: if t fell before the boundary, step back
            k = np.where(boundary > t, k - f32(1.0), k).astype(f32)
            boundary = _boundary(p0, s, k)
            period_k = f32(p0) * np.power(f32(s), k)
        tau = t - boundary
        max_k = f32(cfg.max_lr) * np.power(f32(cfg.scale_max_lr), k)
        min_k = f32(cfg.min_lr) * np.power(f32(cfg.scale_min_lr), k)
        cos = np.cos(f32(np.pi) * np.clip(tau / period_k, f32(0.0), f32(1.0)))
        return f32(min_k + (max_k - min_k) * (f32(1.0) + cos) / f32(2.0))

    return schedule
