"""LR schedules (pure functions of the step counter).

Counterpart of ``repro/optim/schedule.py``; the step is a Python int and
the rate a Python float, computed in float32 as the reference does."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["cosine_schedule"]


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac * peak_lr`` at ``total_steps`` (held after)."""
    f32 = np.float32

    def lr(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
        t = (step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
        t = min(max(t, f32(0.0)), f32(1.0))
        cos = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (
            f32(1) + f32(math.cos(math.pi * t)))
        return float(f32(peak_lr) * cos)

    return lr
