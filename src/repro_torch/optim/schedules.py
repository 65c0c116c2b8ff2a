"""LR schedules as plain functions of an int step (port of
``repro.optim.schedules``).

Each returns a Python float computed in float32, in the reference's
order of operations, so a schedule gives the reference's value at every
step up to the last bit of its cosine.
"""
from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: float(f32(lr))


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = f32(step)
        return float(f32(lr) * np.minimum(f32(1.0), (s + f32(1)) / f32(max(warmup_steps, 1))))
    return f


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    def f(step):
        s = f32(step)
        warm = np.minimum(f32(1.0), (s + f32(1)) / f32(max(warmup_steps, 1)))
        prog = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
        return float(f32(lr) * warm * cos)
    return f
