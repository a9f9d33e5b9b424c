"""Learning-rate schedules (counterpart of ``repro.optim.schedules``).

The same arithmetic as the reference, in float32 where the reference
computes in float32.  ``linear_warmup`` and ``cosine_schedule`` take the
step as a host ``int`` and return a Python float, so a train step gets
its learning rate without waiting for the device; ``cosine_schedule_t``
takes a step tensor and returns a float32 tensor on its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def linear_warmup(step: int, *, peak_lr: float, warmup_steps: int) -> float:
    return peak_lr * min(1.0, (float(step) + 1) / max(1, warmup_steps))


def cosine_schedule(step: int, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> float:
    """Linear warmup over ``warmup_steps``, then a cosine from ``peak_lr``
    down to ``min_ratio * peak_lr`` at ``total_steps``."""
    f32 = np.float32
    s = f32(step)
    warm = min(f32(1.0), (s + f32(1)) / f32(max(1, warmup_steps)))
    frac = np.clip((s - f32(warmup_steps))
                   / f32(max(1, total_steps - warmup_steps)),
                   f32(0.0), f32(1.0))
    cos = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (
        f32(1) + np.cos(f32(math.pi) * frac, dtype=f32))
    return float(f32(peak_lr) * warm * cos)


def cosine_schedule_t(step: torch.Tensor, *, peak_lr: float,
                      warmup_steps: int, total_steps: int,
                      min_ratio: float = 0.1) -> torch.Tensor:
    """``cosine_schedule`` of a step tensor, as a float32 tensor on the
    step's device."""
    s = step.to(torch.float32)
    warm = torch.clamp_max((s + 1) / max(1, warmup_steps), 1.0)
    frac = torch.clamp((s - warmup_steps)
                       / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return peak_lr * warm * cos
