"""Learning-rate schedules (port of ``repro/optim/schedule.py``): functions
of the step, evaluated in float32 as the reference does."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup", "constant"]


def constant(lr: float):
    """``fn(step) -> lr`` rounded to float32, as the reference's."""
    value = float(torch.tensor(lr, dtype=torch.float32))
    return lambda step: value


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak``, then cosine decay to ``floor * peak``.
    Returns ``fn(step) -> float``."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)

    def fn(step) -> float:
        step = f32(float(step))
        warm = peak * torch.clamp(step / f32(max(warmup, 1)), max=1.0)
        frac = torch.clamp((step - warmup) / f32(max(total - warmup, 1)), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(f32(math.pi) * frac))
        return float(warm if float(step) < warmup else cos)

    return fn
