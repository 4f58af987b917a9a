"""Learning-rate schedules as step -> lr callables.

The port of `repro.optim.schedule`: each returns a float32 0-d tensor
on the host, computed in float32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
    return fn


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                         floor: float = 0.0):
    def fn(step):
        s = _f32(step)
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
