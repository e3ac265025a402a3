"""Learning-rate schedules (port of ``repro.optim.schedules``): pure
functions of the step counter, a 0-d int tensor, returning a 0-d float32
tensor on its device (no host read, so a training step never waits on
the device for its learning rate)."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.to(torch.float32) / total_steps, max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn
