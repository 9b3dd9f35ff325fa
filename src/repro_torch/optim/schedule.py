"""Learning-rate schedules as step -> lr callables on tensors.

Port of ``repro.optim.schedule``: ``step`` is a tensor (a () step counter
on the device, or a batch of steps) and the rate comes back as a float32
tensor beside it, so a schedule reads nothing back to the host.
"""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def f(step):
        return torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    return f


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        t = torch.clamp(s / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)

    return f


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(torch.as_tensor(step) - warmup_steps))

    return f
