"""LR schedules (warmup + cosine decay) as pure functions of the step.

Port of ``repro.optim.schedules``: float32 throughout, as the reference
computes it, with ``pi`` rounded to float32."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int = 2000,
                  total: int = 100_000, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``; ``step`` an integer tensor."""
    step = step.float()
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
