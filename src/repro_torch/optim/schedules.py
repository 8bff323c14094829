"""Learning-rate schedules (``repro/optim/schedules.py``): a step index
(int or tensor) -> a float32 scalar tensor."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    t = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * t / max(warmup_steps, 1)
    progress = ((t - warmup_steps)
                / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(t < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full((), peak_lr, dtype=torch.float32)
