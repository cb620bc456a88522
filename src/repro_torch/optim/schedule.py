"""LR schedules (pure functions of the step counter) — the port of
``repro.optim.schedule``, in fp32 with the reference's order of ops."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor_frac``
    of it.  ``step`` is the optimizer's counter BEFORE its increment, so
    step 0 runs at lr 0, as in the reference."""
    s = step.to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
