"""LR schedules (pure functions of the step — restart-safe by construction)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """fp32 0-d tensor lr for a 0-d (int or float) step tensor."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(t < warmup, warm, cos)
