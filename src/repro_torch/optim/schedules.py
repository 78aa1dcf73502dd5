"""LR schedules (warmup-stable-decay, cosine): the reference's
``repro.optim.schedules`` on a step tensor."""
from __future__ import annotations

import math

import torch


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.0):
    """Warmup-Stable-Decay schedule."""

    def f(step):
        step = step.float()
        warm = peak * step / max(warmup, 1)
        dec_frac = torch.clamp((step - warmup - stable) / max(decay, 1),
                               0.0, 1.0)
        dec = peak + (floor - peak) * dec_frac
        return torch.where(step < warmup, warm, dec)

    return f


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        step = step.float()
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return f
