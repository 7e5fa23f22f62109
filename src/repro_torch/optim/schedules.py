"""LR schedules (pure functions of step), the port of
``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 1000, total: int = 100000,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``; a float32 0-d tensor, computed in float32 as
    the JAX package computes it."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
