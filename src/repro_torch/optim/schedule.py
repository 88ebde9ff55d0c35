"""Learning-rate schedules (``repro.optim.schedule``).

The reference's train step is jitted, and XLA compiles a division by a
compile-time constant as a product with its float32 reciprocal; the
schedule divides by the constant step counts the same way.
"""
from __future__ import annotations

import math

import torch

from repro_torch.xla_math import f32


def warmup_cosine(step, *, warmup_steps: int = 200, total_steps: int = 10000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_ratio``: a float32 scale
    in (0, 1] multiplied onto the optimizer's base lr."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step * f32(1.0 / max(warmup_steps, 1))
    frac = torch.clamp((step - warmup_steps)
                       * f32(1.0 / max(total_steps - warmup_steps, 1)),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, value: float = 1.0) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step).to(torch.float32), value)
