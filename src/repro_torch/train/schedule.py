"""Learning-rate schedules (pure functions of the step counter)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to 1 over ``warmup_steps``, then a cosine down to
    ``min_ratio`` at ``total_steps``: a float32 scalar on ``step``'s
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step) -> float:
    del step
    return 1.0
