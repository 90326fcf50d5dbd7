"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``min_frac · peak_lr`` at ``total``, in float32; ``step`` is a tensor
    (the result lies on its device) or an int."""
    stepf = step.float() if isinstance(step, torch.Tensor) else torch.tensor(
        step, dtype=torch.float32)
    warm = peak_lr * stepf / max(warmup, 1)
    t = torch.clamp((stepf - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(stepf < warmup, warm, cos)
