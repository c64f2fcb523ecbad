"""Learning-rate schedules (multiplicative scales for ``AdamWConfig.lr``);
counterpart of ``repro.optim.schedule``, in float32 on the step's device."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    return torch.clamp((_steps(step) + 1.0) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_scale: float = 0.1) -> torch.Tensor:
    s = _steps(step)
    warm = linear_warmup(step, warmup_steps)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_scale + (1 - final_scale) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
