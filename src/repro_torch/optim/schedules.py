"""Learning-rate schedules (pure functions of the step counter).

The port of `repro/optim/schedules.py`: each schedule maps a step (an
int or a tensor) to a 0-d f32 tensor on the CPU, computed in f32 with the
reference's operation order.  An optimizer takes it as it is (a CPU 0-d
tensor is a scalar to a CUDA operation: no copy, no wait).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["warmup_cosine", "warmup_linear", "constant"]

Schedule = Callable[[int | torch.Tensor], torch.Tensor]


def _step(step: int | torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step).detach().to("cpu", torch.float32)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Schedule:
    def lr(step: int | torch.Tensor) -> torch.Tensor:
        step = _step(step)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def warmup_linear(peak: float, warmup_steps: int,
                  total_steps: int) -> Schedule:
    def lr(step: int | torch.Tensor) -> torch.Tensor:
        step = _step(step)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak * (1 - frac))

    return lr


def constant(value: float) -> Schedule:
    return lambda step: torch.full((), value, dtype=torch.float32)
