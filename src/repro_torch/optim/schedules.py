"""LR schedules (step → lr tensor), composable. Counterpart of
``repro/optim/schedules.py``; a step may be an int or a tensor."""
from __future__ import annotations

import math

import torch

from repro_torch.optim.optimizers import full_like0


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / full_like0(a, b)


def linear_warmup(peak_lr: float, warmup_steps: int):
    def fn(step):
        return peak_lr * torch.clamp(_div(_f32(step), max(warmup_steps, 1)),
                                     max=1.0)
    return fn


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = torch.clamp(_div(s, max(warmup_steps, 1)), max=1.0)
        prog = torch.clamp(_div(s - warmup_steps,
                                max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return peak_lr * warm * cos
    return fn
