"""W1A8 quantization primitives (paper §3.2, Eqs. 3-1, 3-3), forward only.

Weights:      w_b = sign(w) ∈ {-1,+1}.
Activations:  q_a = clip(round(x / s_a), 0, 255).

Counterpart of ``repro/core/quant.py``. The rounding is half away from zero
(the paper's RTL rounder); ``torch.round`` rounds half to even and must not
stand in for it.
"""
from __future__ import annotations

import torch

ACT_QMAX = 255  # uint8 activations, ReLU-style non-negative range [0, 255]


def binarize_weight(w: torch.Tensor) -> torch.Tensor:
    """sign(w) ∈ {-1,+1} (0 maps to +1, matching the RTL sign-bit convention)."""
    return torch.where(w >= 0, 1.0, -1.0).to(w.dtype)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """trunc(x + (x >= 0 ? 0.5 : -0.5)), with the add rounded in x's dtype."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5).to(x.dtype))


def quantize_act(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """q = clip(round(x / s), 0, 255), as a float tensor of x's dtype."""
    return torch.clamp(round_half_away(x / step), 0, ACT_QMAX)


def requant_epilogue(y: torch.Tensor, out_step: float,
                     out_dtype=torch.uint8) -> torch.Tensor:
    """f32 post-scale accumulator → next-layer uint8 codes.

    Divides by the step (never multiplies by its reciprocal): the reference
    does, and the two differ in the last bit.
    """
    q = round_half_away(y / out_step)
    return torch.clamp(q, 0, ACT_QMAX).to(out_dtype)
