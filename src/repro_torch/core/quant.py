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
    does, and the two differ in the last bit. On CUDA, PyTorch multiplies
    by the reciprocal when the divisor is a Python number, so the step goes
    in as a tensor on y's device.
    """
    step = torch.as_tensor(out_step, dtype=y.dtype, device=y.device)
    q = round_half_away(y / step)
    return torch.clamp(q, 0, ACT_QMAX).to(out_dtype)


def fold_codes_to_uniform_step(a_u8: torch.Tensor,
                               mul_prev: torch.Tensor) -> tuple:
    """(codes, per-input-channel steps) → (codes', uniform scalar step m̄).

    The popcount contraction cannot carry a per-input-channel Mul_prev, so
    the codes are requantized onto the coarsest channel's grid,
    m̄ = max(max_k m_k, 1e-20):

        a'_k = clip(round_half_away(a_k · (m_k / m̄)), 0, 255)

    in f32, ratio first, as the reference does; m̄ then folds into
    Div_current. Under uniform steps the ratio is exactly 1.0 and the fold
    is the identity. ``mul_prev`` broadcasts against the trailing axis.
    """
    m = mul_prev.to(torch.float32)
    mbar = torch.clamp(torch.max(m), min=1e-20)
    codes = torch.clamp(round_half_away(a_u8.to(torch.float32) * (m / mbar)),
                        0, ACT_QMAX).to(torch.uint8)
    return codes, mbar
