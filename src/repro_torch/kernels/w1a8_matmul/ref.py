"""Plain PyTorch version of the W1A8 packed matmul kernel.

    y[m, n] = (Σ_k sign[k, n] · bf16(mul_prev[k] · a[m, k])) · div_post[n] + bias[n]

optionally requantized to uint8 codes with step ``out_step``. The bf16
rounding of the prologue mirrors the reference's Pallas body
(``repro/kernels/w1a8_matmul/kernel.py``), which rounds there; the sum is a
float32 product with ±1.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.quant import requant_epilogue
from repro_torch.device import full_f32


def bf16_prologue(a_u8: torch.Tensor, mul: torch.Tensor) -> torch.Tensor:
    """bf16(a · mul) as float32 values."""
    return (a_u8.to(torch.float32) * mul.to(torch.float32)) \
        .to(torch.bfloat16).to(torch.float32)


def w1a8_matmul_ref(a_u8: torch.Tensor, w_packed: torch.Tensor, k: int,
                    mul_prev: torch.Tensor, div_post: torch.Tensor,
                    bias: torch.Tensor,
                    out_step: Optional[float] = None) -> torch.Tensor:
    """a_u8 (M, ≥k) uint8; w_packed (ceil(k/32), N) int32 words;
    mul_prev (k,); div_post, bias (N,) → (M, N) f32, or uint8 codes."""
    signs = packing.unpack_signs(w_packed, k, axis=0, dtype=torch.float32)
    am = bf16_prologue(a_u8[..., :k], mul_prev)
    with full_f32():
        y = am @ signs
    y = y * div_post.to(torch.float32) + bias.to(torch.float32)
    if out_step is None:
        return y
    return requant_epilogue(y, out_step)
