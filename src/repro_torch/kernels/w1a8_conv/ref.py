"""Plain PyTorch version of the W1A8 3×3 SAME conv kernels (NHWC, stride 1).

Mirrors the reference's Pallas dot body (``repro/kernels/w1a8_conv/
kernel.py``): im2col in (dy, dx, cin) order with zeroed K-pad lanes, the
``conv_mul9`` prologue rounded to bf16, a float32 product with the ±1 signs,
then Div/bias and the optional requant. The popcount versions contract the
same im2col codes, zero codes in the K-pad lanes, with `xnor_accumulate`
(the reference's ``_conv_popcount_kernel`` and fused ``_popcount_kernel``).
Weight layout: w (3, 3, Cin, Cout)
flattened to (9·Cin, Cout) in (dy, dx, cin) order and packed along it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.quant import requant_epilogue
from repro_torch.device import full_f32
from repro_torch.kernels.w1a8_matmul.ref import (bf16_prologue,
                                                 popcount_epilogue,
                                                 xnor_accumulate)


def im2col_3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, 9C) patches, SAME zero padding, (dy,dx,c) order."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1)


def conv_mul9(mul_prev: torch.Tensor) -> torch.Tensor:
    """(Cin,) input-channel scales → (1, K9p) prologue vector (zeros pad K)."""
    m9 = mul_prev.to(torch.float32).reshape(-1).repeat(9)
    k9p = packing.packed_dim(m9.shape[0]) * packing.PACK
    return F.pad(m9, (0, k9p - m9.shape[0])).reshape(1, k9p)


def w1a8_conv3x3_ref(a_u8: torch.Tensor, w_packed: torch.Tensor, cin: int,
                     mul_prev: torch.Tensor, div_post: torch.Tensor,
                     bias: torch.Tensor,
                     out_step: Optional[float] = None) -> torch.Tensor:
    """a_u8 (B,H,W,Cin) uint8 codes; w_packed (ceil(9Cin/32), Cout) int32;
    mul_prev (Cin,); div_post/bias (Cout,) → (B,H,W,Cout) f32 or uint8."""
    mul9 = conv_mul9(mul_prev).to(a_u8.device)
    k9p = mul9.shape[1]
    signs = packing.unpack_signs(w_packed, k9p, axis=0, dtype=torch.float32)
    cols = im2col_3x3(a_u8)
    cols = F.pad(cols, (0, k9p - cols.shape[-1]))       # K-pad lanes: 0
    am = bf16_prologue(cols, mul9.reshape(-1))
    with full_f32():
        y = am @ signs
    y = y * div_post.to(torch.float32) + bias.to(torch.float32)
    if out_step is None:
        return y
    return requant_epilogue(y, out_step)


def maxpool2_codes(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max over (B, H, W, C) codes → (B, H/2, W/2, C)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def w1a8_conv3x3_pool2_ref(a_u8, w_packed, cin: int, mul_prev, div_post,
                           bias, out_step: float) -> torch.Tensor:
    """Fused kernel's plain version: conv, requant, then the 2×2 max."""
    return maxpool2_codes(w1a8_conv3x3_ref(a_u8, w_packed, cin, mul_prev,
                                           div_post, bias, out_step))


def w1a8_conv3x3_popcount_ref(a_u8: torch.Tensor, w_packed: torch.Tensor,
                              cin: int, div_post: torch.Tensor,
                              bias: torch.Tensor,
                              out_step: Optional[float] = None
                              ) -> torch.Tensor:
    """Binary-domain conv on codes already on one grid (the consumer-side
    fold is the caller's): the im2col of SAME-padded codes, K-pad lanes as
    zero codes, exact int32 `xnor_accumulate`, then the f32 epilogue.
    a_u8 (B,H,W,Cin) → (B,H,W,Cout) f32, or uint8 codes."""
    b, h, w, _ = a_u8.shape
    k9p = packing.packed_dim(9 * cin) * packing.PACK
    cols = im2col_3x3(a_u8)
    cols = F.pad(cols, (0, k9p - cols.shape[-1]))       # K-pad lanes: 0
    acc = xnor_accumulate(cols.reshape(b * h * w, k9p), w_packed)
    y = popcount_epilogue(acc, div_post, bias, out_step)
    return y.reshape(b, h, w, -1)


def w1a8_conv3x3_pool2_popcount_ref(a_u8, w_packed, cin: int, div_post,
                                    bias, out_step: float) -> torch.Tensor:
    """Fused popcount kernel's plain version: conv, requant, 2×2 max."""
    return maxpool2_codes(w1a8_conv3x3_popcount_ref(
        a_u8, w_packed, cin, div_post, bias, out_step))
