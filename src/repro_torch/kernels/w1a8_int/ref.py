"""Plain PyTorch versions of the integer PE (``csrc/w1a8_int_pe.cu``).

One layer of the integer golden datapath, in torch int64, as the
reference's numpy ``yolo_forward_int`` computes it:

  W1A8   q = clip(rshift_round(Σ_k a_k·m[c(k)]·s[k, n] · mult[n] + b_pre[n],
                               shift[n]), 0, 255)
  conv1  q = clip(rshift_round(max(Σ_k a_k·w[k, n] + bias[n], 0) · mult[n],
                               shift[n]), 0, 255),   bias = b_raw << 5
  head   raw = rshift_round(Σ_k a_k·m[c(k)]·w[k, n], shift) + bias[n],
                                                      bias = b_raw << 3

with K in (dy, dx, cin) order (`im2col`) and an optional 2×2 max of the
codes. CUDA has no int64 matmul, so the sum is taken as broadcast products
summed over blocks of K: the same function runs on the CPU and on the card.
Integer sums wrap as numpy's do, so the order of summation does not matter.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.quant import ACT_QMAX
from repro_torch.kernels.w1a8_conv.ref import maxpool2_codes

# elements of one block's broadcast product (M, kb, N)
_BLOCK_ELEMS = 1 << 24


def rshift_round(x: torch.Tensor, shift) -> torch.Tensor:
    """Per-element rounding right shift, half away from zero (the RTL's
    rounder): sign(x)·((|x| + half) >> shift), half = 2^(shift−1) and 0 at
    shift 0. An arithmetic shift alone floors negative values."""
    shift = torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    half = torch.where(shift > 0,
                       torch.ones_like(shift) << torch.clamp(shift - 1, min=0),
                       torch.zeros_like(shift))
    return torch.sign(x) * ((torch.abs(x) + half) >> shift)


def im2col(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, k·k·C) in (dy, dx, c) order, SAME zero
    padding for k = 3; k = 1 is the input itself."""
    if k == 1:
        return x
    h, w = x.shape[1], x.shape[2]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w, :]
                      for dy in range(3) for dx in range(3)], dim=-1)


def accumulate(x_u8: torch.Tensor, m: Optional[torch.Tensor],
               w: torch.Tensor, ksize: int) -> torch.Tensor:
    """Σ_k a_k·m[c(k)]·w[k, n] in int64: x_u8 (B, H, W, Cin) codes, m (Cin,)
    or None (1), w (ksize²·Cin, N) int64. Returns (B, H, W, N) int64."""
    cols = im2col(x_u8.to(torch.int64), ksize)
    if m is not None:
        cols = cols * m.to(torch.int64).repeat(ksize * ksize)
    b, h, wd, k = cols.shape
    w = w.to(cols.device, torch.int64)
    n = w.shape[1]
    cols = cols.reshape(-1, k)
    acc = torch.zeros((cols.shape[0], n), dtype=torch.int64,
                      device=cols.device)
    kb = max(1, min(k, _BLOCK_ELEMS // max(1, cols.shape[0] * n)))
    for k0 in range(0, k, kb):
        acc += (cols[:, k0:k0 + kb, None] * w[None, k0:k0 + kb]).sum(dim=1)
    return acc.reshape(b, h, wd, n)


def requant(p: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """clip(rshift_round(p, shift), 0, 255) as uint8 codes."""
    return torch.clamp(rshift_round(p, shift), 0, ACT_QMAX).to(torch.uint8)


def w1a8_int_pe_ref(x_u8, w_packed, m_raw, post_mult, b_pre, post_shift, *,
                    ksize: int, pool: bool) -> torch.Tensor:
    """W1A8 layer: x_u8 (B, H, W, Cin) codes; w_packed (ceil(K/32), N) int32
    sign words, K = ksize²·Cin; m_raw (Cin,), post_mult, b_pre, post_shift
    (N,) int64. Returns uint8 codes (B, H, W, N), or pooled."""
    k = ksize * ksize * x_u8.shape[-1]
    signs = packing.unpack_signs(w_packed, k, axis=0, dtype=torch.int64)
    acc = accumulate(x_u8, m_raw, signs, ksize)
    q = requant(acc * post_mult + b_pre, post_shift)
    return maxpool2_codes(q) if pool else q


def int_pe_conv1_ref(x_u8, w_raw, b_shifted, post_mult, post_shift, *,
                     pool: bool = True) -> torch.Tensor:
    """conv1, 3×3: x_u8 (B, H, W, Cin) pixel codes; w_raw (9·Cin, N) Q5.11
    int64; b_shifted = b_raw << 5, post_mult, post_shift (N,) int64.
    Returns uint8 codes, or pooled."""
    acc = accumulate(x_u8, None, w_raw, 3) + b_shifted
    q = requant(torch.clamp(acc, min=0) * post_mult, post_shift)
    return maxpool2_codes(q) if pool else q


def int_pe_head_ref(x_u8, w_raw, m_raw, b_shifted,
                    shift: int) -> torch.Tensor:
    """The head, 1×1: x_u8 (B, H, W, Cin) codes; w_raw (Cin, N) Q1.15
    int64; m_raw (Cin,); b_shifted = b_raw << 3 (N,). Returns the (B, H, W,
    N) int64 raw head at Q*.15."""
    return rshift_round(accumulate(x_u8, m_raw, w_raw, 1), shift) + b_shifted
