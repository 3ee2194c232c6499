"""Fused W1A8 conv3x3 + requant + 2×2 MaxPool (the paper's §5.2
Post+MaxPool stage chain) as one CUDA kernel per accum mode:
``csrc/w1a8_conv3x3_pool2.cu`` (dot) and
``csrc/w1a8_conv3x3_pool2_popcount.cu`` (popcount).

Only the pooled uint8 codes leave the kernel: activation traffic for a pool
layer drops from (write HW + read HW + write HW/4) to (write HW/4). A CPU
tensor runs the plain version (conv, requant, 2×2 max); a fake or meta
tensor gives the result's shape alone (`_build.shape_only`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w1a8_conv import ref as _ref
from repro_torch.kernels.w1a8_conv.geometry import conv_launch

KERNEL = _build.Kernel(
    "w1a8_conv3x3_pool2.cu", "w1a8_conv3x3_pool2",
    [_build.P] * 6 + [_build.I] * 6 + [_build.F] + [_build.I] * 8
    + [_build.P])
POPCOUNT_KERNEL = _build.Kernel(
    "w1a8_conv3x3_pool2_popcount.cu", "w1a8_conv3x3_pool2_popcount",
    [_build.P] * 5 + [_build.I] * 6 + [_build.F] + [_build.I] * 8
    + [_build.P])


def w1a8_conv3x3_pool2(a_u8: torch.Tensor, w_packed: torch.Tensor,
                       mul_prev: Optional[torch.Tensor],
                       div_post: torch.Tensor, bias: torch.Tensor, *,
                       cin: int, out_step: float, accum: str = "dot",
                       rows: int = 1) -> torch.Tensor:
    """a_u8 (B,H,W,Cin) uint8 (H, W even) → (B,H/2,W/2,Cout) uint8 codes.

    ``accum="popcount"`` contracts codes already on one grid, with the
    uniform step folded into ``div_post`` by the caller; ``mul_prev`` is
    then unused. ``rows`` pooled rows per block (the last block may hold
    fewer); the result does not depend on it.
    """
    b, h, wd, _ = a_u8.shape
    if accum not in ("dot", "popcount"):
        raise ValueError(f"accum must be 'dot' or 'popcount', got {accum!r}")
    if h % 2 or wd % 2:
        raise ValueError(f"H and W must be even, got {h}x{wd}")
    if rows < 1:
        raise ValueError(f"rows must be ≥ 1, got {rows}")
    popcount = accum == "popcount"
    if not popcount and mul_prev is None:
        raise ValueError("accum='dot' needs mul_prev")
    cout = w_packed.shape[1]
    with _build.work(
            "w1a8_conv3x3_pool2_popcount" if popcount
            else "w1a8_conv3x3_pool2",
            2 * b * h * wd * 9 * cin * cout, "int8" if popcount else "bf16",
            _build.nbytes(a_u8, w_packed, None if popcount else mul_prev,
                          div_post, bias)) as out:
        if _build.shape_only(a_u8):
            from repro_torch.kernels.w1a8_conv.ops import cuda_operands
            cuda_operands(a_u8, w_packed, None if popcount else mul_prev,
                          div_post, bias, cin)
            y = torch.empty((b, h // 2, wd // 2, cout), dtype=torch.uint8,
                            device=a_u8.device)
        elif a_u8.is_cuda:
            y = _launch(a_u8, w_packed, mul_prev, div_post, bias, cin,
                        out_step, accum, rows)
        elif popcount:
            y = _ref.w1a8_conv3x3_pool2_popcount_ref(
                a_u8, w_packed, cin, div_post, bias, out_step)
        else:
            y = _ref.w1a8_conv3x3_pool2_ref(a_u8, w_packed, cin, mul_prev,
                                            div_post, bias, out_step)
        out.append(y)
    return y


def _launch(a_u8, w_packed, mul_prev, div_post, bias, cin: int,
            out_step: float, accum: str, rows: int) -> torch.Tensor:
    from repro_torch.kernels.w1a8_conv.ops import cuda_operands
    popcount = accum == "popcount"
    b, h, wd, _ = a_u8.shape
    a, w, mul, div, bs = cuda_operands(a_u8, w_packed,
                                       None if popcount else mul_prev,
                                       div_post, bias, cin)
    cout = w.shape[1]
    out = torch.empty((b, h // 2, wd // 2, cout), dtype=torch.uint8,
                      device=a.device)
    g = conv_launch(b, h, wd, cin, cout, rows, pool=True, accum=accum)
    geometry = (b, h, wd, cin, cout, g.rows, float(out_step), *g.grid[:2],
                g.bn, g.wm, g.wn, g.row_px, g.threads, g.smem,
                torch.cuda.current_stream(a.device).cuda_stream)
    if popcount:
        POPCOUNT_KERNEL(a.data_ptr(), w.data_ptr(), div.data_ptr(),
                        bs.data_ptr(), out.data_ptr(), *geometry)
    else:
        KERNEL(a.data_ptr(), w.data_ptr(), mul.data_ptr(), div.data_ptr(),
               bs.data_ptr(), out.data_ptr(), *geometry)
    return out
