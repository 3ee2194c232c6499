"""Public wrappers for the integer PE, ``csrc/w1a8_int_pe.cu``.

Three layer kinds of the integer golden datapath share the kernel's one
entry point and one launch count: `w1a8_int_pe` (the sign PE with Mul_prev
fused into the accumulation, conv2–conv10, 3×3 or 1×1), `int_pe_conv1`
(3×3 dense Q5.11 weights on the pixel codes) and `int_pe_head` (conv11's
1×1 dense Q1.15 weights, the int64 raw head). A CUDA tensor launches the
kernel (or raises); a CPU tensor runs the plain version in ``ref.py``; a
fake or meta tensor gives the result's shape alone. Each
launch computes one layer with its epilogue and, where asked, the 2×2 max,
and writes the next layer's uint8 codes (the head: int64).

The kernel reads the layer's constant W' as signed digit planes
(``planes.py``): ``planes=`` passes the ones `models.yolo.fold_int_pe`
built at deploy; without it a CUDA call builds them, at a host read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.packing import packed_dim
from repro_torch.kernels import _build
from repro_torch.kernels.w1a8_int import planes as _planes
from repro_torch.kernels.w1a8_int import ref as _ref
from repro_torch.kernels.w1a8_int.geometry import (CONV1, HEAD, W1A8,
                                                   pe_launch)

SHIFT_MAX = 62   # the largest shift the kernel takes: 2^(s−1) fits int64

# (kind, ksize, pool, x, wbits, planes, n_planes, mult, bias, shift,
# shift_all, shift_lo, shift_hi, out, b, h, w, cin, cout, grid_x, grid_y,
# rows, bn, wm, wn, row_px, threads, smem, stream)
KERNEL = _build.Kernel("w1a8_int_pe.cu", "w1a8_int_pe",
                       [_build.I] * 3 + [_build.P] * 3 + [_build.I]
                       + [_build.P] * 3 + [_build.I] * 3 + [_build.P]
                       + [_build.I] * 14 + [_build.P])


def shift_range(shift) -> Tuple[int, int]:
    """(min, max) of the shifts, one host read; raises outside [0, 62]."""
    if isinstance(shift, int):
        lo = hi = shift
    else:
        lo, hi = (int(v) for v in torch.aminmax(shift.reshape(-1)))
    if lo < 0 or hi > SHIFT_MAX:
        raise ValueError(f"shifts must lie in [0, {SHIFT_MAX}], got "
                         f"[{lo}, {hi}]")
    return lo, hi


def w1a8_int_pe(x_u8: torch.Tensor, w_packed: torch.Tensor,
                m_raw: torch.Tensor, post_mult: torch.Tensor,
                b_pre: torch.Tensor, post_shift: torch.Tensor, *,
                ksize: int, pool: bool,
                shifts: Optional[Tuple[int, int]] = None,
                planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A W1A8 layer: x_u8 (B, H, W, Cin) codes; w_packed (ceil(K/32), N)
    int32 sign words in (dy, dx, cin) order, K = ksize²·Cin; m_raw (Cin,),
    post_mult, b_pre, post_shift (N,) int64. Returns (B, H, W, N) uint8
    codes, or (B, H/2, W/2, N) with ``pool``. ``shifts`` is post_shift's
    (min, max) where the caller knows it (`shift_range`); else it is read.
    ``planes``: m_raw's digit planes (`planes.sign_planes`)."""
    k = ksize * ksize * x_u8.shape[-1]
    if w_packed.dtype != torch.int32 or w_packed.shape[0] != packed_dim(k):
        raise ValueError(f"w_packed must be int32 ({packed_dim(k)}, N), got "
                         f"{w_packed.dtype} {tuple(w_packed.shape)}")
    n = w_packed.shape[1]
    with _build.work("w1a8_int_pe", _flops(x_u8, k, n), "int8",
                     _build.nbytes(x_u8, w_packed, m_raw, post_mult, b_pre,
                                   post_shift)) as out:
        if _build.shape_only(x_u8):
            y = _result(W1A8, x_u8, n, pool)
        elif x_u8.is_cuda:
            if planes is None:
                planes = _planes.sign_planes(m_raw)
            y = _launch(W1A8, x_u8, w_packed, planes, post_mult, b_pre,
                        post_shift, shifts, ksize, pool, n)
        else:
            shift_range(post_shift)
            y = _ref.w1a8_int_pe_ref(x_u8, w_packed, m_raw, post_mult, b_pre,
                                     post_shift, ksize=ksize, pool=pool)
        out.append(y)
    return y


def int_pe_conv1(x_u8: torch.Tensor, w_raw: torch.Tensor,
                 b_shifted: torch.Tensor, post_mult: torch.Tensor,
                 post_shift: torch.Tensor, *, pool: bool = True,
                 shifts: Optional[Tuple[int, int]] = None,
                 planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv1, 3×3: x_u8 (B, H, W, Cin) pixel codes; w_raw (9·Cin, N) Q5.11
    int64; b_shifted = b_raw << 5, post_mult, post_shift (N,) int64.
    Returns uint8 codes, pooled with ``pool``. ``planes``: w_raw's digit
    planes (`planes.dense_planes`)."""
    _check_dense(x_u8, w_raw, 3)
    k, n = w_raw.shape
    with _build.work("int_pe_conv1", _flops(x_u8, k, n), "int8",
                     _build.nbytes(x_u8, w_raw, b_shifted, post_mult,
                                   post_shift)) as out:
        if _build.shape_only(x_u8):
            y = _result(CONV1, x_u8, n, pool)
        elif x_u8.is_cuda:
            if planes is None:
                planes = _planes.dense_planes(w_raw, x_u8.shape[-1], 3)
            y = _launch(CONV1, x_u8, None, planes, post_mult, b_shifted,
                        post_shift, shifts, 3, pool, n)
        else:
            shift_range(post_shift)
            y = _ref.int_pe_conv1_ref(x_u8, w_raw, b_shifted, post_mult,
                                      post_shift, pool=pool)
        out.append(y)
    return y


def int_pe_head(x_u8: torch.Tensor, w_raw: torch.Tensor, m_raw: torch.Tensor,
                b_shifted: torch.Tensor, shift: int,
                planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The head, 1×1: x_u8 (B, H, W, Cin) codes; w_raw (Cin, N) Q1.15
    int64; m_raw (Cin,); b_shifted = b_raw << 3 (N,) int64; one shift for
    every channel. Returns the (B, H, W, N) int64 raw head. ``planes``:
    the digit planes of m[c]·w_raw[c, n] (`planes.dense_planes` of
    `planes.head_weights`)."""
    _check_dense(x_u8, w_raw, 1)
    shift_range(shift)
    k, n = w_raw.shape
    with _build.work("int_pe_head", _flops(x_u8, k, n), "int8",
                     _build.nbytes(x_u8, w_raw, m_raw, b_shifted)) as out:
        if _build.shape_only(x_u8):
            y = _result(HEAD, x_u8, n, False)
        elif x_u8.is_cuda:
            if planes is None:
                planes = _planes.dense_planes(
                    _planes.head_weights(m_raw.to(w_raw.device), w_raw),
                    x_u8.shape[-1], 1)
            y = _launch(HEAD, x_u8, None, planes, None, b_shifted,
                        int(shift), None, 1, False, n)
        else:
            y = _ref.int_pe_head_ref(x_u8, w_raw, m_raw, b_shifted, shift)
        out.append(y)
    return y


def _flops(x_u8: torch.Tensor, k: int, n: int) -> int:
    """2·M·N·K of a layer over x_u8's B·H·W pixels."""
    b, h, wd = x_u8.shape[:3]
    return 2 * b * h * wd * n * k


def _result(kind: int, x_u8: torch.Tensor, n: int,
            pool: bool) -> torch.Tensor:
    """An empty result: (B, H, W, N), or (B, H/2, W/2, N) with ``pool``;
    int64 for the head, else uint8 codes."""
    b, h, wd = x_u8.shape[:3]
    shape = (b, h // 2, wd // 2, n) if pool else (b, h, wd, n)
    return torch.empty(shape, device=x_u8.device,
                       dtype=torch.int64 if kind == HEAD else torch.uint8)


def _check_dense(x_u8: torch.Tensor, w_raw: torch.Tensor, ksize: int) -> None:
    k = ksize * ksize * x_u8.shape[-1]
    if w_raw.dtype != torch.int64 or w_raw.dim() != 2 or w_raw.shape[0] != k:
        raise ValueError(f"w_raw must be int64 ({k}, N), got {w_raw.dtype} "
                         f"{tuple(w_raw.shape)}")


def _launch(kind: int, x_u8, wbits, planes, mult, bias, shift, shifts,
            ksize: int, pool: bool, n: int) -> torch.Tensor:
    if x_u8.dtype != torch.uint8 or x_u8.dim() != 4:
        raise TypeError(f"x_u8 must be (B, H, W, Cin) uint8, got "
                        f"{x_u8.dtype} {tuple(x_u8.shape)}")
    if ksize not in (1, 3):
        raise ValueError(f"ksize must be 1 or 3, got {ksize}")
    b, h, wd, cin = x_u8.shape
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"a 2x2 pool needs an even plane, got {h}x{wd}")
    _planes.check_k(ksize * ksize * cin)
    dev = x_u8.device
    cu = -(-cin // _planes.UNIT)          # 16-channel units of a pixel
    want = ((cu * _planes.UNIT,) if kind == W1A8
            else (ksize * ksize * cu, n, _planes.UNIT))
    if (planes.dtype != torch.int8 or planes.dim() != len(want) + 1
            or tuple(planes.shape[1:]) != want
            or not 1 <= planes.shape[0] <= _planes.MAX_PLANES):
        raise ValueError(f"planes must be int8 (P, {', '.join(map(str, want))})"
                         f" with 1 ≤ P ≤ {_planes.MAX_PLANES}, got "
                         f"{planes.dtype} {tuple(planes.shape)}")

    def vec(t, size):
        t = t.to(dev, torch.int64).reshape(-1).contiguous()
        if t.numel() != size:
            raise ValueError(f"a per-channel operand holds {t.numel()} "
                             f"values, want {size}")
        return t
    per_channel = isinstance(shift, torch.Tensor)
    lo, hi = shifts if shifts is not None else shift_range(shift)
    if lo < 0 or hi > SHIFT_MAX:
        raise ValueError(f"shifts must lie in [0, {SHIFT_MAX}], got "
                         f"[{lo}, {hi}]")
    x = x_u8.contiguous()
    wbits = None if wbits is None else wbits.to(dev).contiguous()
    planes = planes.to(dev).contiguous()
    mult = None if mult is None else vec(mult, n)
    bias = vec(bias, n)
    shift_t = vec(shift, n) if per_channel else None
    g = pe_launch(kind, b, h, wd, cin, n, ksize, pool, planes.shape[0])
    out = _result(kind, x, n, pool)

    def ptr(t):
        return None if t is None else t.data_ptr()
    KERNEL(kind, ksize, int(pool), x.data_ptr(), ptr(wbits),
           planes.data_ptr(), planes.shape[0], ptr(mult), bias.data_ptr(),
           ptr(shift_t), 0 if per_channel else int(shift), lo, hi,
           out.data_ptr(), b, h, wd, cin, n, *g.grid[:2], g.rows, g.bn,
           g.wm, g.wn, g.row_px, g.threads, g.smem,
           torch.cuda.current_stream(dev).cuda_stream)
    return out
