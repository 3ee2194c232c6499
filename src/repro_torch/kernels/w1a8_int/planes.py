"""Signed digit planes of the integer PE's constant matrix W'.

At a layer the integer PE forms acc[n] = Σ_k a_k·W'[k, n] in int64 with
wrapping sums, a_k a uint8 code and W' a constant of the artifact: W' =
m[c(k)]·s[k, n] at a W1A8 layer, w_raw at conv1, m[c]·w_raw[c, n] at the
head. Written in signed digits that fit s8,

    W' ≡ Σ_j 128^j · d_j  (mod 2^64),  |d_j| ≤ 127,

the sum becomes acc = Σ_j 128^j · (A·D_j): each A·D_j is a u8·s8 product
with an exact int32 sum (|A·D_j| ≤ 255·127·K < 2^31 for K ≤ `K_MAX`), and
the planes combine in int64 with wrapping shifts and adds, which is exact
modulo 2^64: bit for bit the reference's wrapped int64 sum.

The encoding is sign-magnitude in radix 128: d_j = sign(w) ·
(digit j of |w|), |w| taken as an unsigned 64-bit magnitude, so INT64_MIN
(magnitude 2^63 = 128^9) is d_9 = −1 and every int64 has at most
`MAX_PLANES` digits. It is closed under negation, so a W1A8 layer's plane
is the per-channel digit of m_raw times the sign bit, formed in registers
(balanced radix 256 would need the digit −128, whose negation is no s8).

`sign_planes` and `dense_planes` lay the digits out as the kernel reads
them; `plane_sums` and `emulate` repeat the kernel's arithmetic in torch
for the tests.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.w1a8_int import ref as _ref

RADIX_BITS = 7
DIGIT_MAX = (1 << RADIX_BITS) - 1    # 127: −d fits s8 for every digit
MAX_PLANES = 10                      # 128^10 > 2^64
CODE_MAX = 255
SUM_LIMIT = 1 << 31                  # a plane's int32 sum stays below it
UNIT = 16                            # channels of one kernel unit
K_MAX = (SUM_LIMIT - 1) // (CODE_MAX * DIGIT_MAX)   # 66311


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's >> is
    arithmetic)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def plane_count(w: torch.Tensor) -> int:
    """The fewest radix-128 digits that hold every |w| (at least 1): one
    host read."""
    mag = torch.abs(w.to(torch.int64))
    if bool((mag < 0).any()):            # INT64_MIN: magnitude 2^63
        return MAX_PLANES
    top = int(mag.max()) if mag.numel() else 0
    return max(1, -(-top.bit_length() // RADIX_BITS))


def digit_planes(w: torch.Tensor) -> torch.Tensor:
    """The signed digits of int64 ``w``, (P, *w.shape) int8 with P =
    `plane_count`, and Σ_j d_j << 7j ≡ w (mod 2^64)."""
    w = w.to(torch.int64)
    mag = torch.abs(w)                   # wraps at INT64_MIN, as wanted
    sign = torch.where(w < 0, -1, 1)
    return torch.stack([(sign * (_lshr(mag, RADIX_BITS * j) & DIGIT_MAX))
                        .to(torch.int8) for j in range(plane_count(w))])


def combine(sums: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ_j int64(sums[j]) << 7j with wrapping int64 adds and shifts: the
    kernel's combine of its per-plane int32 sums."""
    total = None
    for j, s in enumerate(sums):
        term = s.to(torch.int64) << (RADIX_BITS * j)
        total = term if total is None else total + term
    return total


def check_k(k: int) -> None:
    """Refuses a K at which a plane's sum, 255·127·K, could reach 2^31."""
    if k > K_MAX:
        raise ValueError(f"K = {k}: a plane's int32 sum could reach 2^31 "
                         f"(K ≤ {K_MAX})")


def w1a8_weights(m_raw: torch.Tensor, signs: torch.Tensor,
                 ksize: int) -> torch.Tensor:
    """W' of a W1A8 layer, (K, N) int64: m[c(k)]·s[k, n] (wrapping), K in
    (dy, dx, cin) order."""
    m = m_raw.to(torch.int64).reshape(-1).repeat(ksize * ksize)
    return m[:, None] * signs.to(torch.int64)


def head_weights(m_raw: torch.Tensor, w_raw: torch.Tensor) -> torch.Tensor:
    """W' of the head, (Cin, N) int64: m[c]·w_raw[c, n] (wrapping)."""
    return m_raw.to(torch.int64).reshape(-1, 1) * w_raw.to(torch.int64)


def sign_planes(m_raw: torch.Tensor) -> torch.Tensor:
    """A W1A8 layer's planes as the kernel reads them: the digits of m_raw
    per input channel, (P, ⌈Cin/16⌉·16) int8, zero past Cin; the kernel
    multiplies them by the sign bits in registers."""
    m = m_raw.to(torch.int64).reshape(-1)
    d = digit_planes(m)
    pad = -m.numel() % UNIT
    return torch.nn.functional.pad(d, (0, pad)).contiguous()


def dense_planes(w: torch.Tensor, cin: int, ksize: int) -> torch.Tensor:
    """conv1's and the head's planes as the kernel reads them: the digits
    of W' (ksize²·Cin, N) int64 in units of 16 channels of one tap,
    (P, ksize²·⌈Cin/16⌉, N, 16) int8, zero past Cin."""
    taps, n = ksize * ksize, w.shape[1]
    d = digit_planes(w).reshape(-1, taps, cin, n)
    pad = -cin % UNIT
    d = torch.nn.functional.pad(d, (0, 0, 0, pad))    # (P, taps, cpad, N)
    p = d.shape[0]
    d = d.reshape(p, taps, (cin + pad) // UNIT, UNIT, n)
    return d.permute(0, 1, 2, 4, 3).reshape(p, -1, n, UNIT).contiguous()


def plane_sums(x_u8: torch.Tensor, digits: torch.Tensor,
               ksize: int) -> list:
    """The kernel's per-plane sums Σ_k a_k·d_j[k, n] as int32, (B, H, W, N)
    each, for digits (P, ksize²·Cin, N); raises if one leaves int32."""
    sums = []
    for d in digits:
        s = _ref.accumulate(x_u8, None, d.to(torch.int64), ksize)
        if s.numel() and int(s.abs().max()) >= SUM_LIMIT:
            raise AssertionError("a plane's sum left int32")
        sums.append(s.to(torch.int32))
    return sums


def emulate(x_u8: torch.Tensor, w_eff: torch.Tensor,
            ksize: int) -> torch.Tensor:
    """Σ_k a_k·W'[k, n] as the kernel forms it: the planes' int32 sums,
    combined in wrapping int64. (B, H, W, N) int64."""
    check_k(w_eff.shape[0])
    return combine(plane_sums(x_u8, digit_planes(w_eff), ksize))
