"""Q-format fixed-point conversion (paper §4, Table 3).

Conv1 weights Q5.11 / biases Q2.14; Conv11 weights Q1.15 / biases Q4.12.
A Qm.n value occupies (1 sign + m integer + n fraction) bits and is carried
as an int32 raw integer; `to_float` divides by 2^n. The input is Q0.8 pixel
codes and the head emits signed Q*.15. Counterpart of
``repro/core/fixedpoint.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import round_half_away


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Two's-complement Qm.n: 1 sign bit, `int_bits` integer, `frac_bits` frac."""
    int_bits: int
    frac_bits: int
    signed: bool = True

    @property
    def total_bits(self) -> int:
        return (1 if self.signed else 0) + self.int_bits + self.frac_bits

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def raw_min(self) -> int:
        return -(1 << (self.int_bits + self.frac_bits)) if self.signed else 0

    @property
    def raw_max(self) -> int:
        return (1 << (self.int_bits + self.frac_bits)) - 1

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """float → int32 raw value, saturating (matches RTL saturation)."""
        dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
        raw = round_half_away(x.to(dtype) * self.scale)
        return torch.clamp(raw, self.raw_min, self.raw_max).to(torch.int32)

    def to_float(self, raw: torch.Tensor) -> torch.Tensor:
        return raw.to(torch.float32) / self.scale

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """Quantization the RTL would apply, back in float (max err 2^-n-1)."""
        return self.to_float(self.quantize(x))

    def __str__(self) -> str:  # "Q5.11" / "UQ0.8"
        return f"{'Q' if self.signed else 'UQ'}{self.int_bits}.{self.frac_bits}"


CONV1_W = QFormat(5, 11)          # Q5.11
CONV1_B = QFormat(2, 14)          # Q2.14
CONV11_W = QFormat(1, 15)         # Q1.15
CONV11_B = QFormat(4, 12)         # Q4.12
INPUT_Q = QFormat(0, 8, signed=False)   # RGB in Q0.8 ([0,255]/256)
HEAD_OUT = QFormat(16, 15)        # signed int32 with 15 fractional bits
SCALE_Q = QFormat(0, 16, signed=False)  # per-channel Mul/Div fixed point


def fixed_mul_rshift(x, mul_raw, frac_bits: int) -> torch.Tensor:
    """Integer multiply + rounding right-shift, round_half_away(x·m / 2^f),
    in int64: sign(p)·((|p| + half) >> f) with p = x·m and half = 2^(f−1)
    (0 at f = 0), the RTL's symmetric rounder. Exact wherever p fits int64,
    also past 2^53 where float64 is not."""
    prod = (torch.as_tensor(x, dtype=torch.int64)
            * torch.as_tensor(mul_raw, dtype=torch.int64))
    half = (1 << (frac_bits - 1)) if frac_bits > 0 else 0
    return torch.sign(prod) * ((torch.abs(prod) + half) >> frac_bits)
