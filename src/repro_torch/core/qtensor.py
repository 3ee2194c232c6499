"""QTensor — codes plus scale, the one quantized-tensor wire of the dataflow.

Counterpart of ``repro/core/qtensor.py`` with the two qtypes the detection
path carries:

  ``u8``   uint8 activation codes, value = data · scale, scale per-tensor or
           per-channel along ``axis`` (the LSQ step; ``core.quant``).
  ``f32``  unquantized payload, scale ≡ 1.

The ``s8`` and ``b1`` wires belong to the distribution layer and are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import ACT_QMAX, round_half_away

_QTYPES = ("u8", "f32")


def _as_f32(step, device) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class QTensor:
    data: torch.Tensor
    scale: torch.Tensor
    qtype: str = "u8"
    axis: Optional[int] = None      # channel axis of a per-channel scale

    def __post_init__(self):
        if self.qtype not in _QTYPES:
            raise ValueError(f"unknown qtype {self.qtype!r}")

    @classmethod
    def quantize_u8(cls, x: torch.Tensor, step,
                    axis: Optional[int] = None) -> "QTensor":
        """clip(round(x/s), 0, 255) uint8 codes (Eq. 3-3 discipline)."""
        step = _as_f32(step, x.device)
        codes = torch.clamp(round_half_away(x / step), 0,
                            ACT_QMAX).to(torch.uint8)
        return cls(codes, step, "u8", axis=axis)

    @classmethod
    def from_codes(cls, codes: torch.Tensor, step,
                   axis: Optional[int] = None) -> "QTensor":
        """Wrap already-quantized uint8 codes with their step."""
        return cls(codes, _as_f32(step, codes.device), "u8", axis=axis)

    @classmethod
    def from_f32(cls, x: torch.Tensor) -> "QTensor":
        return cls(x, torch.ones((), dtype=torch.float32, device=x.device),
                   "f32")

    def dequantize(self) -> torch.Tensor:
        """Back to f32 values (codes · scale)."""
        return self.data.to(torch.float32) * self.scale
