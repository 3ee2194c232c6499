"""QTensor — codes plus scale, the one quantized-tensor wire of the dataflow.

Counterpart of ``repro/core/qtensor.py``, with its four qtypes:

  ``u8``   uint8 activation codes, value = data · scale, scale per-tensor or
           per-channel along ``axis`` (the LSQ step; ``core.quant``).
  ``s8``   symmetric int8 codes in [−127, 127], value = data · scale with a
           per-tensor scale = abs-max/127 (the distribution layer's wire).
  ``b1``   1-bit sign words (32 signs a word along ``axis``; int32 words
           with the bits of the reference's uint32, ``core.packing``),
           value = unpack(data) · scale (α). ``kdim`` holds the unpadded
           length of the packed axis.
  ``f32``  unquantized payload, scale ≡ 1.

Two roundings follow the reference as it runs on its wires, inside a jitted
``shard_map``: XLA turns a division by a constant into a product with the
constant's float32 reciprocal, so the s8 scale is abs-max · f32(1/127), not
abs-max / 127 (an ulp apart on some 5% of tensors); and ``jnp.mean`` is a
sum times f32(1/n). The sum of a mean is taken in float64 and rounded once:
the reference's float32 sum follows XLA's vectorised order, which no other
program reproduces, where a float64 sum rounds to the same float32 on the
card and on the CPU. Codes divide by the scale tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.quant import ACT_QMAX, round_half_away

S8_QMAX = 127  # symmetric int8 code range [-127, 127] (the wire format)
SCALE_FLOOR = 1e-20  # the s8 scale's and b1 α's clamp, as the reference's

_QTYPES = ("u8", "s8", "b1", "f32")


def _as_f32(step, device) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32, device=device)


def times_reciprocal(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x / c`` as the reference's compiled program forms it: x times the
    float32 reciprocal of the constant."""
    inv = np.float32(1) / np.float32(c)
    return x * torch.tensor(inv, dtype=torch.float32, device=x.device)


def mean_abs(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """mean|x| in float32, over everything or along ``dim`` (kept): the sum
    in float64 rounded once, times f32(1/n)."""
    a = torch.abs(x.to(torch.float32))
    if dim is None:
        total, n = torch.sum(a, dtype=torch.float64), a.numel()
    else:
        total = torch.sum(a, dim=dim, keepdim=True, dtype=torch.float64)
        n = a.shape[dim]
    return times_reciprocal(total.to(torch.float32), max(n, 1))


def s8_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round_half_away(x / scale), −127, 127) as int8."""
    return torch.clamp(round_half_away(x / scale), -S8_QMAX,
                       S8_QMAX).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class QTensor:
    data: torch.Tensor
    scale: torch.Tensor
    qtype: str = "u8"
    axis: Optional[int] = None      # channel axis of a per-channel scale
    kdim: Optional[int] = None      # b1: unpadded length of the packed axis

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
    def quantize_s8(cls, x: torch.Tensor,
                    scale: Optional[torch.Tensor] = None) -> "QTensor":
        """Symmetric int8 with per-tensor scale = abs-max/127 (the wire).

        An explicit ``scale`` (a shared one, all-reduced) overrides the
        local abs-max so codes from different ranks stay summable."""
        x = x.to(torch.float32)
        if scale is None:
            amax = torch.amax(torch.abs(x))
            scale = times_reciprocal(torch.clamp(amax, min=SCALE_FLOOR),
                                     S8_QMAX)
        scale = _as_f32(scale, x.device)
        return cls(s8_codes(x, scale), scale, "s8")

    @classmethod
    def pack_b1(cls, w: torch.Tensor, alpha: Optional[torch.Tensor] = None,
                axis: int = 0) -> "QTensor":
        """Pack sign bits along the reduction ``axis`` (Eq. 3-1 + §4 COE);
        α = mean|w| along it unless given."""
        if alpha is None:
            alpha = mean_abs(w, axis).squeeze(axis)
        return cls(packing.pack_signs(w, axis=axis),
                   _as_f32(alpha, w.device), "b1", axis=axis,
                   kdim=int(w.shape[axis]))

    @classmethod
    def quantize_b1(cls, x: torch.Tensor, axis: int = -1,
                    per_slice: bool = False) -> "QTensor":
        """Sign-binarize ``x`` to packed words along ``axis``, α = mean|x|
        (per tensor, or with ``per_slice`` one α per slice along ``axis``,
        kept as a broadcastable dim), clamped to 1e-20 as the s8 scale is:
        an all-zero tensor or row would otherwise carry α = 0."""
        ax = axis if axis >= 0 else x.dim() + axis
        alpha = mean_abs(x, ax if per_slice else None)
        alpha = torch.clamp(alpha, min=SCALE_FLOOR)
        return cls(packing.pack_signs(x, axis=ax), alpha, "b1", axis=ax,
                   kdim=int(x.shape[ax]))

    @classmethod
    def from_f32(cls, x: torch.Tensor) -> "QTensor":
        return cls(x, torch.ones((), dtype=torch.float32, device=x.device),
                   "f32")

    def dequantize(self) -> torch.Tensor:
        """Back to f32 values (codes · scale; b1 unpacks to ±1 · α)."""
        if self.qtype == "b1":
            signs = packing.unpack_signs(self.data, self.kdim,
                                         axis=self.axis, dtype=torch.float32)
            return signs * self.scale
        return self.data.to(torch.float32) * self.scale

    @property
    def per_tensor(self) -> bool:
        return self.scale.dim() == 0 or self.scale.numel() == 1

    def scale_scalar(self) -> torch.Tensor:
        """The per-tensor scale (contract of the popcount/exact paths)."""
        return self.scale.reshape(-1)[0]

    def wire_bytes(self) -> int:
        """Payload + scale bytes this tensor costs on a wire (vs f32)."""
        return int(self.data.numel() * self.data.element_size()
                   + self.scale.numel() * 4)
