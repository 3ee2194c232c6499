"""1-bit weight packing (paper §4's COE/BRAM ROM flow).

Bit j of word k along the packed axis holds the sign of weight index
``32*k + j`` (1 ⇒ +1, 0 ⇒ −1, sign(0) = +1). Pad bits are +1, so a kernel
pads the matching activation lanes (or their scales) with zeros and the
padding contributes nothing.

Words are held as ``int32`` with the bits of the reference's ``uint32``:
PyTorch has no shifts on ``uint32``. The CUDA kernels read them as
``uint32_t``.
"""
from __future__ import annotations

import torch

PACK = 32  # signs per 32-bit word


def packed_dim(k: int) -> int:
    return (k + PACK - 1) // PACK


def _shifts(ndim: int, axis: int, device) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = PACK
    return torch.arange(PACK, dtype=torch.int64, device=device).reshape(shape)


def pack_signs(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack the sign bits of ``w`` along ``axis`` into int32 words."""
    w = torch.movedim(w, axis, 0)
    k = w.shape[0]
    kp = packed_dim(k) * PACK
    bits = (w >= 0).to(torch.int64)
    if kp != k:
        pad = torch.ones((kp - k,) + tuple(w.shape[1:]), dtype=torch.int64,
                         device=w.device)
        bits = torch.cat([bits, pad], dim=0)
    bits = bits.reshape((kp // PACK, PACK) + tuple(bits.shape[1:]))
    words = torch.sum(bits << _shifts(bits.ndim, 1, w.device), dim=1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return torch.movedim(words.to(torch.int32), 0, axis)


def unpack_signs(words: torch.Tensor, k: int, axis: int = 0,
                 dtype=torch.int8) -> torch.Tensor:
    """Inverse of `pack_signs`: words → ±1 values (length k along axis)."""
    words = torch.movedim(words, axis, 0).to(torch.int64) & 0xFFFFFFFF
    bits = (words.unsqueeze(1) >> _shifts(words.ndim + 1, 1, words.device)) & 1
    flat = bits.reshape((-1,) + tuple(words.shape[1:]))[:k]
    return torch.movedim((flat * 2 - 1).to(dtype), 0, axis)
