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

import os

import numpy as np
import torch

from repro_torch.device import resolve_device

PACK = 32  # signs per 32-bit word


def packed_dim(k: int) -> int:
    return (k + PACK - 1) // PACK


def _shifts(ndim: int, axis: int, device) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = PACK
    return torch.arange(PACK, dtype=torch.int64, device=device).reshape(shape)


def _bit(j: int) -> int:
    """The int32 value of bit j alone (bit 31 is the sign bit)."""
    return 1 << j if j < PACK - 1 else -(1 << (PACK - 1))


def pack_signs(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack the sign bits of ``w`` along ``axis`` into int32 words.

    Bit j of every word is set from the rows j, 32 + j, ... in one pass,
    so no temporary outgrows the words themselves: a stacked leaf of
    several GB packs on the card next to its f32 weights.
    """
    w = torch.movedim(w, axis, 0)
    k = w.shape[0]
    nw = packed_dim(k)
    words = torch.zeros((nw,) + tuple(w.shape[1:]), dtype=torch.int32,
                        device=w.device)
    for j in range(PACK):
        rows = w[j::PACK]                  # word i's bit j: row 32·i + j
        n = rows.shape[0]
        words[:n] |= (rows >= 0).to(torch.int32) * _bit(j)
        if n < nw:                         # pad bits are +1
            words[n:] |= _bit(j)
    return torch.movedim(words, 0, axis)


def unpack_signs(words: torch.Tensor, k: int, axis: int = 0,
                 dtype=torch.int8) -> torch.Tensor:
    """Inverse of `pack_signs`: words → ±1 values (length k along axis)."""
    words = torch.movedim(words, axis, 0).to(torch.int64) & 0xFFFFFFFF
    bits = (words.unsqueeze(1) >> _shifts(words.ndim + 1, 1, words.device)) & 1
    flat = bits.reshape((-1,) + tuple(words.shape[1:]))[:k]
    return torch.movedim((flat * 2 - 1).to(dtype), 0, axis)


# ---------------------------------------------------------------------------
# Deployment artifact (the COE-file analogue): a directory of .npy blobs and
# a manifest, in the reference's file names, keys, shapes and dtypes, so a
# directory written by either package loads in the other byte for byte.
# ---------------------------------------------------------------------------

_BLOBS = ("w_packed", "mul_prev", "div_current", "bias")


def export_packed_layer(path, name: str, *, weight, mul_prev, div_current,
                        bias) -> dict:
    """Write one W1A8 layer's deployment blobs; returns the manifest entry.

    weight: (K, N) float → packed (ceil(K/32), N) words, written as
    ``uint32`` (the int32 carrier's bits); mul_prev (K,), div_current and
    bias (N,) as float32. Tensors or arrays.
    """
    os.makedirs(path, exist_ok=True)
    weight = torch.as_tensor(weight).cpu()
    words = pack_signs(weight, axis=0).numpy().view(np.uint32)
    blobs = {"w_packed": words,
             "mul_prev": _f32(mul_prev), "div_current": _f32(div_current),
             "bias": _f32(bias)}
    entry = {"name": name, "k": int(weight.shape[0]),
             "n": int(weight.shape[1])}
    for key, arr in blobs.items():
        fn = f"{name}.{key}.npy"
        np.save(os.path.join(path, fn), arr)
        entry[key] = {"file": fn, "shape": list(arr.shape),
                      "dtype": str(arr.dtype)}
    return entry


def load_packed_layer(path, entry: dict, device=None) -> dict:
    """The blobs of one manifest entry as tensors on ``device``: the sign
    words in the int32 carrier, the rest float32."""
    dev = resolve_device(device)
    out = {}
    for key in _BLOBS:
        arr = np.load(os.path.join(path, entry[key]["file"]))
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        out[key] = torch.from_numpy(arr.copy()).to(dev)
    return out


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)
