"""Plain PyTorch versions of the W1A8 packed matmul kernels.

    y[m, n] = (Σ_k sign[k, n] · bf16(mul_prev[k] · a[m, k])) · div_post[n] + bias[n]

optionally requantized to uint8 codes with step ``out_step``. The bf16
rounding of the prologue mirrors the reference's Pallas body
(``repro/kernels/w1a8_matmul/kernel.py``), which rounds there; the sum is a
float32 product with ±1.

The popcount version forms the same sum as an exact integer from the 8
bit-planes of the codes (``w1a8_matmul_popcount_pallas``), and its grouped
form one such product per expert (the MoE FFN's packed experts); the int
version
as (a − 128)·(±1) plus 128·colsum (``w1a8_matmul_int_pallas``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.quant import requant_epilogue
from repro_torch.device import full_f32


def bf16_prologue(a_u8: torch.Tensor, mul: torch.Tensor) -> torch.Tensor:
    """bf16(a · mul) as float32 values."""
    return (a_u8.to(torch.float32) * mul.to(torch.float32)) \
        .to(torch.bfloat16).to(torch.float32)


def w1a8_matmul_ref(a_u8: torch.Tensor, w_packed: torch.Tensor, k: int,
                    mul_prev: torch.Tensor, div_post: torch.Tensor,
                    bias: torch.Tensor,
                    out_step: Optional[float] = None) -> torch.Tensor:
    """a_u8 (M, ≥k) uint8; w_packed (ceil(k/32), N) int32 words;
    mul_prev (k,); div_post, bias (N,) → (M, N) f32, or uint8 codes."""
    signs = packing.unpack_signs(w_packed, k, axis=0, dtype=torch.float32)
    am = bf16_prologue(a_u8[..., :k], mul_prev)
    with full_f32():
        y = am @ signs
    y = y * div_post.to(torch.float32) + bias.to(torch.float32)
    if out_step is None:
        return y
    return requant_epilogue(y, out_step)


# ---------------------------------------------------------------------------
# Binary domain: exact integer Σ_k s_k·a_k from bit-planes and popcounts.
# torch has no popcount, and integer matmuls do not run on CUDA, so the
# plain versions count bits with shifts and masks (SWAR) in int64. Sign
# words are held as int32, so a word with bit 31 set is negative: every
# word is masked to its 32 bits before a shift.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each int64 element (SWAR)."""
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def pack_act_bitplane(a_u8: torch.Tensor, bit: int) -> torch.Tensor:
    """Bit-plane ``bit`` of codes (M, Kp) → (M, Kp/32) int64 words, LSB
    first as in `core.packing` (counterpart of ``_pack_act_bitplane``)."""
    m, kp = a_u8.shape
    bits = (a_u8.to(torch.int64) >> bit) & 1
    shifts = torch.arange(packing.PACK, dtype=torch.int64, device=a_u8.device)
    return torch.sum(bits.reshape(m, kp // packing.PACK, packing.PACK)
                     << shifts, dim=2)


def xnor_accumulate(a_u8: torch.Tensor, w_words: torch.Tensor) -> torch.Tensor:
    """Σ_k sign_k·a_k, exact int32 (counterpart of ``_xnor_accumulate``).

    a_u8 (M, Kp) codes, Kp = 32·rows of w_words; w_words (Kp/32, N) sign
    words. Per bit-plane a_b, Σ_k s_k·a_{b,k} = 2·popc(w ∧ a_b) − popc(a_b),
    shifted left by b. Zero codes add 0 to both terms, so K-pad lanes
    (zero codes against +1 pad bits) are free.
    """
    w = w_words.to(torch.int64) & _M32                     # (Kp/32, N)
    acc = torch.zeros((a_u8.shape[0], w.shape[1]), dtype=torch.int64,
                      device=a_u8.device)
    for bit in range(8):
        planes = pack_act_bitplane(a_u8, bit)              # (M, Kp/32)
        pc = torch.sum(popcount32(planes[:, :, None] & w[None]), dim=1)
        cnt = torch.sum(popcount32(planes), dim=1, keepdim=True)
        acc = acc + ((2 * pc - cnt) << bit)
    return acc.to(torch.int32)


def pad_codes(a_u8: torch.Tensor, k: int) -> torch.Tensor:
    """(M, ≥k) codes → (M, Kp) with zero codes in lanes k..Kp."""
    kp = packing.packed_dim(k) * packing.PACK
    a = a_u8[:, :k]
    if kp == k:
        return a
    return torch.cat([a, a.new_zeros((a.shape[0], kp - k))], dim=1)


def popcount_epilogue(acc: torch.Tensor, div_post: torch.Tensor,
                      bias: torch.Tensor,
                      out_step: Optional[float]) -> torch.Tensor:
    """f32(acc)·div + bias (two roundings), optionally requantized. The
    sum is below 2^24, so its conversion to f32 is exact."""
    y = acc.to(torch.float32) * div_post.to(torch.float32) \
        + bias.to(torch.float32)
    if out_step is None:
        return y
    return requant_epilogue(y, out_step)


def w1a8_matmul_popcount_ref(a_u8: torch.Tensor, w_packed: torch.Tensor,
                             k: int, div_post: torch.Tensor,
                             bias: torch.Tensor,
                             out_step: Optional[float] = None
                             ) -> torch.Tensor:
    """Binary-domain matmul on codes already on one grid (the consumer-side
    fold is the caller's): a_u8 (M, ≥k); w_packed (ceil(k/32), N) int32;
    div_post, bias (N,) → (M, N) f32, or uint8 codes."""
    acc = xnor_accumulate(pad_codes(a_u8, k), w_packed)
    return popcount_epilogue(acc, div_post, bias, out_step)


def w1a8_matmul_grouped_ref(a_u8: torch.Tensor, w_packed: torch.Tensor,
                            counts: torch.Tensor, k: int,
                            div_post: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """The grouped popcount matmul: expert e's codes a_u8[e] (cap, k)
    against its words w_packed[e] (ceil(k/32), N), with div_post[e] and
    bias[e] (N,), as `w1a8_matmul_popcount_ref`; rows from counts[e] on
    are 0. Returns (E, cap, N) f32."""
    out = torch.stack([
        w1a8_matmul_popcount_ref(a_u8[e], w_packed[e], k, div_post[e],
                                 bias[e])
        for e in range(a_u8.shape[0])])
    rows = torch.arange(a_u8.shape[1], device=a_u8.device)
    held = rows[None, :, None] < counts.to(a_u8.device)[:, None, None]
    return torch.where(held, out, 0.0)


# ---------------------------------------------------------------------------
# The decode tile's decomposition (csrc/w1a8_matmul_popcount.cu), in torch:
# K in spans of SPAN codes, span s to K slice s % slices, each slice's sum
# formed as 2·Σ bit·a − Σ a from the sign bits as 0/1, the slices' int32
# partial sums added in slice order, then the epilogue. The grouped entry's
# work list: the held experts' row blocks by column tiles.
# ---------------------------------------------------------------------------

SPAN = 128


def split_k_sums(a_u8: torch.Tensor, w_packed: torch.Tensor, k: int,
                 slices: int) -> torch.Tensor:
    """Σ_k s_k·a_k, exact int32, as the decode tile forms it: a_u8 (M, ≥k)
    codes, w_packed (ceil(k/32), N) words; K slice q holds the spans q,
    q + slices, …; within a slice 2·Σ bit·a − Σ a. The products run in
    float64, where every partial sum is an exact integer."""
    a = pad_codes(a_u8, k).to(torch.float64)
    bits = packing.unpack_signs(w_packed, a.shape[1], axis=0,
                                dtype=torch.float64).add(1.0).mul(0.5)
    span = torch.arange(a.shape[1], device=a_u8.device) // SPAN
    acc = torch.zeros((a.shape[0], w_packed.shape[1]), dtype=torch.int32,
                      device=a_u8.device)
    for q in range(slices):
        sel = span % slices == q
        part = 2.0 * (a[:, sel] @ bits[sel]) - a[:, sel].sum(1, keepdim=True)
        acc = acc + part.to(torch.int32)
    return acc


def w1a8_matmul_popcount_split(a_u8: torch.Tensor, w_packed: torch.Tensor,
                               k: int, div_post: torch.Tensor,
                               bias: torch.Tensor,
                               out_step: Optional[float] = None, *,
                               slices: int = 1) -> torch.Tensor:
    """`w1a8_matmul_popcount_ref` through the decode tile's decomposition
    of K into ``slices`` slices (`split_k_sums`): the same bits."""
    return popcount_epilogue(split_k_sums(a_u8, w_packed, k, slices),
                             div_post, bias, out_step)


def grouped_items(counts: torch.Tensor, cap: int, unit: int,
                  tiles: int) -> list:
    """The grouped entry's work items in order, as every block forms them
    on the device: (expert, row block, column tile) over the row blocks of
    ``unit`` rows each expert holds (counts clamped to [0, cap]), item
    i = row block i // tiles, column tile i % tiles."""
    held = counts.to(torch.int64).clamp(0, cap)
    blocks = (held + unit - 1) // unit
    pre = [0] + torch.cumsum(blocks, 0).tolist()
    items = []
    for i in range(pre[-1] * tiles):
        h = i // tiles
        e = max(j for j in range(len(held)) if pre[j] <= h)
        items.append((e, h - pre[e], i % tiles))
    return items


def w1a8_matmul_grouped_split(a_u8: torch.Tensor, w_packed: torch.Tensor,
                              counts: torch.Tensor, k: int,
                              div_post: torch.Tensor, bias: torch.Tensor, *,
                              unit: int, bn: int,
                              slices: int = 1) -> torch.Tensor:
    """`w1a8_matmul_grouped_ref` through the grouped entry's work list
    (`grouped_items`): each item the rows of its row block an expert
    holds by ``bn`` columns, split into ``slices`` K slices; every other
    row 0."""
    e, cap = a_u8.shape[0], a_u8.shape[1]
    n = w_packed.shape[-1]
    held = counts.to(torch.int64).clamp(0, cap)
    out = torch.zeros((e, cap, n), dtype=torch.float32, device=a_u8.device)
    for x, rb, tile in grouped_items(counts, cap, unit, -(-n // bn)):
        r0, r1 = rb * unit, min((rb + 1) * unit, int(held[x]))
        c0, c1 = tile * bn, min((tile + 1) * bn, n)
        out[x, r0:r1, c0:c1] = w1a8_matmul_popcount_split(
            a_u8[x, r0:r1], w_packed[x, :, c0:c1], k, div_post[x, c0:c1],
            bias[x, c0:c1], slices=slices)
    return out


def w1a8_matmul_int_ref(a_u8: torch.Tensor, w_packed: torch.Tensor,
                        colsum: torch.Tensor) -> torch.Tensor:
    """Exact Σ_k s·a as (a − 128)·(±1) plus 128·colsum, int32.

    a_u8 (M, K); w_packed (ceil(K/32), N) int32; colsum (N,) int32 =
    Σ_{k<K} sign[k, n]. The product runs in float64, where every partial
    sum (|Σ| ≤ 128·K) is an exact integer.
    """
    k = a_u8.shape[1]
    signs = packing.unpack_signs(w_packed, k, axis=0, dtype=torch.float64)
    centred = a_u8.to(torch.float64) - 128.0
    acc = (centred @ signs).to(torch.int32)
    return acc + 128 * colsum.to(torch.int32).reshape(1, -1)
