"""Launch geometry of the integer PE (``csrc/w1a8_int_pe.cu``), computed
here and passed to it whole.

The PE is the popcount conv kernels' implicit GEMM with one int32
accumulator set per digit plane, so a block is laid out as theirs
(`kernels/w1a8_conv/geometry.py`, accum "popcount"): `bn` output channels,
`rows` output rows (pooled rows when pooled) of one image, warps taking
items of `wm` M tiles of 16 by `wn` N tiles of 8 channels, the staged
strip of raw codes `row_px` pixels wide. The 1×1 layers run as a one-tap
window of the same tile. Its shared memory holds, before the staged
codes, the block's weights: a W1A8 layer's pair words and the digit words
of m_raw with their negations; conv1's and the head's s8 planes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.w1a8_conv.geometry import (CHUNK, MAX_SMEM,
                                                    MAX_WARPS, MIN_WARPS,
                                                    _cdiv, conv_launch,
                                                    pixel_bytes)

# warp tiles (wm, wn) the PE builds, largest first: each holds the kernel's
# kGroup int32 accumulator sets (planes a pass of its K loop) beside the
# int64 sums of the planes combined so far
WARP_TILES = ((2, 2), (2, 1), (1, 1))
NARROW = 32          # output channels up to which a warp takes one N tile
W1A8, CONV1, HEAD = 0, 1, 2


def _align16(n: int) -> int:
    return _cdiv(n, 16) * 16


def window_pairs(ksize: int, cin: int) -> int:
    """Pairs of 16-channel units of the window: one mma.sync's K each."""
    return _cdiv(ksize * ksize * _cdiv(cin, CHUNK), 2)


def pe_smem(kind: int, ksize: int, cin: int, bn: int, planes: int,
            staged_rows: int, row_px: int) -> int:
    """Bytes of a block's shared memory, as the kernel's `pe_smem`."""
    pairs = window_pairs(ksize, cin)
    if kind == W1A8:
        weights = (_align16(4 * (pairs + 1) * bn)
                   + 2 * planes * _cdiv(cin, CHUNK) * CHUNK)
    else:
        weights = planes * 2 * pairs * bn * CHUNK
    return (weights + _align16(4 * 2 * pairs)
            + staged_rows * row_px * pixel_bytes(cin, "popcount"))


@dataclasses.dataclass(frozen=True)
class PeLaunch:
    grid: tuple          # (x: channel blocks, y: row blocks, z: images)
    threads: int
    smem: int            # dynamic shared memory bytes
    rows: int            # output rows (pooled rows when pool) per block
    bn: int              # output channels per block
    wm: int              # 16-row M tiles per warp item
    wn: int              # 8-channel N tiles per warp item
    row_px: int          # staged pixels per row


def pe_launch(kind: int, b: int, h: int, w: int, cin: int, cout: int,
              ksize: int, pool: bool, planes: int) -> PeLaunch:
    """The grid, tile and shared memory of one integer PE launch.

    The rows and block N are the popcount conv's at this shape
    (`conv_launch`), the block N cut to the N tiles `cout` fills (conv1's
    16 channels) and halved while the block's weights and strip overflow
    shared memory (many planes of a wide dense layer). The warp tile is
    the largest of WARP_TILES with the conv's wm (two M tiles where a
    block has them) and two N tiles, but one up to NARROW output channels:
    conv1's and conv2's windows are 5 pairs of units, so a warp's time is
    mostly its int64 epilogue, which more, smaller items hide better. On
    an H100 this picks the fastest of the three tiles at every layer of
    the integer forward (`launch/tile_sweep.py`; PERF.md §6).
    """
    # one output row a block: two measured slower on an H100 over the
    # detector's layers (PERF.md §6)
    g = conv_launch(b, h, w, cin, cout, 1, pool, "popcount")
    wn_max = 1 if cout <= NARROW else 2
    wm, wn = next((tm, tn) for tm, tn in WARP_TILES
                  if tm <= g.wm and tn <= wn_max)
    step = 8 * wn
    bn = min(g.bn, _cdiv(cout, step) * step)
    staged = (2 * g.rows if pool else g.rows) + ksize - 1
    smem = pe_smem(kind, ksize, cin, bn, planes, staged, g.row_px)
    while smem > MAX_SMEM and bn > step:
        bn = max(step, bn // 2 // step * step)
        smem = pe_smem(kind, ksize, cin, bn, planes, staged, g.row_px)
    if smem > MAX_SMEM:
        raise ValueError(f"{planes} planes at {(h, w, cin, ksize)} need "
                         f"{smem} bytes of shared memory; a block has "
                         f"{MAX_SMEM}")
    m_tiles = _cdiv(g.rows * (2 * w if pool else w), 16)
    items = _cdiv(m_tiles, wm) * (bn // step)
    warps = max(MIN_WARPS, _cdiv(items, _cdiv(items, MAX_WARPS)))
    h_out = h // 2 if pool else h
    return PeLaunch(grid=(_cdiv(cout, bn), _cdiv(h_out, g.rows), b),
                    threads=32 * warps, smem=smem, rows=g.rows, bn=bn,
                    wm=wm, wn=wn, row_px=g.row_px)
