"""Launch geometry of the conv kernels on the tensor cores, dot
(``csrc/w1a8_conv3x3.cu``, ``csrc/w1a8_conv3x3_pool2.cu``) and popcount
(``csrc/w1a8_conv3x3_popcount.cu``, ``csrc/w1a8_conv3x3_pool2_popcount.cu``),
computed here and passed to them whole.

A block covers `bn` output channels (a multiple of 32), `rows` output rows
(pooled rows for the fused kernels; the last block may hold fewer) and one
image. Its M is its outputs in row-major order, for the fused kernels four
conv outputs per pooled pixel; warps take items of `wm` M tiles of 16 by
`wn` N tiles of 8 channels. The block stages `staged_rows` input rows of
`row_px` pixels in shared memory, each pixel `pixel_bytes(cin, accum)`
bytes, after its sign words (and, for popcount, the offsets of the
window's units). The two routes differ only in what a staged pixel holds:
bf16 prologue values for dot, whose mma.sync takes 16 channels, raw uint8
codes for popcount, whose int8 mma.sync takes 32. The kernels refuse a
geometry that does not cover the output exactly or does not hold the
staging; a launch that asks for more shared memory than a block may have
would never run, so this module raises first.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.config import ACCUMS

CHUNK = 16            # channel padding: K of one dot mma.sync, and of a unit
UNIT = 16             # bytes of an ldmatrix row, and of a cp.async
BN_STEP = 32          # output channels a block covers come in 32s
MAX_WARPS = 8         # the kernels' __launch_bounds__(256)
MIN_WARPS = 4         # threads enough to keep a strip's loads in flight
MAX_SMEM = 232_448    # dynamic shared memory a block may use (227 KB)
SMS = 132             # H100 SXM streaming multiprocessors
WARPS_PER_SM = 8      # warp items wanted per SM before tiles grow
# warp tiles (wm, wn), largest first: a larger tile builds its B fragments
# once for more M tiles; a smaller one gives more warps to hide latency
WARP_TILES = ((2, 4), (2, 2), (2, 1), (1, 2), (1, 1))
PACK = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_cin(cin: int) -> int:
    """Channels a staged pixel holds: cin rounded up to 16 (zeros past)."""
    return _cdiv(cin, CHUNK) * CHUNK


def pixel_bytes(cin: int, accum: str = "dot") -> int:
    """Bytes from one staged pixel to the next: an odd number of 16-byte
    units, so eight pixels whose indices differ mod 8 fall on eight
    different bank groups. dot: padded_cin bf16 values (an even number of
    units) and one spare unit; popcount: padded_cin codes, and one spare
    unit where they fill an even number."""
    units = padded_cin(cin) // CHUNK
    return UNIT * (2 * units + 1 if accum == "dot" else units | 1)


def pair_words(cin: int) -> int:
    """Popcount: one 32-bit sign word per pair of 16-channel units of the
    3×3 window, each int8 mma.sync's K."""
    return _cdiv(9 * padded_cin(cin) // CHUNK, 2)


def words_smem(cin: int, bn: int, accum: str = "dot") -> int:
    """Shared memory before the staged pixels: dot, the sign words
    (⌈9·Cin/32⌉ + 1, bn); popcount, the pair words (pair_words + 1, bn) and
    the window's 2·pair_words unit offsets (int32), each 16-byte aligned."""
    if accum == "dot":
        return _cdiv(4 * (_cdiv(9 * cin, PACK) + 1) * bn, 16) * 16
    pairs = pair_words(cin)
    return (_cdiv(4 * (pairs + 1) * bn, 16) * 16
            + _cdiv(4 * 2 * pairs, 16) * 16)


@dataclasses.dataclass(frozen=True)
class ConvLaunch:
    grid: tuple          # (x: channel blocks, y: row blocks, z: images)
    threads: int
    smem: int            # dynamic shared memory bytes
    rows: int            # output rows (pooled rows when pool) per block
    bn: int              # output channels per block
    wm: int              # 16-row M tiles per warp item
    wn: int              # 8-channel N tiles per warp item
    row_px: int          # staged pixels per row
    staged_rows: int     # input rows a full block stages
    m_row: int           # M rows per output row of a block


def conv_launch(b: int, h: int, w: int, cin: int, cout: int, rows: int,
                pool: bool, accum: str = "dot") -> ConvLaunch:
    """The grid, tile and shared memory of one conv launch on the tensor
    cores, for ``accum`` "dot" or "popcount".

    ``bn`` shrinks from min(Cout, 128) while the grid holds fewer than two
    blocks per SM; the warp tile is the first of WARP_TILES that still
    gives WARPS_PER_SM warp items per SM (one mma.sync warp keeps a tensor
    core only partly busy, so latency wants many; the order is the one that
    measured fastest at the detector's shapes on an H100). ``row_px`` keeps
    the eight ldmatrix rows of a fragment on eight different 16-byte bank
    groups: a staged pixel spans an odd number of 16-byte units
    (`pixel_bytes`), so eight pixels do when their indices differ mod 8.
    Conv M tiles are runs of consecutive pixels, which stay distinct across
    a row end when row_px ≡ w (mod 8); fused M tiles take pixels
    {0, 1, 2, 3} + 2·px of two rows, which need row_px ≡ 4 (mod 8).
    """
    if accum not in ACCUMS:
        raise ValueError(f"accum must be one of {ACCUMS}, got {accum!r}")
    if min(b, h, w, cin, cout, rows) < 1:
        raise ValueError(f"bad conv shape {(b, h, w, cin, cout)} or "
                         f"rows={rows}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"H and W must be even, got {h}x{w}")
    h_out = h // 2 if pool else h
    rows = min(rows, h_out)
    grid_y = _cdiv(h_out, rows)
    bn = min(128, _cdiv(cout, BN_STEP) * BN_STEP)
    while bn > BN_STEP and _cdiv(cout, bn) * grid_y * b < 2 * SMS:
        bn = _cdiv(bn // 2, BN_STEP) * BN_STEP
    blocks = _cdiv(cout, bn) * grid_y * b
    m_row = 2 * w if pool else w
    m_tiles = _cdiv(rows * m_row, 16)
    for wm, wn in WARP_TILES:
        items = _cdiv(m_tiles, wm) * (bn // (8 * wn))
        if wm <= m_tiles and blocks * items >= WARPS_PER_SM * SMS:
            break
    if pool:
        row_px = w + 2 + (4 - (w + 2)) % 8
        staged_rows = 2 * rows + 2
    else:
        row_px = w + 8
        staged_rows = rows + 2
    warps = max(MIN_WARPS, _cdiv(items, _cdiv(items, MAX_WARPS)))
    smem = (words_smem(cin, bn, accum)
            + staged_rows * row_px * pixel_bytes(cin, accum))
    if smem > MAX_SMEM:
        raise ValueError(f"rows={rows} needs {smem} bytes of shared memory "
                         f"at {(h, w, cin)}; a block has {MAX_SMEM}")
    return ConvLaunch(grid=(_cdiv(cout, bn), grid_y, b), threads=32 * warps,
                      smem=smem, rows=rows, bn=bn, wm=wm, wn=wn,
                      row_px=row_px,
                      staged_rows=staged_rows, m_row=m_row)
