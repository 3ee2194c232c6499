"""Launch geometry of the dot conv kernels (``csrc/w1a8_conv3x3.cu``,
``csrc/w1a8_conv3x3_pool2.cu``), computed here and passed to them whole.

A block covers `bn` output channels (a multiple of 32), `rows` output rows
(pooled rows for the fused kernel; the last block may hold fewer) and one
image. Its M is its outputs in row-major order, for the fused kernel four
conv outputs per pooled pixel; warps take items of `wm` M tiles of 16 by
`wn` N tiles of 8 channels. The block stages `staged_rows` input rows of `row_px` pixels in
shared memory, each pixel `pixel_stride(cin)` bf16 values, after its sign
words. The kernels refuse a geometry that does not cover the output exactly
or does not hold the staging; a launch that asks for more shared memory than
a block may have would never run, so this module raises first.
"""
from __future__ import annotations

import dataclasses

CHUNK = 16            # K per mma.sync, and the channel padding
PIX_PAD = 8           # spare bf16 after each staged pixel (16 bytes)
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
    return _cdiv(cin, CHUNK) * CHUNK


def pixel_stride(cin: int) -> int:
    return padded_cin(cin) + PIX_PAD


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
                pool: bool) -> ConvLaunch:
    """The grid, tile and shared memory of one dot conv launch.

    ``bn`` shrinks from min(Cout, 128) while the grid holds fewer than two
    blocks per SM; the warp tile is the first of WARP_TILES that still
    gives WARPS_PER_SM warp items per SM (one mma.sync warp keeps a tensor
    core only partly busy, so latency wants many; the order is the one that
    measured fastest at the detector's shapes on an H100). ``row_px`` keeps the eight ldmatrix rows of a fragment
    on eight different 16-byte bank groups: a staged pixel spans an odd
    number of 16-byte units, so eight pixels do when their indices differ
    mod 8. Conv M tiles are runs of consecutive pixels, which stay distinct
    across a row end when row_px ≡ w (mod 8); fused M tiles take pixels
    {0, 1, 2, 3} + 2·px of two rows, which need row_px ≡ 4 (mod 8).
    """
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
    words = _cdiv(9 * cin, PACK) + 1
    smem = (_cdiv(4 * words * bn, 16) * 16
            + 2 * staged_rows * row_px * pixel_stride(cin))
    if smem > MAX_SMEM:
        raise ValueError(f"rows={rows} needs {smem} bytes of shared memory "
                         f"at {(h, w, cin)}; a block has {MAX_SMEM}")
    return ConvLaunch(grid=(_cdiv(cout, bn), grid_y, b), threads=32 * warps,
                      smem=smem, rows=rows, bn=bn, wm=wm, wn=wn,
                      row_px=row_px,
                      staged_rows=staged_rows, m_row=m_row)
