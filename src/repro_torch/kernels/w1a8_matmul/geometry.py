"""Launch geometry of the matmul kernels on the tensor cores, dot
(``csrc/w1a8_matmul.cu``) and popcount (``csrc/w1a8_matmul_popcount.cu``,
whose tiles the int kernel ``csrc/w1a8_matmul_int.cu`` shares), computed
here and passed to them whole.

A block covers ``bm = 16·wm`` rows of M and ``bn = 8·wn·items`` columns of
N: ``items`` warp items of ``wm`` M tiles of 16 rows by ``wn`` N tiles of 8
columns, each computed by two warps that split its K and add their partial
sums in a fixed order. The operands go from device memory straight into
registers; shared memory holds only the partial sums. The kernels refuse
a geometry that does not cover the output exactly.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.config import ACCUMS
from repro_torch.kernels.w1a8_conv.geometry import MAX_WARPS, SMS, _cdiv

K_SPLIT = 2           # the kernels' w1a8::kSplit: warps sharing an item's K
MIN_WARPS_PER_SM = 4  # warps per SM a wider tile must still leave
# warp tiles (wm, wn) of each route, widest first, as its library's
# w1a8::pick_matmul builds them. A dot warp forms the bf16 prologue of
# each A row it loads, so 1×4 forms it once for four N tiles where 1×1
# forms it four times; popcount has no prologue. On an H100 at conv9
# (N = 64) the dot's fastest tile was 1×1 at M = 400–1600 and 1×4 at
# M = 3200–6400, and popcount's 1×1 at every M from 400 to 6400; no wm = 2
# tile was the fastest or within 10% of it anywhere (PERF.md, PR 15)
WARP_TILES = {"dot": ((1, 4), (1, 1)), "popcount": ((1, 1),)}


@dataclasses.dataclass(frozen=True)
class MatmulLaunch:
    grid: tuple          # (x: row blocks, y: column blocks)
    threads: int         # 32·K_SPLIT·items
    bm: int              # rows per block, 16·wm
    bn: int              # columns per block, 8·wn·items
    wm: int              # 16-row M tiles per warp item
    wn: int              # 8-column N tiles per warp item


def matmul_launch(m: int, n: int, accum: str) -> MatmulLaunch:
    """The grid and tile of one matmul launch of route ``accum`` on the
    tensor cores.

    The warp tile is the first of the route's WARP_TILES that still leaves
    MIN_WARPS_PER_SM warps on every SM (items · K_SPLIT), else the
    smallest: at the detector's conv9 with the launcher's 4 slots (M = 400,
    K = 128, N = 64; 25 × 8 m16n8 output tiles) no tile fills the card,
    and the time is one round of loads, each warp's share of the prologue,
    its chain of dependent mma.sync and the epilogue; from M ≈ 2100 on (at
    N = 64) the dot's 1×4 leaves enough warps and forms each prologue
    value a quarter as often. A block starts with one item for each N
    item, as many as MAX_WARPS allows, and halves them while the grid
    holds fewer blocks than SMs. K does not enter: every item walks all of
    it.
    """
    if accum not in ACCUMS:
        raise ValueError(f"accum={accum!r} not in {ACCUMS}")
    if min(m, n) < 1:
        raise ValueError(f"bad matmul shape M={m}, N={n}")
    m_tiles, n_tiles = _cdiv(m, 16), _cdiv(n, 8)
    for wm, wn in WARP_TILES[accum]:
        if (_cdiv(m_tiles, wm) * _cdiv(n_tiles, wn) * K_SPLIT
                >= MIN_WARPS_PER_SM * SMS):
            break
    n_items = _cdiv(n_tiles, wn)
    items = min(MAX_WARPS // K_SPLIT, n_items)
    bm = 16 * wm

    def blocks(i: int) -> int:
        return _cdiv(m, bm) * _cdiv(n_items, i)
    while items > 1 and blocks(items) < SMS:
        items = _cdiv(items, 2)
    bn = 8 * wn * items
    return MatmulLaunch(grid=(_cdiv(m, bm), _cdiv(n, bn)),
                        threads=32 * K_SPLIT * items, bm=bm, bn=bn, wm=wm,
                        wn=wn)
