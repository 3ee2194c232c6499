"""Launch geometry of the matmul kernels on the tensor cores, dot
(``csrc/w1a8_matmul.cu``) and popcount (``csrc/w1a8_matmul_popcount.cu``,
whose tiles the int kernel ``csrc/w1a8_matmul_int.cu`` shares), computed
here and passed to them whole.

`matmul_launch` (the PR-15 tile): a block covers ``bm = 16·wm`` rows of M
and ``bn = 8·wn·items`` columns of N: ``items`` warp items of ``wm`` M
tiles of 16 rows by ``wn`` N tiles of 8 columns, each computed by two warps
that split its K and add their partial sums in a fixed order. The operands
go from device memory straight into registers; shared memory holds only
the partial sums.

`decode_launch` (the popcount matmul at M ≤ DECODE_MAX_M, and the grouped
entry at cap ≤ DECODE_MAX_M): the mma's 16-row side is 16 output columns
and its 8-column side 8 tokens; a warp covers ``16·wn`` columns of up to
``8·wm`` tokens over a slice of K, a block ``cw`` such warps side by side
times ``kw`` slices, a thread block cluster ``cs`` blocks that split K
further. `grouped_launch` picks either tile for the grouped entry, whose
grid is persistent over the experts that hold rows. The kernels refuse a
geometry that does not cover the output exactly.
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


# The decode route. Rows (tokens) at or below DECODE_MAX_M, over K of at
# least DECODE_MIN_K, take the decode tile; otherwise, and for the int
# matmul, `matmul_launch`'s tile. On an H100 (launch/tile_sweep.py
# --decode, graph replays in turns) the decode route beat the PR-15 tile
# at every M from 1 to 16 at (K, N) = (4096, 13696), 7.2–9.7 µs against
# 19.5–20.0, and at M = 4, N = 4096 lost up to K = 512 (3.24 against 3.15
# µs) and won from K = 768 (3.60 against 3.70–3.85) (PERF.md, PR 30)
DECODE_MAX_M = 16
DECODE_MIN_K = 768
DECODE_MAX_K = 65536   # the decode kernel's kMaxK: 128·255·K stays in int32
DECODE_THREADS = 256   # the decode kernel's __launch_bounds__
DECODE_REGS = 168      # registers a decode thread holds at most (ptxas -v)
REGS_PER_SM = 65536
SMEM_PER_SM = 233_472  # shared memory an H100 SM holds for its blocks
DECODE_COL_WARPS = 1   # warps side by side in a block (cw)
DECODE_K_WARPS = 8     # warps a block splitting K (kw), at most
DECODE_GROUPED_K_WARPS = 4  # the grouped entry's kw
DECODE_MAX_CLUSTER = 8  # blocks a cluster splitting K (cs), at most
DECODE_MIN_SPANS = 1   # spans of SPAN codes a K slice keeps at least
DECODE_MIN_WARPS = 256  # clusters grow while a grid holds fewer warps
DECODE_SPANS_PER_WARP = 8  # ... or a warp walks more spans than this
GROUPED_BLOCKS_PER_SM = 4  # the grouped entry's PR-15 tile: blocks an SM
SPAN = 128             # codes of K a warp's quads take per step
STAGES = 4             # the decode kernel's kStages: a lane's ring of spans


def decodes(m: int, k: int) -> bool:
    """Whether a popcount launch of M = ``m`` rows (the grouped entry's
    cap) and K = ``k`` takes the decode tile."""
    return m <= DECODE_MAX_M and DECODE_MIN_K <= k <= DECODE_MAX_K


@dataclasses.dataclass(frozen=True)
class DecodeLaunch:
    blocks: int          # tiles·cs (2-D), or the persistent grid (grouped)
    threads: int         # 32·cw·kw
    bm: int              # tokens a block covers, 8·wm
    bn: int              # columns a block covers, 16·wn·cw
    wm: int              # 8-token tiles (1 or 2)
    wn: int              # 16-column tiles a warp (1, 2 or 4)
    cw: int              # warps side by side
    kw: int              # warps splitting a block's K
    cs: int              # blocks a cluster, splitting K further
    tiles: int           # column tiles of bn


def decode_smem(wm: int, wn: int, threads: int, bn: int,
                experts: int = 0) -> int:
    """Dynamic shared memory of a decode block, as the kernel sizes it:
    each warp's ring (STAGES spans of 16 bytes a lane for every 4 sign
    words and every 16 codes of a token tile), a slot for each lane's
    int32 fragments (16 bytes for each 16 × 8 tile), the tile's Div and
    bias, the grouped entry's prefix over ``experts``."""
    chunks = (1 if wn == 1 else wn // 2) + 2 * wm
    return 16 * threads * (STAGES * chunks + wm * wn) \
        + 4 * (2 * bn + (experts + 1 if experts else 0))


def resident_blocks(wm: int, wn: int, threads: int, bn: int,
                    experts: int = 0) -> int:
    """Decode blocks the card holds at once, as an SM's registers
    (DECODE_REGS a thread) and shared memory (`decode_smem`, and the 1 KB
    a block reserves) allow."""
    per_sm = min(REGS_PER_SM // (DECODE_REGS * threads),
                 SMEM_PER_SM // (decode_smem(wm, wn, threads, bn, experts)
                                 + 1024))
    return SMS * max(1, per_sm)


def decode_launch(m: int, k: int, n: int,
                  experts: int = 0) -> DecodeLaunch:
    """The decode tile's launch for M = ``m`` tokens (the grouped entry's
    cap with ``experts`` > 0), K = ``k`` and N = ``n``.

    A warp takes 16·wn columns, wn as large as N leaves room for (N ≤ 16:
    1, ≤ 32: 2, else 4), and up to 8·wm tokens; DECODE_COL_WARPS warps sit
    side by side in a block. K is cut into slices of whole spans (at least
    DECODE_MIN_SPANS each): kw warps a block, the most (up to
    DECODE_K_WARPS) that keep every block resident at once
    (`resident_blocks`: a second wave would wait for the first), then, for
    the 2-D entry, clusters of cs blocks, doubled while the grid holds
    fewer than DECODE_MIN_WARPS warps or a warp walks more than
    DECODE_SPANS_PER_WARP spans (a cluster's barriers cost more than a
    block's, so not further). The grouped entry's grid is persistent over
    its items: DECODE_GROUPED_K_WARPS warps a block, as many blocks as are
    resident (or one an item if fewer), no split of K across blocks. On an
    H100 at chatglm3-6b's decode shapes and |model| 16 blocks (M = 4) this
    picks a split within 8% of the fastest of the 6–28 that
    `launch/tile_sweep.py --decode` times (PERF.md, PR 30).
    """
    if not 1 <= m <= 16 or min(k, n) < 1:
        raise ValueError(f"bad decode shape M={m}, K={k}, N={n}")
    wm = 1 if m <= 8 else 2
    wn = 1 if n <= 16 else 2 if n <= 32 else 4
    cw = min(DECODE_COL_WARPS, _cdiv(n, 16 * wn))
    tiles = _cdiv(_cdiv(n, 16 * wn), cw)
    slices = max(1, _cdiv(k, SPAN) // DECODE_MIN_SPANS)
    if experts:
        kw = max(1, min(DECODE_GROUPED_K_WARPS, slices))
        blocks = min(experts * tiles, resident_blocks(
            wm, wn, 32 * cw * kw, 16 * wn * cw, experts))
        return DecodeLaunch(blocks=blocks, threads=32 * cw * kw, bm=8 * wm,
                            bn=16 * wn * cw, wm=wm, wn=wn, cw=cw, kw=kw,
                            cs=1, tiles=tiles)
    kw = next((kw for kw in (8, 4, 2, 1)
               if kw <= min(DECODE_K_WARPS, DECODE_THREADS // (32 * cw),
                            slices)
               and tiles <= resident_blocks(wm, wn, 32 * cw * kw,
                                            16 * wn * cw)), 1)
    cs = 1
    while (2 * cs <= DECODE_MAX_CLUSTER and 2 * cs * kw <= slices
           and 2 * tiles * cs <= resident_blocks(wm, wn, 32 * cw * kw,
                                                 16 * wn * cw)
           and (tiles * cs * kw < DECODE_MIN_WARPS
                or slices > DECODE_SPANS_PER_WARP * kw * cs)):
        cs *= 2
    return DecodeLaunch(blocks=tiles * cs, threads=32 * cw * kw, bm=8 * wm,
                        bn=16 * wn * cw, wm=wm, wn=wn, cw=cw, kw=kw, cs=cs,
                        tiles=tiles)


@dataclasses.dataclass(frozen=True)
class GroupedLaunch:
    decode: bool         # the decode tile (cap ≤ DECODE_MAX_M), else PR 15's
    blocks: int          # the persistent grid
    threads: int
    bm: int
    bn: int
    wm: int
    wn: int
    cs: int


def grouped_launch(experts: int, cap: int, k: int, n: int) -> GroupedLaunch:
    """The grouped entry's launch, its grid persistent over the items of
    the experts that hold rows: the decode tile at cap ≤ DECODE_MAX_M (K
    in the decode route's range; `decode_launch`), else `matmul_launch`'s
    tile at (cap, n), GROUPED_BLOCKS_PER_SM blocks an SM (the PR-15 tile's
    registers leave room for them), or one an item if fewer."""
    if min(experts, cap, k, n) < 1:
        raise ValueError(f"bad grouped shape E={experts}, cap={cap}, K={k}, "
                         f"N={n}")
    if decodes(cap, k):
        d = decode_launch(cap, k, n, experts)
        return GroupedLaunch(decode=True, blocks=d.blocks, threads=d.threads,
                             bm=d.bm, bn=d.bn, wm=d.wm, wn=d.wn, cs=d.cs)
    g = matmul_launch(cap, n, "popcount")
    items = experts * g.grid[0] * g.grid[1]
    return GroupedLaunch(decode=False,
                         blocks=min(items, GROUPED_BLOCKS_PER_SM * SMS),
                         threads=g.threads, bm=g.bm, bn=g.bn, wm=g.wm,
                         wn=g.wn, cs=1)
