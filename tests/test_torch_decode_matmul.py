"""Port parity, the popcount matmul's decode route and grouped work list.

The decode tile (`geometry.decode_launch`, ``csrc/w1a8_matmul_popcount.cu``)
splits K into slices of 128-code spans and forms each slice's sum as
2·Σ bit·code − Σ code; the grouped entry walks (held expert, row block,
column tile) items formed from the counts on the device. `ref.py` emulates
both decompositions in torch, and they are held bit for bit against the
plain versions (exact integer sums, one shared f32 epilogue), the geometry
against the outputs and K words it must cover once, the routing against
the PR-15 tile's geometry at the detector's shapes, and the decode route
against the reference's Pallas kernel in interpret mode.
"""
import collections
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.packing import unpack_signs as junpack  # noqa: E402
from repro.kernels.config import KernelConfig as JConfig  # noqa: E402
from repro.kernels.w1a8_matmul import ops as jmm  # noqa: E402
from repro_torch.kernels.config import KernelConfig  # noqa: E402
from repro_torch.kernels.w1a8_matmul import geometry as geo  # noqa: E402
from repro_torch.kernels.w1a8_matmul import ops as mm  # noqa: E402
from repro_torch.kernels.w1a8_matmul import ref  # noqa: E402

POPCOUNT = KernelConfig(op="matmul", accum="popcount")


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8))
    w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1,
                                      (-(-k // 32), n)).astype(np.int32))
    div = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return a, w, div, bias


@pytest.mark.parametrize("m", [1, 3, 4, 8, 13, 16])
@pytest.mark.parametrize("k,n", [(300, 37), (1000, 70), (176, 16),
                                 (33, 5)])
@pytest.mark.parametrize("quant", [False, True])
def test_split_k_equals_the_plain_version(m, k, n, quant):
    """K not a multiple of 32 or of the 128-code span, ragged N, with and
    without the requant: every K split gives the plain version's bits."""
    a, w, div, bias = _operands(m * k + n, m, k, n)
    step = None
    if quant:
        step = float(ref.w1a8_matmul_popcount_ref(a, w, k, div, bias)
                     .abs().max()) / 255.0
    want = ref.w1a8_matmul_popcount_ref(a, w, k, div, bias, step)
    for slices in (1, 2, 3, 8):
        got = ref.w1a8_matmul_popcount_split(a, w, k, div, bias, step,
                                             slices=slices)
        assert torch.equal(got, want), slices


GROUPED_COUNTS = {
    "empty experts": [0, 3, 8, 0, 1, 5],
    "all empty": [0, 0, 0, 0, 0, 0],
    "one full": [0, 0, 8, 0, 0, 0],
    "past cap and negative": [9, -1, 100, 3, -7, 8],
}


@pytest.mark.parametrize("case", sorted(GROUPED_COUNTS))
@pytest.mark.parametrize("cap,unit,bn", [(8, 8, 64), (20, 16, 32)])
def test_grouped_work_list_equals_the_plain_version(case, cap, unit, bn):
    """The grouped entry's items (the decode tile's one block of cap rows
    an expert at cap 8, PR 15's 16-row blocks at cap 20), each a K-split
    sum, against the plain version; rows from each count on are 0."""
    counts = torch.tensor([min(c, 3 * cap) for c in GROUPED_COUNTS[case]],
                          dtype=torch.int32)
    e, k, n = len(counts), 200, 70
    rng = np.random.default_rng(cap + len(case))
    a = torch.from_numpy(rng.integers(0, 256, (e, cap, k), dtype=np.uint8))
    w = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1,
                                      (e, 7, n)).astype(np.int32))
    div = torch.from_numpy(rng.uniform(1e-4, 1e-3, (e, n)).astype(
        np.float32))
    bias = torch.from_numpy(rng.standard_normal((e, n)).astype(np.float32))
    want = ref.w1a8_matmul_grouped_ref(a, w, counts.clamp(0, cap), k, div,
                                       bias)
    got = ref.w1a8_matmul_grouped_split(a, w, counts, k, div, bias,
                                        unit=unit, bn=bn, slices=2)
    assert torch.equal(got, want)
    assert torch.equal(mm.w1a8_matmul_grouped(a, w, counts.clamp(0, cap),
                                              div, bias, k=k), want)


@pytest.mark.parametrize("case", sorted(GROUPED_COUNTS))
@pytest.mark.parametrize("unit", [8, 16])
def test_grouped_items_cover_each_held_row_once(case, unit):
    """Every held (expert, row, column tile) in one item, no item for an
    empty expert, Σ ceil(held / unit) · tiles items in all."""
    cap, tiles = 8 if unit == 8 else 40, 3
    counts = torch.tensor(GROUPED_COUNTS[case], dtype=torch.int32)
    held = counts.clamp(0, cap).tolist()
    items = ref.grouped_items(counts, cap, unit, tiles)
    assert len(items) == sum(-(-h // unit) for h in held) * tiles
    cover = collections.Counter()
    for e, rb, tile in items:
        assert held[e] > 0
        for r in range(rb * unit, min((rb + 1) * unit, held[e])):
            cover[(e, r, tile)] += 1
    assert set(cover.values()) <= {1}
    assert len(cover) == sum(held) * tiles


# (M, K, N): chatglm3-6b's decode projections and TP blocks at M = 4, the
# off-grid decode shape, the M range of the route
DECODE_SHAPES = [(4, 4096, 4096), (4, 4096, 256), (4, 4096, 13696),
                 (4, 13696, 4096), (4, 4096, 16), (4, 256, 4096),
                 (4, 4096, 856), (5, 4100, 2061), (1, 4096, 13696),
                 (8, 4096, 13696), (16, 4096, 13696), (12, 70, 12),
                 (3, 33, 5)]


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES)
def test_decode_geometry_covers_outputs_and_words_once(m, k, n):
    """The decode launch's blocks, warps and lanes, as the kernel maps them:
    every (token, column) of a tile stored by one lane of one kw' = 0 warp
    of rank 0 (lane 4g + t: tokens 8·mt + 2t + e, the 2·wn columns from
    2·wn·g), every K word walked by one (slice, quad) of each warp column;
    the launch within the kernel's limits."""
    d = geo.decode_launch(m, k, n)
    assert d.threads == 32 * d.cw * d.kw <= geo.DECODE_THREADS
    assert d.blocks == d.tiles * d.cs and 1 <= d.cs <= 8
    assert d.bm == 8 * d.wm >= m and d.bn == 16 * d.wn * d.cw
    assert d.tiles * d.bn >= n > (d.tiles - 1) * d.bn
    assert geo.decode_smem(d.wm, d.wn, d.threads, d.bn, 4096) <= 227 * 1024
    assert d.blocks <= geo.resident_blocks(d.wm, d.wn, d.threads, d.bn)
    stored = collections.Counter()
    for tile in range(d.tiles):
        for wc in range(d.cw):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for mt in range(d.wm):
                    for e in range(2):
                        for i in range(2 * d.wn):
                            tok = 8 * mt + 2 * t + e
                            col = (tile * d.bn + wc * 16 * d.wn
                                   + 2 * d.wn * g + i)
                            if tok < m and col < n:
                                stored[(tok, col)] += 1
    assert len(stored) == m * n and set(stored.values()) == {1}
    words, slices = -(-k // 32), d.kw * d.cs
    spans = -(-words // 4)
    walked = collections.Counter(
        4 * s + t for q in range(slices) for s in range(q, spans, slices)
        for t in range(4) if 4 * s + t < words)
    assert len(walked) == words and set(walked.values()) == {1}


# matmul_launch at conv9 (M = 100·B, N = 64) as the PR-15 tile picks it:
# (grid, threads, bm, bn, wm, wn) by accum and B
CONV9 = {
    "popcount": {1: ((7, 8), 64, 16, 8, 1, 1), 4: ((25, 8), 64, 16, 8, 1, 1),
                 8: ((50, 4), 128, 16, 16, 1, 1),
                 16: ((100, 2), 256, 16, 32, 1, 1),
                 32: ((200, 2), 256, 16, 32, 1, 1),
                 64: ((400, 2), 256, 16, 32, 1, 1)},
    "dot": {1: ((7, 8), 64, 16, 8, 1, 1), 4: ((25, 8), 64, 16, 8, 1, 1),
            8: ((50, 4), 128, 16, 16, 1, 1), 16: ((100, 2), 256, 16, 32, 1, 1),
            32: ((200, 1), 128, 16, 64, 1, 4),
            64: ((400, 1), 128, 16, 64, 1, 4)},
}


@pytest.mark.parametrize("accum", sorted(CONV9))
@pytest.mark.parametrize("batch", [1, 4, 8, 16, 32, 64])
def test_conv9_keeps_the_pr15_geometry(accum, batch):
    """The detector's conv9 stays above the decode threshold, its launch
    the PR-15 tile's as before."""
    g = geo.matmul_launch(100 * batch, 64, accum)
    assert 100 * batch > geo.DECODE_MAX_M
    assert (g.grid, g.threads, g.bm, g.bn, g.wm, g.wn) == CONV9[accum][batch]


@pytest.fixture
def recorded(monkeypatch):
    """Every matmul kernel's C entry replaced by a recorder (CPU tensors
    then take the launch path); the launch counts restored after."""
    calls = []
    kernels = (mm.POPCOUNT_KERNEL, mm.DECODE_KERNEL, mm.GROUPED_KERNEL,
               mm.INT_KERNEL)
    saved = [k.launches for k in kernels]
    for k in kernels:
        monkeypatch.setattr(k, "_fn", lambda *args, k=k: calls.append(
            (k.symbol, args)) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    yield calls
    for k, n in zip(kernels, saved):
        k.launches = n


@pytest.mark.parametrize("m,k", [(1, 1024), (4, 1024), (16, 800),
                                 (17, 1024), (400, 1024), (4, 300)])
def test_routes_by_shape(recorded, m, k):
    """M ≤ DECODE_MAX_M over K ≥ DECODE_MIN_K launches the decode entry
    with `decode_launch`'s geometry, counted as a share of the popcount
    entry's launches; other shapes the PR-15 entry with `matmul_launch`'s;
    the int matmul always `matmul_launch`'s."""
    n = 70
    a, w, div, bias = _operands(m, m, k, n)
    before = mm.POPCOUNT_KERNEL.launches, mm.DECODE_KERNEL.launches
    mm._launch(mm.POPCOUNT_KERNEL, a, w, None, div, bias, k, POPCOUNT)
    mm._launch_int(a, w, torch.zeros(n, dtype=torch.int32))
    (sym, args), (int_sym, int_args) = recorded
    decode = geo.decodes(m, k)
    assert mm.POPCOUNT_KERNEL.launches == before[0] + 1
    assert mm.DECODE_KERNEL.launches == before[1] + decode
    g = geo.matmul_launch(m, n, "popcount")
    pr15 = (*g.grid, g.bm, g.bn, g.wm, g.wn, g.threads)
    if decode:
        d = geo.decode_launch(m, k, n)
        assert sym == "w1a8_matmul_popcount_decode"
        assert args[10:17] == (d.blocks, d.threads, d.bm, d.bn, d.wm, d.wn,
                               d.cs)
    else:
        assert sym == "w1a8_matmul_popcount" and args[10:17] == pr15
    assert int_sym == "w1a8_matmul_int" and int_args[6:13] == pr15


@pytest.mark.parametrize("cap", [8, 16, 64])
def test_grouped_routes_by_cap(recorded, cap):
    """The grouped entry's launch: the decode tile at cap ≤ DECODE_MAX_M,
    the PR-15 tile above, a persistent grid either way."""
    e, k, n = 6, 1000, 70
    rng = np.random.default_rng(cap)
    a = torch.from_numpy(rng.integers(0, 256, (e, cap, k), dtype=np.uint8))
    w = torch.zeros((e, 32, n), dtype=torch.int32)
    mm._launch_grouped(a, w, torch.ones(e, dtype=torch.int32),
                       torch.ones((e, n)), torch.zeros((e, n)), k)
    ((sym, args),) = recorded
    g = geo.grouped_launch(e, cap, k, n)
    assert sym == "w1a8_matmul_popcount_grouped"
    assert args[10:18] == (int(g.decode), g.blocks, g.threads, g.bm, g.bn,
                           g.wm, g.wn, g.cs)
    assert g.decode == geo.decodes(cap, k) == (cap <= geo.DECODE_MAX_M)
    assert g.blocks <= max(geo.GROUPED_BLOCKS_PER_SM * geo.SMS,
                           geo.resident_blocks(g.wm, g.wn, g.threads, g.bn,
                                               e))


@pytest.mark.parametrize("m,k,n", [(4, 300, 70), (13, 256, 40),
                                   (16, 176, 33)])
@pytest.mark.parametrize("epilogue", ["sum", "f32", "codes"])
def test_decode_split_matches_pallas(m, k, n, epilogue):
    """At decode shapes (M ≤ 16), the decode route's decomposition and the
    port's wrapper against `w1a8_matmul_popcount_pallas` in interpret mode
    (a per-channel Mul_prev folded at the consumer, as the reference
    folds it). ``sum`` (bias ≡ 0) and ``codes`` bit for bit; ``f32``
    within one rounding of the product and one of the result, as
    `test_torch_kernels.py` holds the 2-D entry: the reference compiled on
    the CPU contracts acc·div + bias into one FMA, where its Pallas source
    and the port round the two separately."""
    rng = np.random.default_rng(m + k)
    a = rng.integers(0, 256, (m, k), dtype=np.uint8)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mul = rng.uniform(0.01, 0.1, k).astype(np.float32)
    div = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    if epilogue == "sum":
        bias = np.zeros_like(bias)
    jwp = jmm.w1a8_pack_weights(jnp.asarray(w))
    wp = mm.w1a8_pack_weights(torch.from_numpy(w))
    jcfg = JConfig(op="matmul", accum="popcount", interpret=True)
    cfg = POPCOUNT
    j = [jnp.asarray(x) for x in (a, mul, div, bias)]
    if epilogue == "codes":
        y = jmm.w1a8_matmul(j[0], jwp, *j[1:], k=k, config=jcfg)
        step = float(jnp.max(jnp.abs(y))) / 255.0
        jcfg, cfg = jcfg.replace(out_step=step), cfg.replace(out_step=step)
    want = np.asarray(jmm.w1a8_matmul(j[0], jwp, *j[1:], k=k, config=jcfg))
    t = [torch.from_numpy(x) for x in (a, mul, div, bias)]
    codes, div_f = mm.fold_operands(t[0], t[1], t[2])
    d = geo.decode_launch(m, k, n)
    split = ref.w1a8_matmul_popcount_split(codes, wp, k, div_f, t[3],
                                           cfg.out_step, slices=d.kw * d.cs)
    got = mm.w1a8_matmul(t[0], wp, t[1], t[2], t[3], k=k, config=cfg)
    assert torch.equal(split, got)
    got = got.numpy()
    if epilogue == "f32":
        prod = np.abs(want - bias).astype(np.float32)
        tol = np.spacing(prod) + np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= tol)
        assert (got == want).mean() > 0.5
    else:
        assert got.tobytes() == want.tobytes()


def test_grouped_split_matches_the_reference_einsum():
    """The grouped work list's integer sums (div 1, bias 0) against the
    reference's expert einsum on integer operands (exact in f32 below
    2^24), rows from each count on masked to 0."""
    e, cap, k, n = 5, 8, 200, 40
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (e, cap, k), dtype=np.uint8)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    counts = np.array([0, 8, 3, 11, -2], np.int32)
    wp = torch.stack([mm.w1a8_pack_weights(torch.from_numpy(x)) for x in w])
    signs = junpack(jnp.asarray(wp.numpy()), k, axis=-2, dtype=jnp.float32)
    want = np.asarray(jnp.einsum("etk,ekn->etn", jnp.asarray(a, jnp.float32),
                                 signs))
    want = np.where(np.arange(cap)[None, :, None]
                    < np.clip(counts, 0, cap)[:, None, None], want, 0.0)
    got = ref.w1a8_matmul_grouped_split(
        torch.from_numpy(a), wp, torch.from_numpy(counts), k,
        torch.ones((e, n)), torch.zeros((e, n)), unit=cap, bn=32, slices=2)
    np.testing.assert_array_equal(got.numpy(), want)
