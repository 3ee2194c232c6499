"""Port parity, kernel layer: the port's ops on CPU tensors (the plain
versions of the CUDA kernels) against the reference's Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances are the reference suite's own (tests/test_kernels.py): on the
dot path f32 within 6e-3·max|y| (both sides round the prologue to bf16,
then sum in f32 in different orders), uint8 codes within 1 LSB and ≥ 99%
identical. The popcount and int paths form exact integer sums and share
one f32 epilogue, so they are held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.config import KernelConfig as JConfig  # noqa: E402
from repro.kernels.w1a8_conv import ops as jconv  # noqa: E402
from repro.kernels.w1a8_matmul import kernel as jmmk  # noqa: E402
from repro.kernels.w1a8_matmul import ops as jmm  # noqa: E402
from repro_torch.kernels import config  # noqa: E402
from repro_torch.kernels.config import KernelConfig  # noqa: E402
from repro_torch.kernels.w1a8_conv import geometry  # noqa: E402
from repro_torch.kernels.w1a8_conv import ops as conv  # noqa: E402
from repro_torch.kernels.w1a8_matmul import geometry as mmgeo  # noqa: E402
from repro_torch.kernels.w1a8_matmul import ops as mm  # noqa: E402
from repro_torch.kernels.w1a8_matmul import ref as mmref  # noqa: E402


def _operands(seed, a_shape, k, cin, cout):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, a_shape, dtype=np.uint8)
    w = rng.standard_normal((k, cout)).astype(np.float32)
    mul = rng.uniform(0.01, 0.1, cin).astype(np.float32)
    div = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return a, w, mul, div, bias


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _assert_f32_close(got, want):
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-3 * scale)


def _assert_codes_close(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


@pytest.mark.parametrize("m,k,n", [(16, 144, 32), (33, 200, 64)])
def test_matmul_plain_matches_pallas(m, k, n):
    a, w, mul, div, bias = _operands(m, (m, k), k, k, n)
    jwp = jmm.w1a8_pack_weights(jnp.asarray(w))
    wp = mm.w1a8_pack_weights(torch.from_numpy(w))
    assert np.array_equal(wp.numpy().view(np.uint32), np.asarray(jwp))
    jcfg = JConfig(op="matmul", interpret=True)
    want = np.asarray(jmm.w1a8_matmul(*_j(a), jwp, *_j(mul, div, bias), k=k,
                                      config=jcfg))
    got = mm.w1a8_matmul(*_t(a), wp, *_t(mul, div, bias), k=k).numpy()
    _assert_f32_close(got, want)
    step = float(np.abs(want).max()) / 255.0
    want_q = np.asarray(jmm.w1a8_matmul(*_j(a), jwp, *_j(mul, div, bias), k=k,
                                        config=jcfg.replace(out_step=step)))
    got_q = mm.w1a8_matmul(*_t(a), wp, *_t(mul, div, bias), k=k,
                           config=KernelConfig(op="matmul", out_step=step))
    assert got_q.dtype == torch.uint8
    _assert_codes_close(got_q.numpy(), want_q)


CONV_SHAPES = [(1, 8, 8, 16, 32), (2, 16, 16, 32, 64), (2, 8, 8, 16, 64)]


@pytest.mark.parametrize("b,h,w,cin,cout", CONV_SHAPES)
def test_conv3x3_plain_matches_pallas(b, h, w, cin, cout):
    a, wt, mul, div, bias = _operands(h * cin, (b, h, w, cin), 9 * cin, cin,
                                      cout)
    wt = wt.reshape(3, 3, cin, cout)
    jwp = jconv.conv_pack_weights(jnp.asarray(wt))
    wp = conv.conv_pack_weights(torch.from_numpy(wt))
    assert np.array_equal(wp.numpy().view(np.uint32), np.asarray(jwp))
    jcfg = JConfig(op="conv3x3", interpret=True)
    want = np.asarray(jconv.w1a8_conv3x3(*_j(a), jwp, *_j(mul, div, bias),
                                         cin=cin, config=jcfg))
    got = conv.w1a8_conv3x3(*_t(a), wp, *_t(mul, div, bias), cin=cin).numpy()
    _assert_f32_close(got, want)
    step = float(np.abs(want).max()) / 255.0
    want_q = np.asarray(jconv.w1a8_conv3x3(
        *_j(a), jwp, *_j(mul, div, bias), cin=cin,
        config=jcfg.replace(out_step=step)))
    got_q = conv.w1a8_conv3x3(*_t(a), wp, *_t(mul, div, bias), cin=cin,
                              config=KernelConfig(op="conv3x3",
                                                  out_step=step))
    _assert_codes_close(got_q.numpy(), want_q)


@pytest.mark.parametrize("b,h,w,cin,cout", CONV_SHAPES)
def test_conv3x3_pool_plain_matches_pallas(b, h, w, cin, cout):
    a, wt, mul, div, bias = _operands(h * cout, (b, h, w, cin), 9 * cin, cin,
                                      cout)
    wt = wt.reshape(3, 3, cin, cout)
    wp = conv.conv_pack_weights(torch.from_numpy(wt))
    y = conv.w1a8_conv3x3(*_t(a), wp, *_t(mul, div, bias), cin=cin)
    step = float(y.abs().max()) / 255.0
    jcfg = JConfig(op="conv3x3_pool", interpret=True, fused=True,
                   out_step=step)
    want = np.asarray(jconv.w1a8_conv3x3_pool(
        *_j(a), jconv.conv_pack_weights(jnp.asarray(wt)),
        *_j(mul, div, bias), cin=cin, config=jcfg))
    cfg = KernelConfig(op="conv3x3_pool", out_step=step)
    fused = conv.w1a8_conv3x3_pool(*_t(a), wp, *_t(mul, div, bias), cin=cin,
                                   config=cfg)
    unfused = conv.w1a8_conv3x3_pool(*_t(a), wp, *_t(mul, div, bias),
                                     cin=cin, config=cfg.replace(fused=False))
    assert fused.shape == (b, h // 2, w // 2, cout)
    assert fused.dtype == torch.uint8
    assert torch.equal(fused, unfused)
    rows2 = conv.w1a8_conv3x3_pool(*_t(a), wp, *_t(mul, div, bias), cin=cin,
                                   config=cfg.replace(rows=2))
    assert torch.equal(rows2, fused)
    _assert_codes_close(fused.numpy(), want)


# The dot conv kernels' launch geometry (kernels/w1a8_conv/geometry.py) at
# every 3×3 layer shape of the 320×320 detector with B = 4, at one shape off
# its grid (Cin % 16 != 0, Cout % 32 != 0) and at CONV_SHAPES.
DETECTOR_CONV_SHAPES = [(4, 160, 160, 16, 32), (4, 80, 80, 32, 64),
                        (4, 40, 40, 64, 128), (4, 20, 20, 128, 128),
                        (4, 10, 10, 128, 128), (4, 10, 10, 64, 64)]
OFF_GRID_SHAPE = (2, 18, 18, 24, 40)


def _covered(g, h_out, w_out, cout, pool):
    """How often the kernel's blocks and warp items store each output of
    one image, walked as the kernel walks them: block (bx, by) holds
    channels [bx·bn, (bx+1)·bn) and rows [by·rows, ...) (the last block
    fewer); its M rows run row-major over those outputs, four per pooled
    pixel when pooling, and warp item i takes M tiles [wm·(i % m_items),
    ...) of channels 8·wn·(i // m_items) on."""
    count = np.zeros((h_out, w_out, cout), np.int64)
    cols = 8 * g.wn
    for by in range(g.grid[1]):
        n_rows = min(g.rows, h_out - by * g.rows)
        assert n_rows >= 1
        m_blk = n_rows * g.m_row
        m_items = -(-(-(-m_blk // 16)) // g.wm)
        for bx in range(g.grid[0]):
            for item in range(m_items * g.bn // cols):
                m0 = (item % m_items) * g.wm * 16
                c0 = bx * g.bn + (item // m_items) * cols
                i = np.arange(m0, min(m0 + g.wm * 16, m_blk))
                if pool:
                    i = i[i % 4 == 0] // 4
                rows = by * g.rows + i // w_out
                count[rows, i % w_out, c0:min(c0 + cols, cout)] += 1
    return count


@pytest.mark.parametrize("b,h,w,cin,cout",
                         DETECTOR_CONV_SHAPES + [OFF_GRID_SHAPE]
                         + CONV_SHAPES)
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("accum", ["dot", "popcount"])
def test_conv_launch_geometry_covers_outputs_once(b, h, w, cin, cout, pool,
                                                  accum):
    """Every output stored exactly once, at rows 1, 2 and 3 (a ragged last
    block where 3 does not divide the rows); the dynamic shared memory
    within a block's 227 KB; the staging inside it, each staged pixel an
    odd number of 16-byte units (conflict-free ldmatrix rows)."""
    h_out, w_out = (h // 2, w // 2) if pool else (h, w)
    units = -(-cin // 16)
    if accum == "dot":
        pixel, words, offsets = 32 * units + 16, -(-9 * cin // 32) + 1, 0
    else:   # pair words, then the window's unit offsets
        pairs = -(-9 * units // 2)
        pixel, words, offsets = 16 * (units | 1), pairs + 1, 4 * 2 * pairs
    for rows in (1, 2, 3):
        g = geometry.conv_launch(b, h, w, cin, cout, rows, pool, accum)
        assert g.grid[2] == b
        assert g.threads % 32 == 0 and 32 <= g.threads <= 256
        assert g.bn % geometry.BN_STEP == 0 and g.wm in (1, 2) and g.wn in (1, 2, 4)
        assert g.row_px >= w + 2
        assert g.staged_rows == (2 * g.rows + 2 if pool else g.rows + 2)
        assert geometry.pixel_bytes(cin, accum) == pixel and (pixel // 16) % 2
        staging = g.staged_rows * g.row_px * pixel
        assert (4 * words * g.bn + offsets + staging <= g.smem
                <= geometry.MAX_SMEM)
        assert (_covered(g, h_out, w_out, cout, pool) == 1).all()


@pytest.mark.parametrize("accum", ["dot", "popcount"])
def test_conv_launch_geometry_refuses_too_much_shared_memory(accum):
    with pytest.raises(ValueError, match="shared memory"):
        geometry.conv_launch(1, 160, 160, 128, 128, 160, pool=False,
                             accum=accum)


# The matmul kernels' launch geometry (kernels/w1a8_matmul/geometry.py),
# for each route, at the detector's conv9 (M = B·100, N = 64) for the
# launcher's batches B = 1 .. 64, at the three shapes off its grid that
# chip_smoke.py holds the kernels at (ragged M and N), at a wider N and at
# one row or column.
MATMUL_GEOMETRY_SHAPES = [(100 * b, 64) for b in (1, 2, 4, 8, 16, 32, 64)] + [
    (5, 12), (33, 64), (40, 40), (6400, 128), (1, 64), (400, 1)]


@pytest.mark.parametrize("m,n", MATMUL_GEOMETRY_SHAPES)
@pytest.mark.parametrize("accum", ["dot", "popcount"])
def test_matmul_launch_geometry_covers_outputs_once(m, n, accum):
    """Every (row, column) stored exactly once, walked as the kernels walk
    it: block (bx, by) holds rows [bx·bm, ...) and columns [by·bn, ...),
    its warp w columns 8·wn·(w // 2) on, the two warps of an item sharing
    its columns; no block holds nothing. The kernels keep only the partial
    sums in shared memory, within their static 16 KB."""
    g = mmgeo.matmul_launch(m, n, accum)
    warps = g.threads // 32
    split = mmgeo.K_SPLIT
    assert split == 2 and g.threads % (32 * split) == 0
    assert 1 <= warps <= mmgeo.MAX_WARPS
    assert (g.wm, g.wn) in mmgeo.WARP_TILES[accum]
    assert g.bm == 16 * g.wm and g.bn == 8 * g.wn * warps // split
    assert 256 * g.wm * g.wn * 4 * 4 <= 16 * 1024
    assert (g.grid[0] - 1) * g.bm < m <= g.grid[0] * g.bm
    assert (g.grid[1] - 1) * g.bn < n <= g.grid[1] * g.bn
    count = np.zeros((m, n), np.int64)
    for bx in range(g.grid[0]):
        rows = slice(bx * g.bm, min((bx + 1) * g.bm, m))
        for by in range(g.grid[1]):
            for w in range(0, warps, split):
                c0 = by * g.bn + 8 * g.wn * (w // split)
                count[rows, c0:min(c0 + 8 * g.wn, n)] += 1
    assert (count == 1).all()


# conv9 (K = 128, N = 64) at the launcher's batch B: the warp tile that
# launch/tile_sweep.py measured fastest, or within 10% of it, on an H100
# (PERF.md, PR 15).
@pytest.mark.parametrize("accum,batch,tile", [
    ("dot", 4, (1, 1)), ("dot", 8, (1, 1)), ("dot", 16, (1, 1)),
    ("dot", 32, (1, 4)), ("dot", 64, (1, 4)), ("popcount", 4, (1, 1)),
    ("popcount", 16, (1, 1)), ("popcount", 64, (1, 1))])
def test_matmul_launch_picks_the_measured_tile(accum, batch, tile):
    g = mmgeo.matmul_launch(100 * batch, 64, accum)
    assert (g.wm, g.wn) == tile


def test_matmul_launch_geometry_refuses_an_empty_matmul():
    with pytest.raises(ValueError, match="bad matmul shape"):
        mmgeo.matmul_launch(0, 64, "dot")


# ---------------------------------------------------------------------------
# Binary domain (popcount) and the exact int path: bit-exact, as the
# reference's integer sums are.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,kp,n", [(7, 64, 33), (40, 160, 64)])
def test_xnor_accumulate_bit_exact(m, kp, n):
    """SWAR popcount on int32-held words, bit 31 set in many, against the
    reference's `_xnor_accumulate` (uint32 words, lax.population_count)."""
    rng = np.random.default_rng(kp + n)
    a = rng.integers(0, 256, (m, kp), dtype=np.uint8)
    words = rng.integers(0, 2 ** 32, (kp // 32, n), dtype=np.uint64) \
        .astype(np.uint32)
    words[0, 0] = 0xFFFFFFFF
    words[-1, -1] = 0x80000000
    assert (words >= 2 ** 31).mean() > 0.3
    want = np.asarray(jmmk._xnor_accumulate(
        jnp.asarray(a).astype(jnp.uint32), jnp.asarray(words), kp))
    got = mmref.xnor_accumulate(torch.from_numpy(a),
                                torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    for bit in (0, 7):
        plane = mmref.pack_act_bitplane(torch.from_numpy(a), bit).numpy()
        jplane = np.asarray(jmmk._pack_act_bitplane(
            jnp.asarray(a).astype(jnp.uint32), bit, kp))
        assert np.array_equal(plane.astype(np.uint32), jplane)


def _assert_epilogue_match(got, want, epilogue, bias):
    """``sum`` (bias ≡ 0) and ``codes`` bit for bit. ``f32`` within one
    rounding of the product and one of the result: the reference compiled
    on the CPU contracts ``acc·div + bias`` into one FMA, where its Pallas
    source, the port and its CUDA kernels round the product and the sum
    separately. With bias ≡ 0 the two agree exactly."""
    if epilogue == "f32":
        prod = np.abs(want - bias).astype(np.float32)      # ≈ acc·div
        tol = np.spacing(prod) + np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= tol)
        assert (got == want).mean() > 0.5
    else:
        assert got.tobytes() == want.tobytes()


EPILOGUES = ["sum", "f32", "codes"]


@pytest.mark.parametrize("m,k,n", [(5, 70, 12), (33, 200, 64),
                                   (100, 128, 64)])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_popcount_matmul_matches_pallas(m, k, n, epilogue):
    """Ragged M, N and K, a per-channel Mul_prev folded at the consumer,
    against the reference's popcount matmul."""
    a, w, mul, div, bias = _operands(m + k, (m, k), k, k, n)
    if epilogue == "sum":
        bias = np.zeros_like(bias)
    jwp = jmm.w1a8_pack_weights(jnp.asarray(w))
    wp = mm.w1a8_pack_weights(torch.from_numpy(w))
    jcfg = JConfig(op="matmul", accum="popcount", interpret=True)
    cfg = KernelConfig(op="matmul", accum="popcount")
    if epilogue == "codes":
        y = jmm.w1a8_matmul(*_j(a), jwp, *_j(mul, div, bias), k=k,
                            config=jcfg)
        step = float(jnp.max(jnp.abs(y))) / 255.0
        jcfg, cfg = jcfg.replace(out_step=step), cfg.replace(out_step=step)
    want = np.asarray(jmm.w1a8_matmul(*_j(a), jwp, *_j(mul, div, bias), k=k,
                                      config=jcfg))
    got = mm.w1a8_matmul(*_t(a), wp, *_t(mul, div, bias), k=k, config=cfg)
    assert got.dtype == (torch.uint8 if epilogue == "codes"
                         else torch.float32)
    _assert_epilogue_match(got.numpy(), want, epilogue, bias)


@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (256, 512, 256),
                                   (32, 1024, 128)])
def test_int_matmul_matches_pallas(m, k, n):
    """`w1a8_matmul_int` against `w1a8_matmul_int_pallas`, at the shapes of
    the reference's own test, and against the integer product."""
    rng = np.random.default_rng(k)
    a = rng.integers(0, 256, (m, k), dtype=np.uint8)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jwp = jmm.w1a8_pack_weights(jnp.asarray(w))
    signs = np.where(w >= 0, 1, -1).astype(np.int32)
    colsum = signs.sum(axis=0, dtype=np.int32)
    want = np.asarray(jmmk.w1a8_matmul_int_pallas(
        jnp.asarray(a), jwp, jnp.asarray(colsum.reshape(1, n)),
        bm=max(8, min(m, 256)), bk=min(k, 512), bn=min(n, 256),
        interpret=True))
    got = mm.w1a8_matmul_int(torch.from_numpy(a),
                             mm.w1a8_pack_weights(torch.from_numpy(w)),
                             torch.from_numpy(colsum))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, a.astype(np.int64) @ signs)


# cin = 16 gives K9 = 144: the last sign word holds 16 lanes against pad bits
POPCOUNT_CONV_SHAPES = [(1, 8, 8, 16, 32), (2, 6, 10, 24, 40),
                        (1, 4, 4, 64, 75)]


@pytest.mark.parametrize("b,h,w,cin,cout", POPCOUNT_CONV_SHAPES)
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_popcount_conv_matches_pallas(b, h, w, cin, cout, epilogue):
    """Popcount conv, and for codes conv+pool fused and unfused, on a
    per-channel Mul_prev, against the reference's popcount conv."""
    a, wt, mul, div, bias = _operands(cin * cout, (b, h, w, cin), 9 * cin,
                                      cin, cout)
    if epilogue == "sum":
        bias = np.zeros_like(bias)
    wt = wt.reshape(3, 3, cin, cout)
    jwp = jconv.conv_pack_weights(jnp.asarray(wt))
    wp = conv.conv_pack_weights(torch.from_numpy(wt))
    jcfg = JConfig(op="conv3x3", accum="popcount", interpret=True)
    cfg = KernelConfig(op="conv3x3", accum="popcount")
    want = np.asarray(jconv.w1a8_conv3x3(*_j(a), jwp, *_j(mul, div, bias),
                                         cin=cin, config=jcfg))
    if epilogue != "codes":
        got = conv.w1a8_conv3x3(*_t(a), wp, *_t(mul, div, bias), cin=cin,
                                config=cfg)
        _assert_epilogue_match(got.numpy(), want, epilogue, bias)
        return
    step = float(np.abs(want).max()) / 255.0
    want_q = np.asarray(jconv.w1a8_conv3x3(
        *_j(a), jwp, *_j(mul, div, bias), cin=cin,
        config=jcfg.replace(out_step=step)))
    got_q = conv.w1a8_conv3x3(*_t(a), wp, *_t(mul, div, bias), cin=cin,
                              config=cfg.replace(out_step=step))
    assert np.array_equal(got_q.numpy(), want_q)
    pcfg = KernelConfig(op="conv3x3_pool", accum="popcount", out_step=step)
    want_p = np.asarray(jconv.w1a8_conv3x3_pool(
        *_j(a), jwp, *_j(mul, div, bias), cin=cin,
        config=JConfig(op="conv3x3_pool", accum="popcount", out_step=step,
                       fused=True, interpret=True)))
    for fused in (True, False):
        got_p = conv.w1a8_conv3x3_pool(*_t(a), wp, *_t(mul, div, bias),
                                       cin=cin,
                                       config=pcfg.replace(fused=fused))
        assert np.array_equal(got_p.numpy(), want_p), fused
    rows = conv.w1a8_conv3x3_pool(*_t(a), wp, *_t(mul, div, bias), cin=cin,
                                  config=pcfg.replace(rows=h // 2))
    assert np.array_equal(rows.numpy(), want_p)


@pytest.mark.parametrize("b,h,w,cin,cout", POPCOUNT_CONV_SHAPES)
def test_popcount_bit_exact_vs_dot(b, h, w, cin, cout):
    """The port's popcount against its own dot path under canonical
    operands (mul ≡ 1, div·m0): the dot path's bf16 operands are then exact
    integers and both run one f32 epilogue, so they agree bit for bit."""
    a, wt, _, div, bias = _operands(b + cin, (b, h, w, cin), 9 * cin, cin,
                                    cout)
    wp = conv.conv_pack_weights(torch.from_numpy(wt.reshape(3, 3, cin, cout)))
    a, div, bias = _t(a, div, bias)
    m0 = 0.05
    mul, ones = torch.full((cin,), m0), torch.ones(cin)
    pc = KernelConfig(op="conv3x3", accum="popcount")
    assert torch.equal(conv.w1a8_conv3x3(a, wp, mul, div, bias, cin=cin,
                                         config=pc),
                       conv.w1a8_conv3x3(a, wp, ones, div * m0, bias,
                                         cin=cin))
    step = 2.0
    for op, fn in (("conv3x3", conv.w1a8_conv3x3),
                   ("conv3x3_pool", conv.w1a8_conv3x3_pool)):
        cfg = KernelConfig(op=op, accum="popcount", out_step=step)
        assert torch.equal(
            fn(a, wp, mul, div, bias, cin=cin, config=cfg),
            fn(a, wp, ones, div * m0, bias, cin=cin,
               config=cfg.replace(accum="dot"))), op
    m, k, n = b * h * w, 9 * cin, cout
    a2 = a.reshape(m, cin)[:, :min(cin, k)]
    wpm = mm.w1a8_pack_weights(torch.from_numpy(wt[:cin]))
    mcfg = KernelConfig(op="matmul", accum="popcount")
    assert torch.equal(
        mm.w1a8_matmul(a2, wpm, mul, div, bias, k=cin, config=mcfg),
        mm.w1a8_matmul(a2, wpm, ones, div * m0, bias, k=cin))


def test_config_resolution_without_table():
    """An empty table: "tuned" resolves dot, fused, rows=1 (the heuristic)
    everywhere. With a table, its exact cell wins, another shape of the
    same op, accum and device takes the nearest entry (the reference's
    fallback), and a cell with no entry of its kind takes the heuristic."""
    cfg = config.resolve_tuned("conv3x3_pool", (160, 160, 16, 32),
                               table={}, device="h100")
    assert cfg == KernelConfig(op="conv3x3_pool", accum="dot", fused=True,
                               rows=1)
    assert cfg.source == "heuristic"
    table = {config.shape_key("conv3x3", (20, 20, 128, 128), "dot", "h100"):
             {"config": {"op": "conv3x3", "rows": 4}, "t_us": 1.0}}
    exact = config.resolve("conv3x3", (20, 20, 128, 128), table=table,
                           device="h100")
    other = config.resolve("conv3x3", (10, 10, 128, 128), table=table,
                           device="h100")
    assert (exact.rows, other.rows) == (4, 4)
    assert (exact.source, other.source) == ("table", "nearest")
    for op, accum, dev in (("conv3x3", "popcount", "h100"),
                           ("conv3x3_pool", "dot", "h100"),
                           ("conv3x3", "dot", "a100")):
        none = config.resolve(op, (10, 10, 128, 128), accum=accum,
                              table=table, device=dev)
        assert (none.rows, none.source) == (1, "heuristic")
    g = geometry.conv_launch(4, 10, 10, 128, 128, other.rows, False)
    assert (g.rows, g.grid[1]) == (4, 3)    # a ragged last block of 2 rows
    assert config.resolve_tuned("conv3x3", (20, 20, 128, 128), table=table,
                                device="h100") == exact
    with pytest.raises(ValueError):
        KernelConfig(op="conv3x3", rows=0)
