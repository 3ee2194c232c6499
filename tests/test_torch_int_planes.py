"""Port parity, the integer PE's signed digit planes
(`kernels/w1a8_int/planes.py`): the digits reconstruct every int64 W'
modulo 2^64; the kernel's arithmetic emulated in torch (per-plane int32
sums, a wrapping int64 combine) equals the reference's numpy int64 sums
layer by layer, on the overflow, wrapping and negative-tie entries; the
K bound; the planes `fold_int_pe` builds through both artifact sources;
and the launch geometry of every layer and plane count."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import yolo as jyolo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.w1a8_conv.geometry import MAX_SMEM  # noqa: E402
from repro_torch.kernels.w1a8_int import geometry  # noqa: E402
from repro_torch.kernels.w1a8_int import planes as pl  # noqa: E402
from repro_torch.models import yolo  # noqa: E402

INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1
# (bucket, batch): tests/test_torch_int.py's cheap sizes
SIZES = ((64, 2), (32, 1))


def _wrap(v: int) -> int:
    """A Python int as the int64 it wraps to."""
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


@settings(deadline=None, max_examples=200)
@given(st.lists(st.integers(INT64_MIN, INT64_MAX), min_size=1, max_size=8))
@example([0])
@example([1, -1])
@example([1 << 62, -(1 << 62)])
@example([INT64_MIN])
@example([INT64_MAX, INT64_MIN, 0])
@example([(1 << 40) - 1, 1 << 40, -(1 << 40)])
def test_digits_reconstruct_int64(values):
    w = torch.tensor(values, dtype=torch.int64)
    d = pl.digit_planes(w)
    p = pl.plane_count(w)
    assert d.dtype == torch.int8 and d.shape == (p, len(values))
    assert int(d.to(torch.int64).abs().max()) <= pl.DIGIT_MAX
    assert torch.equal(pl.combine(list(d)), w)
    # the fewest planes: one fewer cannot hold the largest magnitude
    top = max(abs(v) for v in values)
    assert p == max(1, -(-top.bit_length() // pl.RADIX_BITS))
    assert 1 <= p <= pl.MAX_PLANES
    # ... and the top plane is not all zero
    assert p == 1 or bool(d[-1].ne(0).any())
    # each digit is sign(w) times a radix-128 digit of |w|, Python ints
    for i, v in enumerate(values):
        mag = abs(v)
        for j in range(p):
            want = (1 if v >= 0 else -1) * ((mag >> (7 * j)) & 127)
            assert int(d[j, i]) == want


def _unpack_sign_planes(sign_planes, signs, cin, ksize):
    """(P, K, N) digits of a W1A8 layer's W' from the kernel's layout: the
    per-channel digits of m_raw times the ±1 signs."""
    mdig = sign_planes[:, :cin].to(torch.int64).repeat(1, ksize * ksize)
    return mdig[:, :, None] * signs.to(torch.int64)[None]


def _unpack_dense_planes(dense, cin, ksize):
    """(P, K, N) digits from the kernel's (P, units, N, 16) layout."""
    p, _, n, unit = dense.shape
    d = dense.reshape(p, ksize * ksize, -1, n, unit).permute(0, 1, 2, 4, 3)
    return d.reshape(p, ksize * ksize, -1, n)[:, :, :cin].reshape(p, -1, n) \
        .to(torch.int64)


def _layer_digits(entry):
    """(P, K, N) digits of the layer's W' from the planes `fold_int_pe`
    stored in the kernel's layout."""
    spec = entry["spec"]
    if spec.name in ("conv1", "conv11"):
        return _unpack_dense_planes(entry["planes"], spec.cin, spec.ksize)
    return _unpack_sign_planes(entry["planes"], entry["signs"], spec.cin,
                               spec.ksize)


def _reference(bucket, batch, per_channel):
    rng = np.random.default_rng(bucket + batch)
    img_u8 = rng.integers(0, 256, (batch, bucket, bucket, 3), dtype=np.uint8)
    init = jyolo.init_yolo_params(jax.random.PRNGKey(42))
    params = jyolo.calibrate_yolo(init, jnp.asarray(img_u8 / 256.0,
                                                    jnp.float32),
                                  per_channel=per_channel)
    return img_u8, params, jyolo.deploy_yolo(params)


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bucket,batch", SIZES)
def test_plane_sums_equal_reference_layers(bucket, batch, per_channel):
    """Every layer's accumulator, the reference's `_im2col_np` sum in numpy
    int64, equals the kernel's arithmetic on the planes `fold_int_pe`
    stored: int32 sums per plane, combined in wrapping int64."""
    img_u8, _, art_np = _reference(bucket, batch, per_channel)
    art = convert.int_artifact_from_numpy(art_np, device="cpu")
    x = img_u8.astype(np.int64)
    for entry_np, entry in zip(art_np["layers"], art["layers"]):
        spec = entry_np["spec"]
        cols = jyolo._im2col_np(x, spec.ksize)
        if spec.name == "conv1":
            acc = cols @ entry_np["w_raw"].reshape(-1, spec.cout)
        else:
            m9 = np.tile(entry_np["m_raw"], spec.ksize ** 2)
            w = (entry_np["w_raw"].reshape(-1, spec.cout)
                 if spec.name == "conv11" else entry_np["signs"])
            acc = (cols * m9) @ w
        digits = _layer_digits(entry)
        assert 1 <= digits.shape[0] <= 3, spec.name
        sums = pl.plane_sums(torch.from_numpy(x.astype(np.uint8)), digits,
                             spec.ksize)
        assert all(s.dtype == torch.int32 for s in sums)
        assert np.array_equal(pl.combine(sums).numpy(), acc), spec.name
        if spec.name == "conv11":
            break
        # the next layer's input: the reference's own epilogue and pool
        if spec.name == "conv1":
            q = jyolo._rshift_round(
                np.maximum(acc + (entry_np["b_raw"] << 5), 0)
                * entry_np["post_mult"], entry_np["post_shift"])
        else:
            q = jyolo._rshift_round(acc * entry_np["post_mult"]
                                    + entry_np["b_pre"],
                                    entry_np["post_shift"])
        x = np.clip(q, 0, 255)
        if spec.pool:
            b, h, w_, c = x.shape
            x = x.reshape(b, h // 2, 2, w_ // 2, 2, c).max(axis=(2, 4))


def _hard_entry(kind, rng):
    """(codes, m_raw, weights, ksize, planes): the overflow operands
    (m_raw ≈ 2^17, every sign +1, codes 255), a W1A8 layer whose numpy
    int64 sum wraps (m_raw near 2^60), the head on negative ties (m_raw =
    2^15, ±1 weights)."""
    if kind == "overflow":
        x = np.full((1, 6, 6, 128), 255, np.uint8)
        m = (1 << 17) - rng.integers(0, 64, 128)
        return x, m, np.ones((9 * 128, 128), np.int64), 3, 3
    if kind == "wrapping":
        x = rng.integers(0, 256, (1, 6, 6, 48), dtype=np.uint8)
        m = (1 << 60) - rng.integers(0, 1 << 20, 48)
        return x, m, rng.choice([-1, 1], (9 * 48, 40)), 3, 9
    x = rng.integers(0, 256, (2, 4, 4, 64), dtype=np.uint8)
    return (x, np.full(64, 1 << 15, np.int64),
            rng.choice([-1, 1], (64, 75)), 1, 3)


@pytest.mark.parametrize("kind", ["overflow", "wrapping", "head_ties"])
def test_emulation_on_hard_entries(kind):
    rng = np.random.default_rng(5)
    x, m, w, ksize, planes = _hard_entry(kind, rng)
    cols = jyolo._im2col_np(x.astype(np.int64), ksize)
    m9 = np.tile(m.astype(np.int64), ksize * ksize)
    with np.errstate(over="ignore"):
        acc = (cols * m9) @ w.astype(np.int64)     # numpy's wrapped sum
    w_eff = (m9[:, None] * w).astype(np.int64)
    assert pl.plane_count(torch.from_numpy(w_eff)) == planes
    got = pl.emulate(torch.from_numpy(x), torch.from_numpy(w_eff), ksize)
    assert np.array_equal(got.numpy(), acc)
    exact = (cols.astype(np.float64) * m9) @ w
    if kind == "overflow":
        assert np.abs(acc).max() > 3e10
    elif kind == "wrapping":
        assert np.abs(exact).max() > 2.0 ** 63      # numpy's sum wrapped
        assert not np.allclose(acc, exact)
    else:
        ties = (np.abs(acc) % (1 << 16)) == (1 << 15)
        assert ties[acc < 0].any()
        bias = rng.integers(-400, 400, 75)
        want = jyolo._rshift_round(acc, 16) + bias
        raw = yolo._rshift_round(got, 16) + torch.from_numpy(bias)
        assert np.array_equal(raw.numpy(), want)
        assert (want < 0).any()


def test_wrap_matches_python_ints():
    """The combine wraps modulo 2^64 as Python ints say: W' = INT64_MIN
    and W' near INT64_MAX times codes up to 255."""
    x = torch.tensor([[[[255, 3, 1]]]], dtype=torch.uint8)
    w = torch.tensor([[INT64_MIN, INT64_MAX], [INT64_MAX, 5], [-7, INT64_MIN]],
                     dtype=torch.int64)
    got = pl.emulate(x, w, 1).reshape(-1).tolist()
    xs = [255, 3, 1]
    want = [_wrap(sum(a * int(w[k, n]) for k, a in enumerate(xs)))
            for n in range(2)]
    assert got == want


@pytest.mark.parametrize("k,ok", [(pl.K_MAX, True), (pl.K_MAX + 1, False),
                                  (1152, True)])
def test_k_bound(k, ok):
    assert 255 * pl.DIGIT_MAX * pl.K_MAX < 2 ** 31 <= 255 * pl.DIGIT_MAX * (
        pl.K_MAX + 1)
    if ok:
        pl.check_k(k)
    else:
        with pytest.raises(ValueError, match="2\\^31"):
            pl.check_k(k)
        x = torch.zeros((1, 1, 1, k), dtype=torch.uint8)
        with pytest.raises(ValueError, match="2\\^31"):
            pl.emulate(x, torch.ones((k, 1), dtype=torch.int64), 1)


@pytest.mark.parametrize("per_channel", [True, False])
def test_fold_int_pe_same_through_deploy_and_convert(per_channel):
    """`deploy_yolo` of the port's params and `int_artifact_from_numpy` of
    the reference's artifact store the same planes, in the kernel's layout,
    and they reconstruct each layer's W'."""
    _, params, art_np = _reference(32, 1, per_channel)
    params_np = {n: {k: np.asarray(v) for k, v in p.items()}
                 for n, p in params.items()}
    dep = yolo.deploy_yolo(convert.params_from_numpy(params_np,
                                                     device="cpu"))
    conv = convert.int_artifact_from_numpy(art_np, device="cpu")
    counts = []
    for a, b in zip(dep["layers"], conv["layers"]):
        spec = a["spec"]
        assert a["planes"].dtype == torch.int8
        assert torch.equal(a["planes"], b["planes"]), spec.name
        if spec.name == "conv1":
            w_eff = a["w_raw"].reshape(-1, spec.cout)
        elif spec.name == "conv11":
            w_eff = pl.head_weights(a["m_raw"],
                                    a["w_raw"].reshape(-1, spec.cout))
        else:
            w_eff = pl.w1a8_weights(a["m_raw"], a["signs"], spec.ksize)
        assert torch.equal(pl.combine(list(_layer_digits(a))), w_eff)
        assert a["planes"].shape[0] == pl.plane_count(w_eff)
        counts.append(a["planes"].shape[0])
    assert all(1 <= p <= 3 for p in counts), counts


def _shapes():
    sizes = yolo.spatial_sizes(320)
    for i, spec in enumerate(yolo.YOLO_LAYERS):
        kind = (geometry.CONV1 if spec.name == "conv1" else geometry.HEAD
                if spec.name == "conv11" else geometry.W1A8)
        h = sizes[spec.name]
        yield (kind, 4, h, spec.cin, spec.cout, spec.ksize, spec.pool)
    for cin, cout in ((3, 16), (16, 20), (24, 40), (48, 33), (128, 75)):
        yield (geometry.W1A8, 2, 18, cin, cout, 3, True)
        yield (geometry.W1A8, 2, 18, cin, cout, 1, False)
        yield (geometry.CONV1, 2, 18, cin, cout, 3, False)
        yield (geometry.HEAD, 2, 18, cin, cout, 1, False)


@pytest.mark.parametrize("planes", [1, 3, pl.MAX_PLANES])
def test_pe_launch_covers_output(planes):
    """Every layer shape and the off-grid ones: the grid covers the output
    exactly, the warp tile is one the kernel builds, the block's N is a
    multiple of its N tiles, and its shared memory holds the staging."""
    for kind, b, h, cin, cout, ks, pool in _shapes():
        g = geometry.pe_launch(kind, b, h, h, cin, cout, ks, pool, planes)
        h_out = h // 2 if pool else h
        assert (g.wm, g.wn) in geometry.WARP_TILES
        assert g.bn % (8 * g.wn) == 0 and g.bn >= 8 * g.wn
        assert g.grid[0] * g.bn >= cout > (g.grid[0] - 1) * g.bn
        assert g.grid[1] * g.rows >= h_out > (g.grid[1] - 1) * g.rows
        assert g.grid[2] == b and g.row_px >= h + 2
        assert 32 <= g.threads <= 256 and g.threads % 32 == 0
        staged = (2 * g.rows if pool else g.rows) + ks - 1
        assert g.smem == geometry.pe_smem(kind, ks, cin, g.bn, planes,
                                          staged, g.row_px) <= MAX_SMEM
