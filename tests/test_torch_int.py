"""Port parity, integer golden datapath: the port's `deploy_yolo`, its
integer PE wrappers (plain versions on the CPU) and `yolo_forward_int`
against the reference's numpy int64 pipeline, bit for bit, on inputs made
from a numpy seed; the fixed-point helpers against Python ints; the packed
layer files across the two packages byte for byte."""
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfxp  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.models import yolo as jyolo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fixedpoint as fxp  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.w1a8_int import ops as int_ops  # noqa: E402
from repro_torch.models import yolo  # noqa: E402

INT_FIELDS = ("w_raw", "b_raw", "post_mult", "post_shift", "m_raw", "signs",
              "b_pre")
# (bucket, batch): the issue's cheap tier-1 sizes
SIZES = ((64, 2), (32, 1))


def _to_numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _reference(bucket, batch, per_channel):
    rng = np.random.default_rng(bucket + batch)
    img_u8 = rng.integers(0, 256, (batch, bucket, bucket, 3), dtype=np.uint8)
    img = img_u8.astype(np.float32) / 256.0
    init = jyolo.init_yolo_params(jax.random.PRNGKey(42))
    params = jyolo.calibrate_yolo(init, jnp.asarray(img),
                                  per_channel=per_channel)
    return {"img_u8": img_u8, "img": img, "params": params,
            "params_np": {n: _to_numpy(p) for n, p in params.items()},
            "art_np": jyolo.deploy_yolo(params)}


_CACHE = {}


def reference(bucket=64, batch=2, per_channel=True):
    key = (bucket, batch, per_channel)
    if key not in _CACHE:
        _CACHE[key] = _reference(*key)
    return _CACHE[key]


def _port_art(ref):
    return yolo.deploy_yolo(convert.params_from_numpy(ref["params_np"],
                                                      device="cpu"))


def _reference_layers(art_np, img_u8):
    """The reference's `yolo_forward_int` loop, layer by layer, on its own
    helpers: every layer's output (codes, then the int64 raw head)."""
    outs, x = [], np.asarray(img_u8, np.int64)
    for entry in art_np["layers"]:
        spec = entry["spec"]
        cols = jyolo._im2col_np(x, spec.ksize)
        if spec.name == "conv1":
            acc = cols @ entry["w_raw"].reshape(-1, spec.cout)
            acc = np.maximum(acc + (entry["b_raw"] << 5), 0)
            x = np.clip(jyolo._rshift_round(acc * entry["post_mult"],
                                            entry["post_shift"]), 0, 255)
        elif spec.name == "conv11":
            m9 = np.tile(entry["m_raw"], spec.ksize ** 2)
            acc = (cols * m9) @ entry["w_raw"].reshape(-1, spec.cout)
            outs.append(jyolo._rshift_round(acc, jyolo.FM)
                        + (entry["b_raw"] << 3))
            return outs
        else:
            m9 = np.tile(entry["m_raw"], spec.ksize ** 2)
            acc = (cols * m9) @ entry["signs"]
            x = np.clip(jyolo._rshift_round(acc * entry["post_mult"]
                                            + entry["b_pre"],
                                            entry["post_shift"]), 0, 255)
        if spec.pool:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))
        outs.append(x)
    raise AssertionError("no head")


def _port_layers(art, img_u8):
    outs, x = [], torch.from_numpy(img_u8)
    for entry in art["layers"]:
        x = yolo.int_layer(entry, x)
        outs.append(x.numpy())
    return outs


@pytest.mark.parametrize("per_channel", [True, False])
def test_deploy_yolo_matches_reference(per_channel):
    ref = reference(per_channel=per_channel)
    art = _port_art(ref)
    for got, want in zip(art["layers"], ref["art_np"]["layers"]):
        assert got["spec"].name == want["spec"].name
        fields = [k for k in INT_FIELDS if k in want]
        assert fields and all(k in got for k in fields)
        for k in fields:
            assert got[k].dtype == torch.int64, (want["spec"].name, k)
            assert np.array_equal(got[k].numpy(), want[k]), \
                (want["spec"].name, k)
    # every shift is one the kernel takes
    shifts = np.concatenate([e["post_shift"] for e in ref["art_np"]["layers"]
                             if "post_shift" in e])
    assert shifts.min() > 0 and shifts.max() <= int_ops.SHIFT_MAX


@pytest.mark.parametrize("bucket,batch", SIZES)
@pytest.mark.parametrize("source", ["deploy", "convert"])
def test_int_forward_layers_bit_exact(bucket, batch, source):
    ref = reference(bucket, batch)
    art = (_port_art(ref) if source == "deploy"
           else convert.int_artifact_from_numpy(ref["art_np"], device="cpu"))
    want = _reference_layers(ref["art_np"], ref["img_u8"])
    assert np.array_equal(want[-1], jyolo.yolo_forward_int(ref["art_np"],
                                                           ref["img_u8"]))
    got = _port_layers(art, ref["img_u8"])
    assert len(got) == len(want) == len(yolo.YOLO_LAYERS)
    for spec, g, w in zip(yolo.YOLO_LAYERS, got, want):
        assert g.shape == w.shape, spec.name
        assert np.array_equal(g.astype(np.int64), w), spec.name
    head = yolo.yolo_forward_int(art, ref["img_u8"], device="cpu")
    assert head.dtype == torch.int64
    assert head.shape == (batch, bucket // 32, bucket // 32, 75)
    assert np.array_equal(head.numpy(), want[-1])


@pytest.mark.parametrize("per_channel", [True, False])
def test_int_forward_in_reference_float_envelope(per_channel):
    """tests/test_yolo.py::test_int_pipeline_alignment's envelope: the
    port's int head against the reference's float forward."""
    ref = reference(per_channel=per_channel)
    out_f = np.asarray(jyolo.yolo_forward_float(ref["params"],
                                                jnp.asarray(ref["img"])),
                       np.float64)
    raw = yolo.yolo_forward_int(_port_art(ref), ref["img_u8"], device="cpu")
    rep = jverify.compare("port_int_vs_float", raw.numpy() / 2.0 ** 15,
                          out_f, lsb=0.02)
    assert rep.max_abs < 0.02, rep.row()
    assert rep.mean_abs < 0.002, rep.row()
    assert rep.within_1lsb == 1.0, rep.row()


def test_int_forward_is_deterministic():
    ref = reference()
    art = _port_art(ref)
    a = yolo.yolo_forward_int(art, ref["img_u8"], device="cpu")
    b = yolo.yolo_forward_int(art, torch.from_numpy(ref["img_u8"]),
                              device="cpu")
    assert torch.equal(a, b)


def test_packed_signs_equal_kernel_artifact():
    """The one artifact layout: `deploy_yolo`'s signs, packed, are the
    kernel artifact's sign words bit for bit, in both packages."""
    ref = reference()
    params = convert.params_from_numpy(ref["params_np"], device="cpu")
    art, kart = yolo.deploy_yolo(params), yolo.deploy_yolo_kernel(params)
    jkart = jyolo.deploy_yolo_kernel(ref["params"])
    n = 0
    for e, k, j in zip(art["layers"], kart["layers"], jkart["layers"]):
        if e["spec"].kind != "w1a8":
            continue
        assert torch.equal(e["w_packed"], k["w_packed"]), e["spec"].name
        assert np.array_equal(e["w_packed"].numpy().view(np.uint32),
                              np.asarray(j["w_packed"])), e["spec"].name
        n += 1
    assert n == 9


def _overflow_entry(rng, cin=128, cout=128):
    """conv5's shape with m_raw ≈ 2^17 and every sign +1: at codes 255 and
    K = 1152, |acc| ≈ 3.9e10, past int32."""
    spec = yolo.YOLO_LAYERS[4]
    assert (spec.cin, spec.cout, spec.ksize) == (cin, cout, 3)
    m_raw = (1 << 17) - rng.integers(0, 64, cin)
    mult = rng.integers(1 << 14, 1 << 15, cout)
    shift = rng.integers(40, 47, cout)
    return {"spec": spec, "signs": np.ones((9 * cin, cout), np.int64),
            "m_raw": m_raw.astype(np.int64), "post_mult": mult,
            "post_shift": shift,
            "b_pre": rng.integers(-(1 << 40), 1 << 40, cout)}


@pytest.mark.parametrize("codes", ["255", "random"])
def test_overflow_layer_bit_exact(codes):
    rng = np.random.default_rng(7)
    e = _overflow_entry(rng)
    x = (np.full((1, 6, 6, 128), 255, np.uint8) if codes == "255" else
         rng.integers(0, 256, (1, 6, 6, 128), dtype=np.uint8))
    cols = jyolo._im2col_np(x.astype(np.int64), 3)
    acc = (cols * np.tile(e["m_raw"], 9)) @ e["signs"]
    assert np.abs(acc).max() > (3e10 if codes == "255" else 2 ** 31)
    assert not np.array_equal(acc.astype(np.int32).astype(np.int64), acc)
    want = np.clip(jyolo._rshift_round(acc * e["post_mult"] + e["b_pre"],
                                       e["post_shift"]), 0, 255)
    assert 0 < want.mean() < 255
    t = {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in e.items()
         if k != "spec"}
    got = int_ops.w1a8_int_pe(torch.from_numpy(x),
                              packing.pack_signs(t["signs"], axis=0),
                              t["m_raw"], t["post_mult"], t["b_pre"],
                              t["post_shift"], ksize=3, pool=False)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_overflow_artifact_forward_bit_exact():
    """A whole artifact with conv5 swapped for the overflow entry: the
    port's forward equals the reference's."""
    ref = reference(32, 1)
    art_np = {"layers": list(ref["art_np"]["layers"])}
    e = _overflow_entry(np.random.default_rng(3))
    e["spec"] = art_np["layers"][4]["spec"]
    art_np["layers"][4] = e
    want = jyolo.yolo_forward_int(art_np, ref["img_u8"])
    art = convert.int_artifact_from_numpy(art_np, device="cpu")
    got = yolo.yolo_forward_int(art, ref["img_u8"], device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_head_negative_values_and_ties_bit_exact():
    """conv11 by hand: m_raw = 2^15 and ±1 weights make every accumulator
    an odd or even multiple of 2^15, so half of them sit on the rounding
    tie of the 16-bit shift, on both signs."""
    rng = np.random.default_rng(11)
    spec = yolo.YOLO_LAYERS[-1]
    x = rng.integers(0, 256, (2, 4, 4, spec.cin), dtype=np.uint8)
    w_raw = rng.choice([-1, 1], (1, 1, spec.cin, spec.cout)).astype(np.int64)
    entry = {"m_raw": np.full(spec.cin, 1 << 15, np.int64), "w_raw": w_raw,
             "b_raw": rng.integers(-50, 50, spec.cout).astype(np.int64)}
    acc = (x.astype(np.int64) * entry["m_raw"]) @ w_raw.reshape(-1,
                                                                spec.cout)
    ties = (np.abs(acc) % (1 << 16)) == (1 << 15)
    assert ties[acc < 0].any() and ties[acc > 0].any()
    want = jyolo._rshift_round(acc, jyolo.FM) + (entry["b_raw"] << 3)
    assert (want < 0).any() and (want > 0).any()
    # an arithmetic shift floors the negative ties: not the RTL rounder
    assert not np.array_equal(want, ((acc + (1 << 15)) >> 16)
                              + (entry["b_raw"] << 3))
    t = {k: torch.from_numpy(v) for k, v in entry.items()}
    got = int_ops.int_pe_head(torch.from_numpy(x),
                              t["w_raw"].reshape(-1, spec.cout), t["m_raw"],
                              t["b_raw"] << 3, yolo.FM)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ksize,pool", [(3, True), (3, False), (1, False),
                                        (1, True)])
def test_int_pe_off_grid_bit_exact(ksize, pool):
    """The wrappers off the detector's grid (B = 2, 18×18, Cin 24, Cout 40:
    K = 9·24 = 216 and 24 are not multiples of 32) against the reference's
    numpy formulas: the W1A8 PE at every ksize and pool, conv1 (3×3) and
    the head (1×1)."""
    rng = np.random.default_rng(ksize * 10 + pool)
    b, h, cin, cout = 2, 18, 24, 40
    x = rng.integers(0, 256, (b, h, h, cin), dtype=np.uint8)
    cols = jyolo._im2col_np(x.astype(np.int64), ksize)
    k = cols.shape[-1]
    m_raw = rng.integers(1, 1 << 10, cin)
    mult = rng.integers(1 << 14, 1 << 15, cout)
    shift = rng.integers(18, 26, cout)
    shift[0] = 0
    mult[0] = 0                      # the scale == 0 channel
    bias = rng.integers(-(1 << 22), 1 << 22, cout)
    signs = rng.choice([-1, 1], (k, cout))
    w_raw = rng.integers(-(1 << 16), 1 << 16, (k, cout))

    def pooled(q):
        if not pool:
            return q
        return q.reshape(b, h // 2, 2, h // 2, 2, cout).max(axis=(2, 4))
    T = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    xt = torch.from_numpy(x)
    m9 = np.tile(m_raw, ksize * ksize)
    acc = (cols * m9) @ signs
    want = pooled(np.clip(jyolo._rshift_round(acc * mult + bias, shift),
                          0, 255))
    got = int_ops.w1a8_int_pe(xt, packing.pack_signs(T(signs), axis=0),
                              T(m_raw), T(mult), T(bias), T(shift),
                              ksize=ksize, pool=pool)
    assert np.array_equal(got.numpy(), want)
    if ksize == 3:               # conv1 is 3×3
        acc = np.maximum(cols @ w_raw + bias, 0)
        want = pooled(np.clip(jyolo._rshift_round(acc * mult, shift), 0,
                              255))
        got = int_ops.int_pe_conv1(xt, T(w_raw), T(bias), T(mult), T(shift),
                                   pool=pool)
        assert np.array_equal(got.numpy(), want)
    else:                        # the head is 1×1
        want = jyolo._rshift_round((cols * m9) @ w_raw, 16) + bias
        got = int_ops.int_pe_head(xt, T(w_raw), T(m_raw), T(bias), 16)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [-1, 63])
def test_int_pe_refuses_shift_out_of_range(bad):
    x = torch.zeros((1, 4, 4, 16), dtype=torch.uint8)
    words = packing.pack_signs(torch.ones(144, 8), axis=0)
    shift = torch.full((8,), 20, dtype=torch.int64)
    shift[3] = bad
    ones = torch.ones(8, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\[0, 62\]"):
        int_ops.w1a8_int_pe(x, words, torch.ones(16, dtype=torch.int64),
                            ones, ones, shift, ksize=3, pool=False)
    with pytest.raises(ValueError, match=r"\[0, 62\]"):
        int_ops.int_pe_head(x, torch.ones((16, 8), dtype=torch.int64),
                            torch.ones(16, dtype=torch.int64), ones, bad)


@pytest.mark.parametrize("shift_kind", ["per_channel", "zero", "scalar"])
def test_rshift_round_matches_reference(shift_kind):
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 50), 1 << 50, (64, 16))
    x[:, :4] = rng.integers(-5, 6, (64, 4)) << 20   # ties at shift 21
    if shift_kind == "per_channel":
        shift = rng.integers(0, 40, 16)
        shift[:4] = 21
    elif shift_kind == "zero":
        shift = np.zeros(16, np.int64)
    else:
        shift = np.int64(21)
    want = jyolo._rshift_round(x, shift)
    got = yolo._rshift_round(torch.from_numpy(x), torch.as_tensor(shift))
    assert np.array_equal(got.numpy(), want)


def _oracle(x: int, m: int, f: int) -> int:
    """round_half_away(x·m / 2^f) in Python ints."""
    p = x * m
    q = (abs(p) + ((1 << (f - 1)) if f else 0)) >> f
    return q if p >= 0 else -q


@pytest.mark.parametrize("scale", ["small", "past_2_53"])
def test_fixed_mul_rshift_python_int_oracle(scale):
    rng = np.random.default_rng(9)
    hi = 1 << (20 if scale == "small" else 40)
    x = rng.integers(-hi, hi, 256)
    m = rng.integers(0, 1 << 16, 256)
    x[:2], m[:2] = [711809572306, -811541354291], [26851, 24410]
    for f in (1, 4, 5, 15, 16):
        got = fxp.fixed_mul_rshift(torch.from_numpy(x), torch.from_numpy(m),
                                   f)
        want = [_oracle(int(a), int(b), f) for a, b in zip(x, m)]
        assert got.dtype == torch.int64
        assert got.tolist() == want, f
        assert np.array_equal(got.numpy(), jfxp.fixed_mul_rshift(x, m, f))
    if scale == "past_2_53":
        assert np.abs(x.astype(object) * m.astype(object)).max() > 2 ** 53


def test_fixed_point_formats_match_reference():
    for name in ("INPUT_Q", "HEAD_OUT", "SCALE_Q"):
        a, b = getattr(fxp, name), getattr(jfxp, name)
        assert (a.int_bits, a.frac_bits, a.signed, str(a)) == \
            (b.int_bits, b.frac_bits, b.signed, str(b)), name


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_packed_layer_files_across_packages(tmp_path, writer):
    """A directory written by either package loads in the other, and both
    write the same bytes."""
    rng = np.random.default_rng(13)
    k, n = 200, 24
    blobs = {"weight": rng.standard_normal((k, n)).astype(np.float32),
             "mul_prev": rng.uniform(0.01, 0.1, k).astype(np.float32),
             "div_current": rng.uniform(0.5, 1.5, n).astype(np.float32),
             "bias": rng.standard_normal(n).astype(np.float32)}
    blobs["weight"][0, :3] = 0.0                      # sign(0) = +1
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    e_port = packing.export_packed_layer(port_dir, "conv5", **blobs)
    e_ref = jpacking.export_packed_layer(str(ref_dir), "conv5", **blobs)
    assert e_port == e_ref
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 4
    _, mismatch, errors = filecmp.cmpfiles(port_dir, ref_dir, names,
                                           shallow=False)
    assert not mismatch and not errors
    src = port_dir if writer == "port" else ref_dir
    ref_loaded = jpacking.load_packed_layer(str(src), e_ref)
    port_loaded = packing.load_packed_layer(src, e_port, device="cpu")
    for key, want in ref_loaded.items():
        got = port_loaded[key].numpy()
        if key == "w_packed":
            assert got.dtype == np.int32
            got = got.view(np.uint32)
        assert got.dtype == want.dtype and np.array_equal(got, want), key
