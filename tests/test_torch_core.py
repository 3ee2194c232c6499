"""Port parity, core numerics: the same numpy inputs through `repro.core`
and `repro_torch.core`, bit-exact wherever the reference is integer-exact.

Inputs exclude subnormals: the reference on the CPU flushes them to zero
(−1.1e-44 packs as +1), PyTorch keeps their sign (ROADMAP.md, Queue 3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfxp  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro_torch.core import fixedpoint, packing, quant, verify  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402


def test_round_half_away_ties_bit_exact():
    ties = [0.5, 1.5, 2.5, 254.5]
    x = np.array(ties + [-t for t in ties]
                 + [0.0, -0.3, 0.49999997, -0.49999997, 3.2, -3.7, 255.49998],
                 np.float32)
    want = np.asarray(jquant.round_half_away(jnp.asarray(x)))
    got = quant.round_half_away(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
    assert got[2] == 3.0 and got[6] == -3.0
    # torch.round rounds half to even: it must not stand in for the above
    assert float(torch.round(torch.tensor(2.5))) == 2.0


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_u8_codes_bit_exact(per_channel):
    rng = np.random.default_rng(1)
    c = 8
    step = (rng.uniform(0.01, 0.2, c) if per_channel
            else np.full(c, 0.05)).astype(np.float32)
    codes = rng.integers(-20, 280, (3, 5, 6, c))
    x = ((codes + rng.choice([0.0, 0.5, 0.25, -0.5], codes.shape))
         * step).astype(np.float32)
    want = JQTensor.quantize_u8(jnp.asarray(x), jnp.asarray(step), axis=-1)
    got = QTensor.quantize_u8(torch.from_numpy(x), torch.from_numpy(step),
                              axis=-1)
    assert got.data.dtype == torch.uint8
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.dequantize().numpy(),
                          np.asarray(want.dequantize()))


@pytest.mark.parametrize("k", [27, 144, 160, 1152])
def test_pack_unpack_words_bit_exact(k):
    rng = np.random.default_rng(k)
    w = rng.standard_normal((k, 7)).astype(np.float32)
    w[::5, 0] = 0.0                    # sign(0) = +1
    w[1::7, 1] = -0.0                  # -0.0 >= 0 as well
    want = np.asarray(jpacking.pack_signs(jnp.asarray(w), axis=0))
    got = packing.pack_signs(torch.from_numpy(w), axis=0)
    assert got.dtype == torch.int32
    assert got.shape == (packing.packed_dim(k), 7)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    signs = packing.unpack_signs(got, k, axis=0, dtype=torch.float32).numpy()
    want_signs = np.asarray(jpacking.unpack_signs(jnp.asarray(want), k,
                                                  axis=0, dtype=jnp.float32))
    assert np.array_equal(signs, want_signs)
    assert np.array_equal(signs, np.where(w >= 0, 1.0, -1.0))
    # along a trailing axis too
    got_t = packing.pack_signs(torch.from_numpy(w.T.copy()), axis=1)
    assert np.array_equal(got_t.numpy().view(np.uint32), want.T)


@pytest.mark.parametrize("name", ["CONV1_W", "CONV1_B", "CONV11_W",
                                  "CONV11_B"])
def test_qformat_roundtrip_bit_exact(name):
    fmt, jfmt = getattr(fixedpoint, name), getattr(jfxp, name)
    assert str(fmt) == str(jfmt) and fmt.total_bits == jfmt.total_bits
    rng = np.random.default_rng(3)
    x = rng.uniform(-40, 40, 2000).astype(np.float32)     # saturates too
    x[:50] = ((np.arange(50) - 25 + 0.5) / fmt.scale).astype(np.float32)
    raw = fmt.quantize(torch.from_numpy(x)).numpy()
    assert np.array_equal(raw, np.asarray(jfmt.quantize(jnp.asarray(x))))
    rt = fmt.roundtrip(torch.from_numpy(x)).numpy()
    assert rt.tobytes() == np.asarray(jfmt.roundtrip(jnp.asarray(x))).tobytes()


def test_compare_identical():
    rng = np.random.default_rng(4)
    ref = rng.standard_normal((4, 10, 10, 75))
    test = ref + rng.uniform(-0.03, 0.03, ref.shape)
    got = verify.compare("x", test, ref, lsb=0.02)
    want = jverify.compare("x", test, ref, lsb=0.02)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


@pytest.mark.parametrize("per_channel", [True, False])
def test_fold_codes_to_uniform_step_bit_exact(per_channel):
    """Codes onto the coarsest step, exactly as the reference; under
    uniform steps the fold is the identity and m̄ is the step itself."""
    rng = np.random.default_rng(5)
    c = 24
    step = (rng.uniform(0.005, 0.2, c) if per_channel
            else np.full(c, 0.0371)).astype(np.float32)
    a = rng.integers(0, 256, (2, 5, 7, c), dtype=np.uint8)
    a[0, 0, 0] = 255
    want_codes, want_mbar = jquant.fold_codes_to_uniform_step(
        jnp.asarray(a), jnp.asarray(step))
    codes, mbar = quant.fold_codes_to_uniform_step(torch.from_numpy(a),
                                                   torch.from_numpy(step))
    assert codes.dtype == torch.uint8
    assert np.array_equal(codes.numpy(), np.asarray(want_codes))
    assert mbar.numpy().tobytes() == np.asarray(want_mbar).tobytes()
    if per_channel:
        assert not np.array_equal(codes.numpy(), a)
        assert int(codes.max()) == 255            # the coarsest channel
    else:
        assert np.array_equal(codes.numpy(), a)
        assert float(mbar) == float(step[0])
