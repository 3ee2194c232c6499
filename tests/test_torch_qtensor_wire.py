"""Port parity, the distribution layer's wires: `QTensor`'s ``s8`` and
``b1`` qtypes against `repro.core.qtensor` on the CPU, the same numpy
inputs to both.

* s8: codes and scale bit for bit, against the reference as its wires run
  it, jitted (inside ``shard_map``): there XLA forms abs-max / 127 as
  abs-max · f32(1/127), which an eager call does not (an ulp apart on some
  5% of tensors); the port follows the jitted one.
* b1: sign words, ``kdim``, ``axis``, the scale's shape and ``wire_bytes``
  bit for bit; α = mean|x| within 1e-5 relative. The reference sums in
  float32 in XLA's vectorised order, which no other program reproduces;
  the port sums in float64 and rounds once, so that the card and the CPU
  agree bit for bit, and lands within some ulps of the reference.
* the 1e-20 clamps of both: the reference's values exactly (its
  docstring's s8 envelope does not hold them: ROADMAP.md, Queue 3).

Inputs are normal floats: no subnormals. JAX on the CPU flushes a
subnormal to zero and packs −1.1e-44 as +1; torch keeps its sign (ROADMAP.md,
Queue 3, "b1 sign of subnormals").
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.qtensor import QTensor as JQ  # noqa: E402
from repro_torch.core.qtensor import S8_QMAX, QTensor  # noqa: E402

SHAPES = [(7,), (5, 37), (3, 100), (2, 3, 33), (4, 64), (6, 65)]
MAGS = [1e-6, 1.0, 1e6]
ALPHA_RTOL = 1e-5


def _x(shape, mag, seed=0, zero_row=False) -> np.ndarray:
    rng = np.random.default_rng([seed, len(shape), int(np.log10(mag)) + 7])
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    if zero_row and x.ndim > 1:
        x[(1,) * (x.ndim - 1)] = 0.0          # one all-zero slice
    return x


_JS8 = jax.jit(JQ.quantize_s8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mag", MAGS)
def test_s8_bit_for_bit(shape, mag):
    x = _x(shape, mag)
    got = QTensor.quantize_s8(torch.from_numpy(x))
    want = _JS8(jnp.asarray(x))
    assert got.qtype == "s8" and got.data.dtype == torch.int8
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    assert got.wire_bytes() == want.wire_bytes() == x.size + 4
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))
    assert got.per_tensor and float(got.scale_scalar()) == float(got.scale)
    # the documented envelope |x̂ − x| ≤ scale / 2
    err = np.abs(got.dequantize().numpy() - x).max()
    assert err <= float(got.scale) / 2 * (1 + 1e-6)


def test_s8_zero_tensor_and_explicit_scale():
    z = np.zeros((3, 40), np.float32)
    got, want = QTensor.quantize_s8(torch.from_numpy(z)), _JS8(jnp.asarray(z))
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    assert float(got.scale) == np.float32(1e-20) * (np.float32(1) /
                                                    np.float32(127))
    assert not got.data.any() and not got.dequantize().any()
    # an explicit (shared) scale overrides the abs-max
    x = np.asarray([0.5, -0.25], np.float32)
    s = np.float32(1.0 / S8_QMAX)
    got = QTensor.quantize_s8(torch.from_numpy(x), scale=torch.tensor(s))
    want = JQ.quantize_s8(jnp.asarray(x), scale=jnp.float32(s))
    np.testing.assert_array_equal(got.data.numpy(), [64, -32])
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def _same_b1(got: QTensor, want, x: np.ndarray) -> None:
    assert got.qtype == want.qtype == "b1"
    assert (got.kdim, got.axis) == (want.kdim, want.axis)
    assert got.data.dtype == torch.int32
    np.testing.assert_array_equal(got.data.numpy(),
                                  np.asarray(want.data).view(np.int32))
    assert tuple(got.scale.shape) == np.shape(want.scale)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=ALPHA_RTOL)
    assert got.wire_bytes() == want.wire_bytes()
    assert got.per_tensor == bool(want.per_tensor)
    xh = got.dequantize().numpy()
    assert xh.shape == x.shape and np.all(np.isfinite(xh))
    np.testing.assert_array_equal(np.sign(xh),
                                  np.sign(np.asarray(want.dequantize())))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("per_slice", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_b1_quantize_against_reference(shape, per_slice, axis):
    for mag in MAGS:
        x = _x(shape, mag, zero_row=True)
        got = QTensor.quantize_b1(torch.from_numpy(x), axis=axis,
                                  per_slice=per_slice)
        want = JQ.quantize_b1(jnp.asarray(x), axis=axis, per_slice=per_slice)
        _same_b1(got, want, x)
        np.testing.assert_array_equal(
            np.sign(got.dequantize().numpy()), np.where(x >= 0, 1.0, -1.0))


@pytest.mark.parametrize("per_slice", [False, True])
def test_b1_all_zero_clamps_alpha(per_slice):
    """An all-zero tensor (and, per slice, its zero rows) carries α = 1e-20,
    the reference's clamp, and dequantizes to ±1e-20, not NaN."""
    z = np.zeros((3, 70), np.float32)
    got = QTensor.quantize_b1(torch.from_numpy(z), per_slice=per_slice)
    want = JQ.quantize_b1(jnp.asarray(z), per_slice=per_slice)
    _same_b1(got, want, z)
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    assert np.all(got.scale.numpy() == np.float32(1e-20))
    assert np.abs(got.dequantize().numpy()).max() <= np.float32(1e-20)


@pytest.mark.parametrize("shape", [(37, 5), (64, 3), (100, 65)])
def test_pack_b1_against_reference(shape):
    x = _x(shape, 1.0)
    got = QTensor.pack_b1(torch.from_numpy(x), axis=0)
    want = JQ.pack_b1(jnp.asarray(x), axis=0)
    _same_b1(got, want, x)
    alpha = np.linspace(0.5, 1.5, shape[1]).astype(np.float32)
    got = QTensor.pack_b1(torch.from_numpy(x), torch.from_numpy(alpha),
                          axis=0)
    want = JQ.pack_b1(jnp.asarray(x), jnp.asarray(alpha), axis=0)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


def test_wire_bytes_and_qtypes():
    """tests/test_qtensor.py's byte counts, and an unknown qtype refused."""
    assert QTensor.quantize_s8(torch.ones(4, 8)).wire_bytes() == 4 * 8 + 4
    assert QTensor.from_f32(torch.ones(4, 8)).wire_bytes() == 4 * 8 * 4 + 4
    b1 = QTensor.quantize_b1(torch.ones(4, 70))
    assert b1.wire_bytes() == 4 * 3 * 4 + 4 and b1.kdim == 70
    with pytest.raises(ValueError, match="qtype"):
        QTensor(torch.zeros(2), torch.ones(()), "s4")
