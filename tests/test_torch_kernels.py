"""Port parity, kernel layer: the port's ops on CPU tensors (the plain
versions of the CUDA kernels) against the reference's Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances are the reference suite's own (tests/test_kernels.py): f32
within 6e-3·max|y| (both sides round the prologue to bf16, then sum in f32
in different orders), uint8 codes within 1 LSB and ≥ 99% identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.config import KernelConfig as JConfig  # noqa: E402
from repro.kernels.w1a8_conv import ops as jconv  # noqa: E402
from repro.kernels.w1a8_matmul import ops as jmm  # noqa: E402
from repro_torch.kernels import config  # noqa: E402
from repro_torch.kernels.config import KernelConfig  # noqa: E402
from repro_torch.kernels.w1a8_conv import ops as conv  # noqa: E402
from repro_torch.kernels.w1a8_matmul import ops as mm  # noqa: E402


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


def test_popcount_is_not_ported_yet():
    a = torch.zeros((1, 4, 4, 16), dtype=torch.uint8)
    wp = conv.conv_pack_weights(torch.ones((3, 3, 16, 32)))
    ones = torch.ones(32)
    for op, fn in (("conv3x3", conv.w1a8_conv3x3),
                   ("conv3x3_pool", conv.w1a8_conv3x3_pool)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(a, wp, torch.ones(16), ones, ones, cin=16,
               config=KernelConfig(op=op, accum="popcount"))


def test_config_resolution_without_table():
    """No port table yet: "tuned" resolves dot, fused, rows=1 everywhere;
    a given table's exact cell wins, any other cell takes the heuristic."""
    cfg = config.resolve_tuned("conv3x3_pool", (160, 160, 16, 32),
                               table={}, device="h100")
    assert cfg == KernelConfig(op="conv3x3_pool", accum="dot", fused=True,
                               rows=1)
    table = {config.shape_key("conv3x3", (20, 20, 128, 128), "dot", "h100"):
             {"config": {"op": "conv3x3", "rows": 4}, "t_us": 1.0}}
    exact = config.resolve("conv3x3", (20, 20, 128, 128), table=table,
                           device="h100")
    other = config.resolve("conv3x3", (10, 10, 128, 128), table=table,
                           device="h100")
    assert (exact.rows, other.rows) == (4, 1)
    assert exact.conv_rows(10) == 2
    assert config.resolve_tuned("conv3x3", (20, 20, 128, 128), table=table,
                                device="h100") == exact
    with pytest.raises(ValueError):
        KernelConfig(op="conv3x3", bk=48)
