"""Port parity, sequence-parallel decode attention: `serve/sp.py` against
`repro.serve.sp` on the CPU.

The port's multi-rank side runs as four gloo ranks (`torch_ranks.spawn`,
once for the module), each holding a quarter of the positions; the JAX
side runs in this process. The same numpy inputs, drawn from a seed.

Tolerances, and why:

* `sp_attention_local`: m and l rtol 1e-5, o within 1e-5·max|o| (the
  same f32 products and exps summed in another order: an element of o
  that cancels to near zero carries the rounding of its largest terms).
* the combine of halves, and four ranks' `sp_decode_attention`: within
  1e-5 of the unsharded attention, the contract of the reference's
  ``tests/dist_main.py::check_sp_attention`` (the log-sum-exp rescaling
  adds a rounding a rank).
* a shard with no valid position: m = −inf, l = 0, o = 0 exactly, and a
  ``cur_pos`` before every position gives finite zeros after the combine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from repro.serve import sp as jsp  # noqa: E402
from repro_torch.serve import sp  # noqa: E402

WORLD = 4
B, H, KV, HD, T = 2, 8, 4, 16, 64


def _inputs() -> dict:
    rng = np.random.default_rng(2027)
    f32 = np.float32
    return {"q": rng.standard_normal((B, H, HD)).astype(f32),
            "k": rng.standard_normal((B, T, KV, HD)).astype(f32),
            "v": rng.standard_normal((B, T, KV, HD)).astype(f32),
            "pos": np.broadcast_to(np.arange(T, dtype=np.int32),
                                   (B, T)).copy(),
            # cur_pos 40: the last quarter's 16 positions all invalid;
            # per row 5 and 63; -1: no position valid anywhere
            "cur_pos": {"at_40": np.full((B,), 40, np.int32),
                        "per_row": np.asarray([5, 63], np.int32),
                        "none": np.full((B,), -1, np.int32)}}


def _whole(a: dict, cur) -> np.ndarray:
    """The reference's unsharded attention: its local partial over all T,
    o / l."""
    o, m, l = jsp.sp_attention_local(*(jnp.asarray(a[k]) for k in
                                       ("q", "k", "v", "pos")),
                                     jnp.asarray(cur))
    return np.asarray(o / l[..., None])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    a = _inputs()
    return a, torch_ranks.spawn("sp", WORLD, a,
                                tmp_path_factory.mktemp("sp_ranks"))


@pytest.mark.parametrize("cur", ["at_40", "per_row"])
def test_sp_attention_local_against_reference(cur):
    a = _inputs()
    for lo, hi in ((0, T), (16, 48), (48, T)):
        part = slice(lo, hi)
        args = [a["q"], a["k"][:, part], a["v"][:, part], a["pos"][:, part],
                a["cur_pos"][cur]]
        want = jsp.sp_attention_local(*(jnp.asarray(x) for x in args))
        got = sp.sp_attention_local(*(_t(x) for x in args))
        for g, w, what in zip(got, want, ("o", "m", "l")):
            w = np.asarray(w)
            atol = 1e-5 * float(np.abs(w).max()) if what == "o" else 0
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol,
                                       err_msg=f"{cur} {lo} {what}")


def test_empty_shard_gives_exact_zeros():
    """A shard past cur_pos: m = −inf, l = 0, o = 0, no NaN."""
    a = _inputs()
    part = slice(48, T)
    o, m, l = sp.sp_attention_local(
        _t(a["q"]), _t(a["k"][:, part]), _t(a["v"][:, part]),
        _t(a["pos"][:, part]), _t(a["cur_pos"]["at_40"]))
    assert bool(torch.all(m == -torch.inf))
    assert not bool(l.any()) and not bool(o.any())
    assert not bool(torch.isnan(o).any())


def test_halves_combine_to_the_whole():
    """Two shards' partials combined by the log-sum-exp rule (the
    combine's arithmetic, without ranks) give the whole attention, as
    tests/test_serve.py checks the reference's."""
    a = _inputs()
    for name, cur in a["cur_pos"].items():
        parts = [sp.sp_attention_local(
            _t(a["q"]), _t(a["k"][:, s]), _t(a["v"][:, s]),
            _t(a["pos"][:, s]), _t(cur))
            for s in (slice(0, T // 2), slice(T // 2, T))]
        m = torch.maximum(parts[0][1], parts[1][1])
        corr = [torch.where(torch.isfinite(p[1]), torch.exp(p[1] - m), 0.0)
                for p in parts]
        lsum = sum(p[2] * c for p, c in zip(parts, corr))
        o = sum(p[0] * c[..., None] for p, c in zip(parts, corr)) \
            / torch.clamp(lsum, min=1e-20)[..., None]
        if name == "none":
            assert not bool(o.any()) and bool(torch.isfinite(o).all())
            continue
        np.testing.assert_allclose(o.numpy(), _whole(a, cur), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_sp_decode_attention_on_four_ranks(ranks):
    a, got = ranks
    for name, cur in a["cur_pos"].items():
        for r in range(WORLD):
            o = got[r][name]
            assert o.shape == (B, H, HD) and np.isfinite(o).all()
            if name == "none":
                assert not o.any(), r
                continue
            np.testing.assert_allclose(o, _whole(a, cur), atol=1e-5, rtol=0,
                                       err_msg=f"{name} rank {r}")
        # every rank's combine is the same all-reduce
        assert all(np.array_equal(got[0][name], got[r][name])
                   for r in range(WORLD))
    # the last quarter holds no position before 40
    _, m, l = got[3]["at_40_partial"]
    assert np.all(m == -np.inf) and not l.any()
