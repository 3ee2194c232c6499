"""Port parity, the distribution layer: `dist.collectives` and
`dist.pipeline` against `repro.dist` on the CPU.

The port's side runs as four gloo ranks (`torch_ranks.spawn`, once for the
module, each rank its own process); the JAX package's side runs in this
process on four of the sixteen host devices `conftest.py` forces. Both take
the same inputs, drawn with numpy from a seed.

Tolerances, and why:

* the tick table and the bubble fractions: equal (integer and rational
  arithmetic).
* `quantized_allreduce_mean`: within 1e-6·max|mean| of the reference's
  (the same codes, scales and integer sums; the mean is an f32 product), and
  within the reference's 3% of the true mean (two int8 legs).
* `permute_quantized`: the int8 wire bit for bit (scale abs-max·f32(1/127),
  codes x / scale, as the reference's compiled program forms them); the b1
  wire's words bit for bit and its α = mean|x| within 1e-5 relative (the
  reference sums in float32 in XLA's order, the port in float64); the rank
  outside the permutation gets exact zeros.
* `gpipe` and `pipeline_train_step` with the f32 wire: within 1e-5 of the
  sequential references (the same math, summed in another order).
* `pipeline_train_step` with the int8 and b1 wires: within 1e-4 of the
  reference's own pipelined step with the same wire (the same codes; a
  wire value an ulp apart where the two forwards differ in the last bit),
  and inside tests/test_pipeline_unit.py's envelopes around the f32 oracle.
* stage 2 × data 2: the f32 grad wire within 1e-5, the int8 one within 3%,
  as tests/test_pipeline_unit.py::test_dp_grad_wire_envelope.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from repro.dist import collectives as jcoll  # noqa: E402
from repro.dist import pipeline as jpipe  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist import pipeline as pipe  # noqa: E402

WORLD = 4
RANKS_TIMEOUT = 120.0
SCHEDULES = ("1f1b", "gpipe")


def _toy(rng, n, num_micro, mb, d=16, wscale=0.3, xscale=1.0) -> dict:
    """tests/test_pipeline_unit.py's toy, drawn with numpy."""
    f32 = np.float32
    return {"ws": {"w": (rng.standard_normal((n, d, d)) * wscale).astype(f32),
                   "b": (rng.standard_normal((n, d)) * 0.1).astype(f32)},
            "top": {"head": (rng.standard_normal((d, d)) * 0.2).astype(f32)},
            "x": (rng.standard_normal((num_micro, mb, d)) * xscale
                  ).astype(f32),
            "aux": {"tgt": rng.standard_normal((num_micro, mb, d)
                                               ).astype(f32)}}


def _inputs() -> dict:
    rng = np.random.default_rng(2026)
    g = rng.standard_normal((WORLD, 1000)).astype(np.float32)
    return {
        "allreduce": {
            "even": g,
            "ragged": rng.standard_normal((WORLD, 1001)).astype(np.float32),
            "wide": (rng.standard_normal((WORLD, 37, 5)) * 1e3
                     ).astype(np.float32),
            "counter": np.tile(np.asarray([7, -3, 11], np.int32),
                               (WORLD, 1))},
        "permute": {
            "int8": rng.standard_normal((WORLD, 4, 6)).astype(np.float32),
            "b1": rng.standard_normal((WORLD, 4, 70)).astype(np.float32)},
        "toy": _toy(rng, WORLD, 8, 2),
        "toy_sat": _toy(rng, WORLD, 8, 2, wscale=3.0, xscale=2.0),
        "toy_dp": _toy(rng, 2, 4, 8)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, every rank's results) of one 4-rank gloo run."""
    inputs = _inputs()
    out = torch_ranks.spawn("dist_checks", WORLD, inputs,
                            tmp_path_factory.mktemp("dist_ranks"),
                            timeout=RANKS_TIMEOUT)
    return inputs, out


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rel(got, want) -> float:
    got_l = jax.tree_util.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    d = np.sqrt(sum(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2)
                    for a, b in zip(got_l, want_l)))
    nrm = np.sqrt(sum(np.sum(np.asarray(b, np.float64) ** 2) for b in want_l))
    return float(d / nrm)


def _jstage(w, x):
    return jnp.tanh(x @ w["w"] + w["b"])


def _jloss(top, y, aux):
    return jnp.mean((y @ top["head"] - aux["tgt"]) ** 2)


def _mesh(n: int, name: str = "stage"):
    return jax.make_mesh((n,), (name,))


# ---------------------------------------------------------------------------
# The tick table, no ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_constants_and_bubbles(schedule):
    for n in range(1, 7):
        for m in range(1, 11):
            assert pipe._schedule_constants(n, m, schedule) == \
                jpipe._schedule_constants(n, m, schedule), (n, m)
            assert pipe.bubble_fraction(n, m) == \
                jpipe.bubble_fraction(n, m)
            assert pipe.bubble_fraction_1f1b(n, m) == \
                jpipe.bubble_fraction_1f1b(n, m)
    with pytest.raises(ValueError):
        pipe._schedule_constants(4, 4, "zb-h1")


def test_wire_and_grad_wire_validated():
    with pytest.raises(ValueError, match="act_wire"):
        pipe.pipeline_train_step(torch_ranks.toy_stage_fn,
                                 torch_ranks.toy_loss_fn, mesh=None,
                                 axis="stage", num_micro=2, act_wire="fp16")
    with pytest.raises(ValueError, match="act_wire"):
        pipe.gpipe(torch_ranks.toy_stage_fn, mesh=None, axis="stage",
                   num_micro=2, act_wire="fp16")
    with pytest.raises(ValueError, match="act_wire"):
        pipe.pipeline_train_local(torch_ranks.toy_stage_fn,
                                  torch_ranks.toy_loss_fn, mesh=None,
                                  axis="stage", num_stages=2, num_micro=2,
                                  act_wire="fp16")
    with pytest.raises(ValueError, match="grad_wire"):
        pipe.pipeline_train_step(torch_ranks.toy_stage_fn,
                                 torch_ranks.toy_loss_fn, mesh=None,
                                 axis="stage", num_micro=2, grad_wire="bf16")
    with pytest.raises(ValueError, match="wire qtype"):
        coll.quantize_wire(torch.zeros(3), "u4")


def test_byte_accounting_as_reference():
    tree = {"a": np.zeros((7, 33), np.float32), "b": np.zeros(5, np.int32)}
    for n in (1, 2, 4, 16):
        assert coll.wire_bytes_saved(
            {k: torch.from_numpy(v) for k, v in tree.items()}, n) == \
            jcoll.wire_bytes_saved(_j(tree), n)
    for shape in ((), (70,), (3, 4, 65)):
        x = np.zeros(shape, np.float32)
        assert coll.permute_wire_bytes(torch.from_numpy(x), 3) == \
            jcoll.permute_wire_bytes(jnp.asarray(x), 3)


# ---------------------------------------------------------------------------
# Meshes and collectives on four ranks
# ---------------------------------------------------------------------------

def test_mesh_builders(ranks):
    """`make_test_mesh` over the four ranks is (2, 2) of ('data', 'model');
    asked for more ranks than the world holds it falls back to (1,
    min(world, model)) as the reference's does, on the first ranks; the
    production mesh needs 256."""
    _, out = ranks
    for r in range(WORLD):
        names, shape, coord = out[r]["meshes"]["test"]
        assert names == ("data", "model") and shape == (2, 2)
        assert list(coord) == [r // 2, r % 2]
        shape, coord = out[r]["meshes"]["fallback"]
        assert shape == (1, 2)
        assert (list(coord) if coord is not None else None) == \
            ([0, r] if r < 2 else None)
        assert "256" in out[r]["meshes"]["production"]

@pytest.mark.parametrize("leaf", ["even", "ragged", "wide", "counter"])
def test_quantized_allreduce_mean(ranks, leaf):
    inputs, out = ranks
    g = inputs["allreduce"][leaf]
    fn = jax.jit(jax.shard_map(
        lambda x: jcoll.quantized_allreduce_mean(x[0], "d")[None],
        mesh=_mesh(WORLD, "d"), in_specs=jax.sharding.PartitionSpec("d"),
        out_specs=jax.sharding.PartitionSpec("d")))
    want = np.asarray(fn(jnp.asarray(g)))
    for r in range(WORLD):
        got = out[r]["allreduce"][leaf]
        assert got.dtype == g.dtype and got.shape == g.shape[1:]
        np.testing.assert_array_equal(got, out[0]["allreduce"][leaf])
        np.testing.assert_array_equal(got, out[r]["tree_allreduce"][leaf])
        if leaf == "counter":                  # exact: sum // n
            np.testing.assert_array_equal(got, g[r])
            np.testing.assert_array_equal(got, want[r])
            continue
        scale = np.abs(want[r]).max()
        assert np.abs(got - want[r]).max() <= 1e-6 * scale, leaf
    if leaf != "counter":
        mean = g.astype(np.float64).mean(0)
        assert _rel(out[0]["allreduce"][leaf], mean) < 0.03


@pytest.mark.parametrize("wire", ["int8", "b1"])
def test_permute_quantized_zeros_at_the_boundary(ranks, wire):
    inputs, out = ranks
    x = inputs["permute"][wire]
    shift = [(i, i + 1) for i in range(WORLD - 1)]
    fn = jax.jit(jax.shard_map(
        lambda s: jcoll.permute_quantized(s[0], "d", shift, wire=wire)[None],
        mesh=_mesh(WORLD, "d"), in_specs=jax.sharding.PartitionSpec("d"),
        out_specs=jax.sharding.PartitionSpec("d")))
    want = np.asarray(fn(jnp.asarray(x)))
    np.testing.assert_array_equal(out[0]["permute"][wire], 0.0)
    for r in range(1, WORLD):
        got = out[r]["permute"][wire]
        if wire == "int8":
            np.testing.assert_array_equal(got, want[r])
            envelope = np.abs(x[r - 1]).max() / 254
            assert np.abs(got - x[r - 1]).max() <= envelope * (1 + 1e-6)
        else:
            np.testing.assert_array_equal(np.sign(got), np.sign(want[r]))
            np.testing.assert_allclose(got, want[r], rtol=1e-5)
            np.testing.assert_array_equal(np.sign(got),
                                          np.where(x[r - 1] >= 0, 1, -1))


# ---------------------------------------------------------------------------
# Pipelines on four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_gpipe_against_reference(ranks, wire):
    inputs, out = ranks
    toy = inputs["toy"]
    want = np.asarray(jpipe.gpipe_reference(_jstage, _j(toy["ws"]),
                                            jnp.asarray(toy["x"])))
    own = pipe.gpipe_reference(torch_ranks.toy_stage_fn,
                               torch_ranks._torch(toy["ws"]),
                               torch.from_numpy(toy["x"])).numpy()
    assert _rel(own, want) < 1e-5
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]["gpipe"][wire],
                                      out[0]["gpipe"][wire])
    err = _rel(out[0]["gpipe"][wire], want)
    if wire == "fp32":
        assert err < 1e-5
    else:                                      # the wire is on, and close
        assert 1e-7 < err < 0.05


def _reference_step(toy, **kw):
    return jpipe.pipeline_train_reference(
        _jstage, _jloss, _j(toy["ws"]), jnp.asarray(toy["x"]),
        aux=_j(toy["aux"]), top=_j(toy["top"]), **kw)


def _jax_step(toy, schedule, wire):
    step = jpipe.pipeline_train_step(
        _jstage, _jloss, mesh=_mesh(WORLD), axis="stage",
        num_micro=toy["x"].shape[0], schedule=schedule, act_wire=wire)
    with _mesh(WORLD):
        return step(_j(toy["ws"]), jnp.asarray(toy["x"]),
                    aux=_j(toy["aux"]), top=_j(toy["top"]))


def _loss_rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("wire", ["fp32", "int8", "b1"])
def test_pipeline_train_step(ranks, schedule, wire):
    inputs, out = ranks
    toy = inputs["toy_sat" if wire == "b1" else "toy"]
    got = out[0]["train"][f"{schedule}-{wire}"]
    for r in range(1, WORLD):                   # every rank: the globals
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(
                            out[r]["train"][f"{schedule}-{wire}"])):
            np.testing.assert_array_equal(a, b)
    loss, gws, gtop, dx = got
    clean = _reference_step(toy)
    if wire == "fp32":
        assert _loss_rel(loss, clean[0]) < 1e-5
        for a, b in zip((gws, gtop, dx), clean[1:]):
            assert _rel(a, b) < 1e-5
        return
    # the reference's own pipelined step with the same wire
    want = _jax_step(toy, schedule, wire)
    assert _loss_rel(loss, want[0]) < 1e-4
    for a, b in zip((gws, gtop, dx), want[1:]):
        assert _rel(a, b) < 1e-4
    # tests/test_pipeline_unit.py's envelopes around the f32 oracle
    if wire == "int8":
        assert _loss_rel(loss, clean[0]) < 0.02
        for a, b in zip((gws, gtop, dx), clean[1:]):
            assert _rel(a, b) < 0.05
    else:
        assert 1e-7 < _loss_rel(loss, clean[0]) < 0.05
    assert _rel(gws, clean[1]) > 1e-7           # the wire is on


@pytest.mark.parametrize("wire,tol", [("fp32", 1e-5), ("int8", 0.03)])
def test_stage2_data2_grad_wire(ranks, wire, tol):
    inputs, out = ranks
    toy = inputs["toy_dp"]
    ref = _reference_step(toy)
    for r in range(WORLD):
        loss, gws, gtop, _ = out[r]["dp"][wire]
        assert abs(float(loss) - float(ref[0])) < 1e-5
        assert _rel(gws, ref[1]) < tol
        assert _rel(gtop, ref[2]) < tol
    _, _, _, dx = out[0]["dp"][wire]
    assert dx.shape == toy["x"].shape
    if wire == "fp32":
        assert _rel(dx, ref[3]) < 1e-5
