"""Port parity, optimizers: AdamW, Adafactor and SGD-M, the global-norm
clip and both schedules against ``repro.optim`` on the same numpy params
and gradients, state leaf for leaf.

Tolerances: rtol 1e-6 (float32 elementwise arithmetic in the same order,
PyTorch's and XLA's pow, sqrt and division may differ in the last bit);
Adafactor rtol 1e-5 (row and column means and rsqrt, reduced in another
order); the clip's norm rtol 1e-6 (a sum of squares in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402


def _params(rng):
    """Factored leaves (2 and 4 dims) and unfactored ones (1 dim), under
    keys whose sorted order is not their insertion order."""
    return {"conv2": {"w": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
                      "b": rng.normal(size=(5,)).astype(np.float32),
                      "act_step": np.full((4,), 0.05, np.float32)},
            "conv10": {"w": rng.normal(size=(6, 7)).astype(np.float32),
                       "b": np.zeros((7,), np.float32)},
            "conv1": {"w": rng.normal(size=(2, 3)).astype(np.float32)}}


def _grads(rng, params, scale=1.0):
    return {n: {k: (scale * rng.normal(size=v.shape)).astype(np.float32)
                for k, v in p.items()} for n, p in params.items()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, rtol, what):
    """Leaf for leaf in the reference's order, with the same structure."""
    want_leaves, treedef = jax.tree_util.tree_flatten(want)
    got_np = optim.tree_map(lambda t: t.numpy(), got)
    assert jax.tree_util.tree_structure(got_np) == treedef, what
    for i, (g, w) in enumerate(zip(jax.tree_util.tree_leaves(got_np),
                                   want_leaves)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                   err_msg=f"{what} leaf {i}")


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(m.cosine_schedule(1e-2, 1, 3),
                                weight_decay=0.1), 1e-6),
    "adamw_const": (lambda m: m.adamw(1e-3), 1e-6),
    "adafactor": (lambda m: m.adafactor(1e-2), 1e-5),
    "sgdm": (lambda m: m.sgdm(m.linear_warmup(0.1, 2)), 1e-6),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    make, rtol = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params_np = _params(rng)
    j_init, j_update = make(joptim)
    t_init, t_update = make(optim)
    jp, tp = _jax(params_np), _torch(params_np)
    js, ts = j_init(jp), t_init(tp)
    _assert_tree_close(ts, js, 0, f"{name} init")
    for i in range(3):
        g = _grads(rng, params_np, scale=10.0 ** (i - 1))
        ju, js = j_update(_jax(g), js, jp)
        tu, ts = t_update(_torch(g), ts, tp)
        _assert_tree_close(tu, ju, rtol, f"{name} updates {i}")
        _assert_tree_close(ts, js, rtol, f"{name} state {i}")
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _assert_tree_close(tp, jp, rtol, f"{name} params {i}")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3


def test_adafactor_state_layout():
    params = _torch(_params(np.random.default_rng(1)))
    state = optim.adafactor(1e-2)[0](params)
    assert set(state["v"]["conv2"]["w"]) == {"vr", "vc"}
    assert state["v"]["conv2"]["w"]["vr"].shape == (3, 3, 4)
    assert state["v"]["conv2"]["w"]["vc"].shape == (3, 3, 5)
    assert set(state["v"]["conv2"]["b"]) == {"v"}


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(2)
    g = _grads(rng, _params(rng))
    jg, jn = joptim.clip_by_global_norm(_jax(g), max_norm)
    tg, tn = optim.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    _assert_tree_close(tg, jg, 1e-6, "clipped")
    if max_norm > float(tn):
        _assert_tree_close(tg, _jax(g), 0, "unclipped")


def test_tree_leaves_in_reference_order():
    params = _params(np.random.default_rng(3))
    want = [a.shape for a in jax.tree_util.tree_leaves(params)]
    assert [a.shape for a in optim.tree_leaves(params)] == want


def test_schedules_match_reference():
    cases = [("linear_warmup", (0.1, 5)), ("linear_warmup", (0.1, 0)),
             ("cosine_schedule", (3e-3, 4, 20)),
             ("cosine_schedule", (1e-3, 0, 10, 0.0))]
    for name, args in cases:
        jf, tf = getattr(joptim, name)(*args), getattr(optim, name)(*args)
        for step in range(0, 25):
            want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
            got = tf(torch.tensor(step, dtype=torch.int32)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       err_msg=f"{name}{args} at {step}")
            assert float(tf(step)) == float(got)
