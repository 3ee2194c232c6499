"""Port parity, the sharded train step, the launcher's --production-mesh
branch and elastic restore, on four gloo ranks of a (data 2, model 2)
mesh (`torch_ranks.spawn`, once for the module).

Reduced mixtral-8x7b (experts over 'data', their hidden dim over 'model')
and reduced chatglm3-6b (dense: its leaves over 'model' only): each rank
holds its block of every param and moment (`dist.sharding.shard_tree`),
takes its row of the batch, and runs `make_train_step(ctx=)` on those
blocks (tensor-parallel, no leaf gathered; tests/test_torch_tp.py holds
the layout across archs) with SGD-M and no clip, so its moment after one
step is its block of the gradient.
The same step runs on one device in this process, and the reference's
``jax.value_and_grad`` of `lm_loss` (tests/test_torch_lm_train.py's)
gives the gradients. Codes that round across a tie are forced to the
reference's, by rows on the ranks (`train.ties.forced_by_rows`) and by
call on one device (`train.ties.forced`).

Tolerances, and why:

* the loss: rtol 1e-5 of the reference's and of the one-device step's
  (each rank's mean over its row, averaged over the data ranks).
* every gradient leaf, gathered from the ranks: within 1e-4·max|g| of the
  one-device step's and of the reference's (the TP sum of the experts'
  down projection and the data ranks' sum add in another order; the act
  steps' LSQ scale is brought to the whole batch's rows).
* each rank's moment and params: its block of the one-device step's,
  within the same 1e-4·max|g| (params: lr times that, plus an ulp).
* elastic restore: bit for bit (blocks of the same files).
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_torch_lm_train as lm_train  # noqa: E402
import torch_ranks  # noqa: E402
from repro import ckpt as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models.transformer import init_lm_params as jinit  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import ckpt, configs, convert  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import (init_lm_params,  # noqa: E402
                                            tree_items)
from repro_torch.optim import adamw, sgdm  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402

WORLD = 4
ARCHS = ("mixtral-8x7b", "chatglm3-6b")
LR, NO_CLIP = 0.1, 1e9
ELASTIC = "mixtral-8x7b"


class _Mesh:
    """(data, model) sizes, all `param_spec` reads."""
    def __init__(self, data: int, model: int):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


def _block(whole: np.ndarray, path: str, cfg, sizes: tuple,
           coords: dict) -> np.ndarray:
    """The block of ``whole`` the rank at ``coords`` holds."""
    spec = sharding.param_spec(path, whole.shape, cfg, _Mesh(*sizes))
    idx = []
    for dim, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        n = whole.shape[dim] // dict(zip(("data", "model"), sizes))[axis]
        idx.append(slice(coords[axis] * n, (coords[axis] + 1) * n))
    return whole[tuple(idx)]


def _flat(tree) -> dict:
    return {p: convert.lm_leaf_to_numpy(torch.as_tensor(v))
            if not isinstance(v, np.ndarray) else v
            for p, v in tree_items(tree)}


def _one_device(name: str) -> dict:
    """The port's one-device SGD-M step from the reference's params,
    forced to the reference's codes."""
    params_np, batch, _, _, rec = lm_train._reference(name)
    cfg = configs.get_reduced(name)
    params = convert.lm_params_from_numpy(params_np, device="cpu")
    opt = sgdm(LR)
    step = step_mod.make_train_step(cfg, opt, remat=False,
                                    max_grad_norm=NO_CLIP)
    with lm_train._forced(rec):
        p, s, metrics = step(params, opt[0](params),
                             lm_train._port_batch(batch))
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "m": _flat(s["m"]), "params": _flat(p), "state": (p, s)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_step")
    steps, one = {}, {}
    for name in ARCHS:
        params_np, batch, _, _, rec = lm_train._reference(name)
        steps[name] = {"params": params_np, "batch": batch,
                       "recorded": rec.inputs["layers"] + rec.inputs["moe"]}
        one[name] = _one_device(name)
    # a one-device checkpoint (params and a non-zero moment) to restore
    # onto the ranks
    p, s = one[ELASTIC].pop("state")
    one_ckpt = str(tmp / "one_device")
    ckpt.save_checkpoint(one_ckpt, 1, {"params": p, "opt_state": s})
    for name in ARCHS:
        one[name].pop("state", None)
    launch_dir = str(tmp / "launch")
    inputs = {"steps": steps, "lr": LR, "max_norm": NO_CLIP,
              "launch": ["--arch", ELASTIC, "--reduced", "--device", "cpu",
                         "--production-mesh", "--steps", "2", "--seq-len",
                         "8", "--global-batch", "4", "--ckpt-dir",
                         launch_dir],
              "elastic_arch": ELASTIC, "one_device_ckpt": one_ckpt}
    got = torch_ranks.spawn("sharded_step", WORLD, inputs, tmp / "ranks",
                            timeout=180.0)
    return got, one, one_ckpt, launch_dir


def _within(got: np.ndarray, want: np.ndarray, rel: float, what: str,
            scale=None) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_loss_and_grads_against_one_device_and_reference(name,
                                                                 ranks):
    got, one, _, _ = ranks
    _, _, want_loss, want, _ = lm_train._reference(name)
    for r in got:
        np.testing.assert_allclose(float(r[name]["loss"]), want_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r[name]["loss"]), one[name]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r[name]["grad_norm"]),
                                   one[name]["grad_norm"], rtol=1e-5)
    grads = _flat(got[0][name]["grads"])
    assert set(grads) == set(want) == set(one[name]["m"])
    for path, g in grads.items():
        _within(g, one[name]["m"][path], 1e-4, f"{name} {path} (one device)")
        _within(g, want[path], 1e-4, f"{name} {path} (reference)")
    assert any("act_step" in p and float(np.abs(g).max()) > 0
               for p, g in grads.items())


@pytest.mark.parametrize("name", ARCHS)
def test_each_rank_holds_its_block_after_a_step(name, ranks):
    got, one, _, _ = ranks
    cfg = configs.get_reduced(name)
    for r in got:
        coords = dict(zip(("data", "model"), r["coords"]))
        m, p = _flat(r[name]["m"]), _flat(r[name]["params"])
        for path, whole in one[name]["m"].items():
            scale = float(np.abs(whole).max())
            _within(m[path], _block(whole, path, cfg, (2, 2), coords), 1e-4,
                    f"{name} m {path} at {coords}", scale)
            pw = one[name]["params"][path]
            _within(p[path], _block(pw, path, cfg, (2, 2), coords), 1.0,
                    f"{name} params {path} at {coords}",
                    LR * 1e-4 * scale + 1e-7 * float(np.abs(pw).max()))
    # the experts are split over both axes: a rank holds a quarter
    if cfg.num_experts:
        path = "['slots'][0]['moe']['up']"
        assert _flat(got[0][name]["m"])[path].shape[1:] == (
            cfg.num_experts // 2, cfg.d_model, cfg.d_ff // 2)


def _run_main(argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = launch_train.main(argv)
    return rec, buf.getvalue().strip().splitlines()


def test_production_mesh_branch_on_four_ranks_then_one_device(ranks):
    """`train(args, dev, mesh)` on (2, 2) with --production-mesh: 2 steps,
    one JSON record a rank; the one-device launcher resumes its
    checkpoint."""
    got, _, _, launch_dir = ranks
    for r in got:
        rec = r["launch"]
        assert rec["steps"] == 2 and rec["world"] == WORLD and rec["sharded"]
        assert rec["mesh"] == {"data": 2, "model": 2}
        assert rec["backend"] == "gloo"
        assert np.isfinite(rec["first_loss"]) and np.isfinite(
            rec["last_loss"])
    assert ckpt.latest_step(launch_dir) == 2
    again, lines = _run_main(["--arch", ELASTIC, "--reduced", "--device",
                              "cpu", "--steps", "3", "--seq-len", "8",
                              "--global-batch", "4", "--ckpt-dir",
                              launch_dir])
    assert lines[0] == f"[resume] restored step 2 from {launch_dir}"
    assert again["start_step"] == 2 and again["steps"] == 3


def _whole_tree(d: str, step: int, opt) -> dict:
    cfg = configs.get_reduced(ELASTIC)
    meta = init_lm_params(cfg, None, device="meta")
    tree, _ = ckpt.restore_checkpoint(
        d, step, {"params": meta, "opt_state": opt[0](meta)}, device="cpu")
    return _flat(tree)


def test_elastic_restore_one_device_onto_2x2(ranks):
    got, _, one_ckpt, _ = ranks
    cfg = configs.get_reduced(ELASTIC)
    want = _whole_tree(one_ckpt, 1, sgdm(LR))
    for r in got:
        rec = r["onto_2x2"]
        held, whole = _flat(rec["held"]), _flat(rec["whole"])
        assert set(held) == set(want)
        for path, w in want.items():
            assert np.array_equal(whole[path], w), path
            assert np.array_equal(
                held[path], _block(w, path, cfg, (2, 2), rec["coords"])), \
                path
    up = "['params']['slots'][0]['moe']['up']"
    assert _flat(got[0]["onto_2x2"]["held"])[up].shape[1:] == (2, 64, 48)


def test_elastic_restore_2x2_checkpoint_onto_4x1_one_device_and_reference(
        ranks):
    """The (2, 2) launcher's checkpoint restored onto (data 4, model 1),
    on one device and by the reference's `restore_checkpoint`: the same
    leaves bit for bit."""
    got, _, _, launch_dir = ranks
    cfg = configs.get_reduced(ELASTIC)
    want = _whole_tree(launch_dir, 2, adamw(1e-3))
    for r in got:
        rec = r["onto_4x1"]
        held, whole = _flat(rec["held"]), _flat(rec["whole"])
        for path, w in want.items():
            assert np.array_equal(whole[path], w), path
            assert np.array_equal(
                held[path], _block(w, path, cfg, (4, 1), rec["coords"])), \
                path
    jcfg = jconfigs.get_reduced(ELASTIC)
    sds = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    like = {"params": sds, "opt_state": jax.eval_shape(jadamw(1e-3)[0], sds)}
    jtree, _ = jckpt.restore_checkpoint(launch_dir, 2, like)
    jflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert set(jflat) == set(want)
    for path, w in want.items():
        assert jflat[path].dtype == w.dtype and np.array_equal(
            jflat[path], w), path
