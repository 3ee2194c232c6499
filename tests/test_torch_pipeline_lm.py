"""Port parity, the pipelined LM train step and the launcher's
``--pipeline``, on the CPU: the reduced qwen2.5-14b (2 layers, d 64,
vocab 128) on a (data 2, stage 2) mesh of four gloo ranks
(`torch_ranks.spawn`, once for the module), M = 2 microbatches a data
shard, SGD-M, against `make_train_step` of both packages on one device.

The one-device references run with 4 microbatches: the (data, microbatch)
row groups of the pipelined step, in the same order. LSQ's step gradient is
scaled by 1/sqrt(numel·255) per call, so a call over half the rows gives
a step gradient √2 times as large: only the same row groups compare.

Tolerances, and why:

* f32 grad wire: loss, gradient norm and every clipped gradient (the SGD-M
  moment after one step) within 1e-5 relative of the reference's (the same
  math summed in another order: stage by stage, rank by rank).
* int8 grad wire: the loss within 5e-3 of the reference's, as
  tests/dist_main.py's pipelined LM check asks; each clipped gradient leaf
  within 2% of its max|g| of the f32 ones (two int8 legs, each half a
  code of a data rank's abs-max over 127) and off them (the wire is on).
* codes that round across a tie between the one-device run and a rank's
  forward are forced to the reference's (`train.ties`, each within 1e-3
  of a tie or a rail in both runs): every rank's quantizer calls, the
  recompute of the backward included, follow the schedule's tick table
  (`dist.pipeline.stage_calls`), so each call is matched to its recorded
  input; the count forced is printed.
* the replicated leaves (embedding, final norm) are equal bit for bit on
  all four ranks after the step, and each stage's slices on both data
  ranks.
* the global norm: every rank clips by the one norm of the whole tree, which
  no stage's own sum of squares gives (the embedding's gradient dominates
  it at this size: a stage's own norm is some 5e-4 off).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from repro import ckpt as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import init_lm_params as jinit  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import sgdm as jsgdm  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import ckpt, configs, convert  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import tree_items  # noqa: E402
from repro_torch.optim import sgdm  # noqa: E402
from repro_torch.train import step, ties  # noqa: E402

ARCH = "qwen2.5-14b"
WORLD, STAGES, MICRO = 4, 2, 2
B, S = 8, 16
LR, MAX_NORM = 1e-2, 0.5          # the clip is on: the norm is some 1.35
# the int8 grad wire, per leaf: two legs, each within half a code of a
# scale set by the larger data rank's abs-max (about 1.1% of the mean's max
# seen; the tree-relative error of heavy-tailed leaves such as the
# embedding's reaches 3.6%)
INT8_LEAF_TOL = 0.02
RUNS = {"1f1b-fp32": {"schedule": "1f1b", "grad_wire": "fp32"},
        "gpipe-fp32": {"schedule": "gpipe", "grad_wire": "fp32"},
        "1f1b-int8": {"schedule": "1f1b", "grad_wire": "int8"}}
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Record:
    """Every input of the reference's ``layers.lsq_fake_quant``, in call
    order, by an ordered host callback (jitted and scanned calls too)."""

    def __init__(self):
        self.inputs, self.real = [], jlayers.lsq_fake_quant

    def __enter__(self):
        def recording(x, s, gs):
            jax.debug.callback(lambda v: self.inputs.append(np.array(v)), x,
                               ordered=True)
            return self.real(x, s, gs)
        jlayers.lsq_fake_quant = recording
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        jlayers.lsq_fake_quant = self.real


def _flat(tree) -> dict:
    return {p: np.asarray(v) for p, v in tree_items(tree)}


def _rel(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    d = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
            for k in want)
    n = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return (d / n) ** 0.5


def _jtree_flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's one-device step, the port's, and the four ranks'."""
    jcfg, cfg = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    jparams = jinit(jax.random.PRNGKey(9), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    ds = data.make_lm_dataset(cfg.vocab_size, S, B, seed=3)
    tok, lab = data.lm_batch(ds, 0, device="cpu")
    batch = {"tokens": tok.numpy(), "labels": lab.numpy()}
    micro = (WORLD // STAGES) * MICRO
    jopt = jsgdm(LR)
    jstep_fn = jax.jit(jstep.make_train_step(
        jcfg, jopt, remat=False, microbatches=micro, max_grad_norm=MAX_NORM))
    with _Record() as rec:
        _, jstate, jm = jstep_fn(jparams, jopt[0](jparams),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        jax.block_until_ready(jstate)
    want = {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
            "m": _jtree_flat(jstate["m"])}

    opt = sgdm(LR)
    params = convert.lm_params_from_numpy(params_np, device="cpu")
    one = step.make_train_step(cfg, opt, remat=False, microbatches=micro,
                               max_grad_norm=MAX_NORM)
    with ties.forced([torch.from_numpy(a) for a in rec.inputs],
                     "lsq_fake_quant", module=layers) as counts:
        _, state, m = one(params, opt[0](params),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    port = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "m": _flat(state["m"]), "forced": sum(counts)}

    inputs = {"arch": ARCH, "stages": STAGES, "num_micro": MICRO,
              "params": params_np, "batch": batch, "lr": LR,
              "max_norm": MAX_NORM, "recorded": rec.inputs, "runs": RUNS}
    ranks = torch_ranks.spawn("lm_pipeline", WORLD, inputs,
                              tmp_path_factory.mktemp("lm_ranks"),
                              timeout=120.0)
    return want, port, ranks


def _whole(ranks: list, name: str, key: str) -> dict:
    """The one-device tree from data rank 0's stage slices."""
    by_stage = {r["stage"]: _flat(r[name][key]) for r in ranks
                if r["shard"] == 0}
    out = {}
    for path in by_stage[0]:
        if path.startswith("['slots']"):
            out[path] = np.concatenate([by_stage[s][path]
                                        for s in range(STAGES)])
        else:
            out[path] = by_stage[0][path]
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_pipelined_step_against_one_device(runs, run):
    want, port, ranks = runs
    for r in ranks:
        assert r[run]["calls"] == r[run]["planned"]
    forced = sum(r[run]["forced"] for r in ranks)
    print(f"{run}: {forced} quantizer inputs forced at ties or rails over "
          f"the four ranks ({port['forced']} in the port's one-device step)")
    loss = float(ranks[0][run]["loss"])
    m = _whole(ranks, run, "m")
    if run.endswith("int8"):
        assert abs(loss - want["loss"]) < 5e-3
        fp32 = _whole(ranks, "1f1b-fp32", "m")
        assert _rel(m, fp32) > 1e-7             # the wire is on
        for ref in (fp32, want["m"]):
            for path, g in ref.items():
                err = np.abs(m[path] - g).max()
                assert err <= INT8_LEAF_TOL * np.abs(g).max(), path
        return
    for ref in (want, port):
        assert abs(loss / ref["loss"] - 1) < 1e-5
        assert abs(float(ranks[0][run]["grad_norm"]) / ref["grad_norm"]
                   - 1) < 1e-5
        assert _rel(m, ref["m"]) < 1e-5
    assert any("act_step" in p and np.abs(v).max() > 0 for p, v in m.items())


@pytest.mark.parametrize("run", sorted(RUNS))
def test_replicated_leaves_equal_across_ranks(runs, run):
    _, _, ranks = runs
    first = _flat(ranks[0][run]["params"])
    for r in ranks[1:]:
        got = _flat(r[run]["params"])
        for path, v in got.items():
            if not path.startswith("['slots']"):
                np.testing.assert_array_equal(v, first[path], err_msg=path)
        twin = next(t for t in ranks if t["stage"] == r["stage"]
                    and t["shard"] != r["shard"])
        for path, v in _flat(twin[run]["params"]).items():
            np.testing.assert_array_equal(v, got[path], err_msg=path)


def test_global_norm_spans_the_stages(runs):
    """Each rank holds one stage's gradients; clipped by its own norm, the
    stages would scale by different factors. Every rank clips by the whole
    tree's norm, the reference's."""
    want, _, ranks = runs
    run = "1f1b-fp32"
    norms = {float(r[run]["grad_norm"]) for r in ranks}
    assert len(norms) == 1
    gnorm = norms.pop()
    assert gnorm > MAX_NORM                     # the clip is on
    assert abs(gnorm / want["grad_norm"] - 1) < 1e-5
    local = {r["stage"]: float(r[run]["local_sq"]) for r in ranks}
    m = _whole(ranks, run, "m")
    rep = sum(float(np.sum(v.astype(np.float64) ** 2)) for p, v in m.items()
              if not p.startswith("['slots']"))
    # the moments are clipped: scale them back to the unclipped squares
    clip = (MAX_NORM / (gnorm + 1e-9)) ** 2
    # a stage clipping by its own norm would be off by more than ten times
    # the 1e-5 that the gradients are held to
    for s in range(STAGES):
        own = ((rep + local[s]) / clip) ** 0.5
        assert abs(own / gnorm - 1) > 1e-4, (s, own, gnorm)
    total = ((rep + sum(local.values())) / clip) ** 0.5
    assert abs(total / gnorm - 1) < 1e-5


# ---------------------------------------------------------------------------
# The launcher under torchrun
# ---------------------------------------------------------------------------

def _torchrun(args, timeout=120) -> tuple:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train",
           *args]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-1]), lines


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """A pipelined launcher run preempted by the sentinel after its first
    step, then resumed to step 3."""
    d = str(tmp_path_factory.mktemp("pipe_ckpt"))
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--pipeline",
            "1f1b", "--pipeline-stages", str(STAGES), "--microbatches", "2",
            "--grad-wire", "int8", "--seq-len", "8", "--steps", "3",
            "--ckpt-dir", d]
    open(os.path.join(d, "PREEMPT"), "w").close()
    first, first_lines = _torchrun(base)
    assert ckpt.latest_step(d) == 1
    os.remove(os.path.join(d, "PREEMPT"))
    again, again_lines = _torchrun(base)
    return d, (first, first_lines), (again, again_lines)


def test_launcher_preempted_and_resumed(launched):
    d, (first, lines1), (again, lines2) = launched
    assert lines1[0] == "[pipeline] 1f1b n=2 M=2 bubble=0.200 grad-wire=int8"
    assert "[preempt] checkpointed at step 1; exiting" in lines1
    assert first["steps"] == 1 and first["world"] == WORLD
    assert first["mesh"] == {"data": 2, "stage": 2}
    assert (first["pipeline"], first["grad_wire"], first["backend"]) == \
        ("1f1b", "int8", "gloo")
    assert first["bubble"] == pytest.approx(0.2)
    assert f"[resume] restored step 1 from {d}" in lines2
    assert again["start_step"] == 1 and again["steps"] == 3
    assert np.isfinite(again["last_loss"]) and ckpt.latest_step(d) == 3
    # only rank 0 prints
    assert sum(line.startswith("{") for line in lines2) == 1


def test_launcher_checkpoint_restores_in_both_packages(launched):
    """The pipelined checkpoint is the one-device layout: the one-device
    launcher resumes from it, and the reference restores it leaf for leaf
    equal to the port's restore."""
    d = launched[0]
    out, lines = _one_device(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--seq-len", "8", "--steps", "4",
                              "--ckpt-dir", d])
    assert out["start_step"] == 3 and out["steps"] == 4
    assert lines[0] == f"[resume] restored step 3 from {d}"
    jcfg = jconfigs.get_reduced(ARCH)
    sds = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    like = {"params": sds, "opt_state": jax.eval_shape(jadamw(1e-3)[0], sds)}
    jtree, _ = jckpt.restore_checkpoint(d, 3, like)
    cfg = configs.get_reduced(ARCH)
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim import adamw
    meta = init_lm_params(cfg, None, device="meta")
    tree, _ = ckpt.restore_checkpoint(
        d, 3, {"params": meta, "opt_state": adamw(1e-3)[0](meta)},
        device="cpu")
    want = _jtree_flat(jtree)
    got = {p: convert.lm_leaf_to_numpy(v) for p, v in tree_items(tree)}
    assert set(got) == set(want)
    for p, v in got.items():
        assert v.dtype == want[p].dtype and np.array_equal(v, want[p]), p


def _one_device(argv) -> tuple:
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = launch_train.main(argv)
    return rec, buf.getvalue().strip().splitlines()
