"""Port parity, checkpoints and the training loop: `repro_torch.ckpt`,
`train.loop`, the launchers `launch.train` and `launch.train_lm_w1a8`, and
a trained model deployed and served, on the CPU at the reduced configs.

Tolerances, and why:

* checkpoints: exact. The same numpy tree saved by either package gives
  equal ``manifest.json`` files and byte-identical ``.npy`` files, and
  each package restores the other's bit for bit.
* the loop: a run restarted from its checkpoint reaches the step count
  and checkpoints of an uninterrupted one; the restored state equals the
  saved one bit for bit.
* the trained model, deployed: the packed forward (the popcount matmul's
  plain version on the CPU) within 1e-4·max|logit| of the unpacked
  ``w1a8_eval`` forward of the same trained tree, codes that round across
  a tie forced to the unpacked run's (`train.ties`). The packed path forms
  Σ code·sign exactly and multiplies by α·step once, where ``w1a8_eval``
  sums code·step·sign in f32: a few roundings apart a projection.
"""
import argparse
import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import packed as jpacked  # noqa: E402
from repro_torch import ckpt, configs, convert  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.quant import fold_codes_to_uniform_step  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch import train_lm_w1a8  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models.transformer import tree_items  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import deploy_lm  # noqa: E402
from repro_torch.train import ties  # noqa: E402
from repro_torch.train.loop import resume_or_init, run_train  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The reduced configs' ops are tiny: one intra-op thread runs them
    many times faster than a pool that several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARITY_TOL = 1e-4


def _quiet(*_):
    pass


def _leaves_equal(a, b) -> bool:
    ia, ib = tree_items(a), tree_items(b)
    return [p for p, _ in ia] == [p for p, _ in ib] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(ia, ib))


# ---------------------------------------------------------------------------
# The reference's checkpoint and loop tests, on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_latest(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)},
            "s": (torch.zeros(2), torch.full((), 3, dtype=torch.int32))}
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save_checkpoint(d, 3, tree, metadata={"x": 1})
    ckpt.save_checkpoint(d, 7, transformer.tree_map(lambda x: x * 2, tree))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # never committed
    assert ckpt.latest_step(d) == 7
    restored, meta = ckpt.restore_checkpoint(d, 3, tree, device="cpu")
    assert meta == {"x": 1}
    assert _leaves_equal(restored, tree)
    # a template on meta restores the same
    meta_tree = transformer.tree_map(lambda x: x.to("meta"), tree)
    restored, _ = ckpt.restore_checkpoint(d, 7, meta_tree, device="cpu")
    assert _leaves_equal(restored, transformer.tree_map(lambda x: x * 2, tree))
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_checkpoint(d, 3, {**tree, "a": torch.zeros(3, 2)},
                                device="cpu")


def test_checkpoint_async_commit(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, {"w": torch.zeros(128, 128)}, async_=True)
    ckpt.wait_for_async()
    assert ckpt.latest_step(d) == 1


def test_async_save_snapshots_cpu_tensors(tmp_path):
    """An update made to a CPU tensor right after ``save_checkpoint(...,
    async_=True)`` returns does not reach the file: the save copied it
    (``tensor.numpy()`` of a CPU tensor is a view)."""
    leaves = {f"l{i:02d}": torch.full((256, 256), float(i))
              for i in range(40)}
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, leaves, async_=True)
    for v in leaves.values():                  # the next step's update
        v.add_(1000.0)
    ckpt.wait_for_async()
    restored, _ = ckpt.restore_checkpoint(d, 1, leaves, device="cpu")
    for i, (k, v) in enumerate(sorted(restored.items())):
        assert torch.equal(v, torch.full((256, 256), float(i))), k


def _granite_setup(seed=3):
    cfg = configs.get_reduced("granite-20b")
    opt = adamw(1e-3)
    step_fn = make_train_step(cfg, opt, remat=False)
    ds = data.make_lm_dataset(cfg.vocab_size, 8, 4)

    def batch_fn(i):
        t, lab = data.lm_batch(ds, i, device="cpu")
        return {"tokens": t, "labels": lab}
    params = transformer.init_lm_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")
    return opt, step_fn, batch_fn, params


def test_run_train_with_restart(tmp_path):
    """tests/test_train.py::test_run_train_with_restart, and the restarted
    run's params and state equal an uninterrupted run's bit for bit."""
    opt, step_fn, batch_fn, params = _granite_setup()
    state = opt[0](params)
    d = str(tmp_path / "a")
    p1, s1, n1 = run_train(train_step=step_fn, params=params,
                           opt_state=state, batch_fn=batch_fn, steps=4,
                           ckpt_dir=d, ckpt_every=2, async_ckpt=False,
                           print_fn=_quiet)
    assert n1 == 4 and ckpt.latest_step(d) == 4
    template = {"params": params, "opt_state": state}
    restored, meta = ckpt.restore_checkpoint(d, 4, template, device="cpu")
    assert _leaves_equal(restored, {"params": p1, "opt_state": s1})
    assert np.isfinite(meta["loss"])
    p2, s2, n2 = run_train(train_step=step_fn, params=restored["params"],
                           opt_state=restored["opt_state"],
                           batch_fn=batch_fn, steps=6, start_step=4,
                           ckpt_dir=d, ckpt_every=2, async_ckpt=False,
                           print_fn=_quiet)
    assert n2 == 6 and ckpt.latest_step(d) == 6
    p3, s3, _ = run_train(train_step=step_fn, params=params, opt_state=state,
                          batch_fn=batch_fn, steps=6, print_fn=_quiet)
    assert _leaves_equal({"p": p2, "s": s2}, {"p": p3, "s": s3})


def test_run_train_preemption(tmp_path):
    opt, step_fn, batch_fn, params = _granite_setup()
    d = str(tmp_path)
    open(os.path.join(d, "PREEMPT"), "w").close()
    lines = []
    _, _, n = run_train(train_step=step_fn, params=params,
                        opt_state=opt[0](params), batch_fn=batch_fn,
                        steps=100, ckpt_dir=d, ckpt_every=50,
                        async_ckpt=False, print_fn=lines.append)
    assert n == 1                      # preempted at the first boundary
    assert ckpt.latest_step(d) == 1
    assert lines[0].startswith("step     0 loss ")
    assert lines[-1] == "[preempt] checkpointed at step 1; exiting"


def test_run_train_raises_on_a_diverged_loss():
    opt, step_fn, batch_fn, params = _granite_setup()

    def nan_step(p, s, b):
        p, s, m = step_fn(p, s, b)
        return p, s, {**m, "loss": torch.tensor(float("nan"))}
    with pytest.raises(FloatingPointError, match="step 0"):
        run_train(train_step=nan_step, params=params,
                  opt_state=opt[0](params), batch_fn=batch_fn, steps=2,
                  print_fn=_quiet)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

def _np_state(kind: str) -> dict:
    """A numpy tree of reduced chatglm3-6b params (float, or packed by the
    reference's ``deploy_lm``: uint32 sign words) and an AdamW state over
    the float params, as the reference's ``init`` lays it out, with
    non-zero moments and an int32 step."""
    jcfg = jconfigs.get_reduced("chatglm3-6b")
    jp = jtransformer.init_lm_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(5)
    moment = lambda x: rng.standard_normal(np.shape(x)).astype(  # noqa: E731
        np.float32)
    params = jax.tree_util.tree_map(np.asarray, jp)
    opt = {"mu": jax.tree_util.tree_map(moment, params),
           "nu": jax.tree_util.tree_map(lambda x: np.abs(moment(x)), params),
           "step": np.asarray(7, np.int32)}
    if kind == "packed":
        params = jax.tree_util.tree_map(np.asarray, jpacked.deploy_lm(jp))
    return {"params": params, "opt_state": opt}


def _files(d: str) -> dict:
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_checkpoint_files_equal_the_reference(tmp_path, kind):
    """The same numpy tree saved by the reference and by the port:
    equal manifests (leaf order, keystr paths, shapes, dtypes) and
    byte-identical ``.npy`` files."""
    tree = _np_state(kind)
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save_checkpoint(jd, 12, jax.tree_util.tree_map(jnp.asarray, tree),
                          metadata={"loss": 1.25})
    ckpt.save_checkpoint(td, 12, convert.lm_params_from_numpy(
        tree, device="cpu"), metadata={"loss": 1.25})
    jf, tf = (_files(os.path.join(d, "step_00000012")) for d in (jd, td))
    assert list(jf) == list(tf)
    manifest = json.loads(jf["manifest.json"])
    assert manifest == json.loads(tf["manifest.json"])
    assert jf == tf
    dtypes = {e["dtype"] for e in manifest["arrays"]}
    assert dtypes == ({"float32", "int32", "uint32"} if kind == "packed"
                      else {"float32", "int32"})
    assert manifest["arrays"][0]["path"] == "['opt_state']['mu']['embed']['emb']"


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_checkpoints_restore_across_packages(tmp_path, kind):
    """Each package restores the other's checkpoint exactly: the port
    reads the reference's into its int32 carriers, the reference reads the
    port's into its uint32 words."""
    tree = _np_state(kind)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = convert.lm_params_from_numpy(tree, device="cpu")
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save_checkpoint(jd, 3, jtree, metadata={"loss": 2.5})
    ckpt.save_checkpoint(td, 3, ttree, metadata={"loss": 2.5})
    template = transformer.tree_map(lambda x: x.to("meta"), ttree)
    got, meta = ckpt.restore_checkpoint(jd, 3, template, device="cpu")
    assert meta == {"loss": 2.5} and _leaves_equal(got, ttree)
    assert got["opt_state"]["step"].dtype == torch.int32
    back, meta = jckpt.restore_checkpoint(td, 3, jtree)
    assert meta == {"loss": 2.5}
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jtree)[0]):
        assert pa == pb and a.dtype == b.dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# resume_or_init and the launchers
# ---------------------------------------------------------------------------

def test_resume_or_init_template_on_meta(tmp_path):
    """The template is built on ``meta``: chatglm3-6b's full tree and its
    AdamW state (18.7 G elements) allocate nothing. With a checkpoint,
    `resume_or_init` restores it and never inits on a real device."""
    cfg = configs.get_config("chatglm3-6b")
    opt = adamw(1e-3)

    def full_init(d):
        params = transformer.init_lm_params(cfg, None, device=d)
        return {"params": params, "opt_state": opt[0](params)}
    template = full_init(torch.device("meta"))
    leaves = [x for _, x in tree_items(template)]
    assert all(x.is_meta for x in leaves)
    assert sum(x.numel() for x in leaves) == \
        3 * transformer.count_lm_params(template["params"]) + 1

    rcfg = configs.get_reduced("chatglm3-6b")
    calls = []

    def init_fn(d):
        calls.append(d.type)
        gen = torch.Generator().manual_seed(0) if d.type != "meta" else None
        params = transformer.init_lm_params(rcfg, gen, device=d)
        return {"params": params, "opt_state": opt[0](params)}
    d = str(tmp_path)
    state, start = resume_or_init(d, init_fn, device="cpu", print_fn=_quiet)
    assert start == 0 and calls == ["meta", "cpu"]
    ckpt.save_checkpoint(d, 5, state)
    calls.clear()
    lines = []
    restored, start = resume_or_init(d, init_fn, device="cpu",
                                     print_fn=lines.append)
    assert start == 5 and calls == ["meta"]
    assert lines == [f"[resume] restored step 5 from {d}"]
    assert _leaves_equal(restored, state)


def _run_main(main, argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = main(argv)
    lines = out.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(rec))
    return rec, lines


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_launch_train_every_arch_on_the_cpu(arch):
    rec, lines = _run_main(launch_train.main, [
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
        "--seq-len", "8", "--global-batch", "2"])
    assert rec["steps"] == 2 and rec["device"] == "cpu"
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["last_loss"])
    assert rec["peak_memory_bytes"] is None and rec["tokens_per_s"] > 0
    assert lines[0].startswith("step     0 loss ")


@pytest.mark.parametrize("flags", [
    ["--optimizer", "adafactor", "--microbatches", "2"],
    ["--optimizer", "sgdm", "--mode", "float"]])
def test_launch_train_flags_and_resume(tmp_path, flags):
    base = ["--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
            "--seq-len", "8", "--global-batch", "4",
            "--ckpt-dir", str(tmp_path)] + flags
    first, _ = _run_main(launch_train.main, base + ["--steps", "2"])
    assert first["steps"] == 2 and ckpt.latest_step(str(tmp_path)) == 2
    again, lines = _run_main(launch_train.main, base + ["--steps", "3"])
    assert again["start_step"] == 2 and again["steps"] == 3
    assert lines[0] == f"[resume] restored step 2 from {tmp_path}"


# a value of each mesh flag that argparse refuses, and why: the sharded
# model's --production-mesh is a switch (store_true), which takes no value;
# the pipeline flags take the reference's choices and types
# (src/repro/launch/train.py:30-41)
MESH_FLAG_REFUSALS = {
    "--production-mesh": ("1f1b", "unrecognized arguments"),
    "--pipeline": ("zb-h1", "invalid choice"),
    "--pipeline-stages": ("1f1b", "invalid int value"),
    "--grad-wire": ("bf16", "invalid choice")}


@pytest.mark.parametrize("flag", list(MESH_FLAG_REFUSALS))
def test_launch_train_rejects_the_mesh_flags(flag, capsys):
    value, why = MESH_FLAG_REFUSALS[flag]
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--arch", "chatglm3-6b", flag, value])
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("flag,values", [
    ("--pipeline", ["none", "gpipe", "1f1b"]),
    ("--pipeline-stages", ["1", "2", "4", "16"]),
    ("--grad-wire", ["fp32", "int8"])])
def test_launch_train_mesh_flags_take_the_reference_s_choices(flag, values):
    for v in values:
        args = launch_train.parse_args(["--arch", "chatglm3-6b", flag, v])
        got = getattr(args, flag[2:].replace("-", "_"))
        assert got == (int(v) if flag == "--pipeline-stages" else v)


def test_launch_train_pipeline_stages_must_divide_the_world():
    """One rank (no torchrun) does not split into 2 stages: the reference's
    message, and the process group is gone after."""
    import torch.distributed as dist
    with pytest.raises(SystemExit, match="1 devices do not split into 2 "
                                         "pipeline stages"):
        launch_train.main(["--arch", "qwen2.5-14b", "--reduced", "--device",
                           "cpu", "--pipeline", "1f1b", "--pipeline-stages",
                           "2", "--steps", "1"])
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="adafactor"):
        launch_train.main(["--arch", "qwen2.5-14b", "--reduced", "--device",
                           "cpu", "--pipeline", "1f1b", "--optimizer",
                           "adafactor"])


def test_launch_train_production_mesh_rules():
    """--production-mesh parses as a switch; with --pipeline it exits with
    the reference's message; a world of one rank (no torchrun) exits
    naming the 256 ranks it needs, and the process group is gone after."""
    import torch.distributed as dist
    base = ["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu"]
    assert launch_train.parse_args(base + ["--production-mesh"]) \
        .production_mesh
    assert not launch_train.parse_args(base).production_mesh
    with pytest.raises(SystemExit, match=r"^--pipeline and --production-mesh"
                                         r" are separate mesh layouts; pick "
                                         r"one$"):
        launch_train.main(base + ["--production-mesh", "--pipeline", "1f1b"])
    with pytest.raises(SystemExit, match="needs 256 ranks"):
        launch_train.main(base + ["--production-mesh", "--steps", "1"])
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="adafactor"):
        launch_train.main(base + ["--production-mesh", "--optimizer",
                                  "adafactor"])


def test_launch_train_defaults_are_the_reference_s():
    args = launch_train.parse_args(["--arch", "mamba2-1.3b"])
    assert (args.steps, args.seq_len, args.global_batch, args.microbatches,
            args.lr, args.mode, args.optimizer, args.reduced, args.ckpt_dir,
            args.seed, args.device) == (100, 128, 8, 1, 3e-4, "w1a8_train",
                                        "adamw", False, None, 0, None)
    assert (args.pipeline, args.pipeline_stages, args.grad_wire,
            args.production_mesh) == ("none", 4, "fp32", False)


def test_launch_train_pipelined_on_one_rank(tmp_path):
    """--pipeline without torchrun: a world of one gloo rank, one stage;
    the JSON line names the world, the mesh and the backend, and the
    checkpoint resumes in the one-device launcher."""
    base = ["--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
            "--seq-len", "8", "--global-batch", "4",
            "--ckpt-dir", str(tmp_path)]
    rec, lines = _run_main(launch_train.main, base + [
        "--steps", "2", "--pipeline", "gpipe", "--pipeline-stages", "1",
        "--microbatches", "2", "--grad-wire", "int8"])
    assert lines[0] == "[pipeline] gpipe n=1 M=2 bubble=0.000 grad-wire=int8"
    assert (rec["world"], rec["mesh"], rec["backend"], rec["steps"]) == \
        (1, {"data": 1, "stage": 1}, "gloo", 2)
    again, lines = _run_main(launch_train.main, base + ["--steps", "3"])
    assert again["start_step"] == 2 and again["steps"] == 3


def test_launch_train_lm_w1a8(tmp_path):
    """The port's copy of examples/train_lm_w1a8.py: preempted half-way
    by the sentinel, restored exactly, finished."""
    rec, lines = _run_main(train_lm_w1a8.main, [
        "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)])
    assert rec["stopped_at"] == 2 and rec["restored_step"] == 2
    assert rec["restored_equal_saved"] is True
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["last_loss"])
    assert "[preempt] checkpointed at step 2; exiting" in lines
    assert "restart e2e OK" in lines
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert not os.path.exists(os.path.join(str(tmp_path), "PREEMPT"))


# ---------------------------------------------------------------------------
# Deploy after training
# ---------------------------------------------------------------------------

def _trained(name: str, steps: int = 4):
    cfg = configs.get_reduced(name)
    params = transformer.init_lm_params(cfg, torch.Generator().manual_seed(4),
                                        device="cpu")
    opt = adamw(3e-3)
    train = make_train_step(cfg, opt, remat=False)
    state = opt[0](params)
    ds = data.make_lm_dataset(cfg.vocab_size, 16, 4)
    for i in range(steps):
        t, lab = data.lm_batch(ds, i, device="cpu")
        params, state, _ = train(params, state, {"tokens": t, "labels": lab})
    return cfg, params


@pytest.mark.parametrize("name", ["chatglm3-6b", "mixtral-8x7b"])
def test_trained_model_deploys_and_serves(name):
    """Trained 4 steps (each projection's LSQ step moved on its own), then
    `deploy_lm`: no leaf keeps a grad or a graph, each packed projection
    holds its own step broadcast to (K,) (so the popcount wrapper's fold
    is the identity), the packed forward equals the unpacked ``w1a8_eval``
    one within PARITY_TOL·max|logit| with tie codes forced, and
    `LMBackend` serves the tree (done-mask tokens equal host-checked)."""
    cfg, params = _trained(name)
    steps = [x for p, x in tree_items(params) if p.endswith("['act_step']")]
    assert len({round(float(s.flatten()[0]), 7) for s in steps}) > 1
    # a trained tree whose leaves require grad (and hold one)
    leaves = transformer.tree_map(lambda p: p.detach().requires_grad_(True),
                                  params)
    for _, leaf in tree_items(leaves):
        leaf.grad = torch.ones_like(leaf)
    packed = deploy_lm(leaves)
    for path, leaf in tree_items(packed):
        assert not leaf.requires_grad and leaf.grad is None, path
        assert leaf.grad_fn is None, path
    n_proj = 0
    for path, leaf in tree_items(packed):
        if not path.endswith("['w_packed']") or leaf.ndim != 3:
            continue
        node = path[:-len("['w_packed']")]
        step = dict(tree_items(packed))[node + "['act_step']"]
        src = dict(tree_items(params))[node + "['act_step']"]
        assert step.shape[0] == leaf.shape[0]
        assert packing.packed_dim(step.shape[1]) == leaf.shape[1]
        for st in range(leaf.shape[0]):
            assert torch.equal(step[st], torch.full_like(step[st], src[st]))
            codes = torch.randint(0, 256, (5, step.shape[1]),
                                  dtype=torch.uint8)
            folded, mbar = fold_codes_to_uniform_step(codes, step[st])
            assert torch.equal(folded, codes) and float(mbar) == float(src[st])
        n_proj += 1
    assert n_proj >= 4                  # q, k, v, o at least

    prompts = data.lm_batch(data.make_lm_dataset(cfg.vocab_size, 12, 3),
                            99, device="cpu")[0]
    with torch.no_grad():
        with ties.record("quantize_act", module=layers) as recorded:
            want = transformer.lm_forward(cfg, params, prompts,
                                          mode="w1a8_eval")
        with ties.forced(recorded, "quantize_act", module=layers):
            got = transformer.lm_forward(cfg, packed, prompts,
                                         mode="w1a8_eval")
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= PARITY_TOL * scale

    args = argparse.Namespace(
        workload="lm", arch=name, reduced=True, packed=True, requests=3,
        max_new=4, slots=2, max_len=32, temperature=0.0, stop_token=[],
        seed=0, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        record = launch_serve.run_lm(args, params=params)
    assert record["packed"] and len(record["tokens_by_rid"]) == 3
    assert all(len(t) == 4 for t in record["tokens_by_rid"].values())
    assert record["kernel_launches_per_decode_step"] == {}   # the CPU
