"""Port parity, LM training: `core.quant`'s sign accumulation, the LM
sampler, `lm_loss` and its gradients, `make_train_step` (microbatches,
clip, AdamW) and remat, against `repro` on the CPU at the reduced configs
(2 to 8 layers, d 64, vocab 128), the same numpy params and batches in
both packages (the port's sampler's batches: ``jax.random`` draws cannot
be reproduced without JAX).

Tolerances, and why:

* `sign_accumulate` / `sign_accumulate_fused`: bit for bit (integer sums;
  the f32 case sums integers below 2^24).
* `lm_loss`: rtol 1e-5. The same f32 forward summed in another order
  (one rounding of a 64-term sum is some 1e-7 relative; 2 to 8 layers and
  a 128-way log-softmax keep it below 1e-5).
* the gradients, every leaf: within 1e-3·max|g| of that leaf. The
  backward multiplies the forward's rounding differences through every
  layer, and LSQ's step gradient sums over every input of its projection.
* two AdamW steps: loss and gradient norm rtol 1e-4 (the first update,
  ±lr wherever a gradient is not tiny, carries the difference into every
  param).
* microbatches 2 against 1: loss rtol 1e-5, each weight's gradient
  within 1e-5·max|g|; the LSQ steps' gradients are √2 times those of one
  batch (LSQ's gradient scale 1/sqrt(numel·255) is per call, and a call
  sees half the inputs), within the same tolerance.
* remat against none: bit for bit (the same ops recomputed).

A float32 sum in another order moves an activation across a rounding tie
now and then, and the flipped code spreads through every later layer. So
the port's forward runs with the reference's codes forced where they differ
(`train.ties`, each within 1e-3 of a tie in both runs), recorded through
an ordered host callback on the reference's `lsq_fake_quant` (the
projections' and the MoE experts').
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models import layers, moe, transformer  # noqa: E402
from repro_torch.models.transformer import tree_items  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step, ties  # noqa: E402

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The reduced configs' ops are tiny: one intra-op thread runs them
    many times faster than a pool that several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("chatglm3-6b", "gemma2-27b", "mixtral-8x7b", "mamba2-1.3b",
         "jamba-1.5-large-398b", "seamless-m4t-medium", "internvl2-76b")
B, S = 2, 8


# ---------------------------------------------------------------------------
# Eq. 3-2 / 3-4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_sign_accumulate_bit_exact(dtype):
    rng = np.random.default_rng(3)
    acts = rng.integers(0, 256, (5, 7, 96)).astype(dtype)
    signs = np.where(rng.random((96, 40)) < 0.5, -1, 1).astype(dtype)
    mul = rng.integers(1, 9, (96,)).astype(dtype)
    got = quant.sign_accumulate(torch.from_numpy(acts),
                                torch.from_numpy(signs))
    want = np.asarray(jquant.sign_accumulate(jnp.asarray(acts),
                                             jnp.asarray(signs)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    got = quant.sign_accumulate_fused(torch.from_numpy(acts),
                                      torch.from_numpy(mul),
                                      torch.from_numpy(signs))
    want = np.asarray(jquant.sign_accumulate_fused(
        jnp.asarray(acts), jnp.asarray(mul), jnp.asarray(signs)))
    np.testing.assert_array_equal(got.numpy(), want)
    # integer-exact: the int64 product
    np.testing.assert_array_equal(
        got.numpy(), (acts.astype(np.int64) * mul.astype(np.int64))
        @ signs.astype(np.int64))


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

def _transitions_ok(tokens: np.ndarray, v: int) -> np.ndarray:
    """Per row, the share of transitions t-1 → t that follow
    x_t = (31·x_{t-1} + c) mod V for the row's most common c ∈ [0, 7)."""
    d = (tokens[:, 1:].astype(np.int64)
         - 31 * tokens[:, :-1].astype(np.int64)) % v
    out = []
    for row in d:
        counts = np.bincount(row[row < 7], minlength=7)
        out.append(counts.max() / len(row))
    return np.asarray(out)


def test_lm_batch_deterministic_and_sharded():
    """tests/test_train.py::test_data_pipeline_deterministic_and_sharded,
    on the port's sampler."""
    ds = data.make_lm_dataset(1000, 32, 16)
    a1, _ = data.lm_batch(ds, 5, device="cpu")
    a2, _ = data.lm_batch(ds, 5, device="cpu")
    assert torch.equal(a1, a2) and a1.dtype == torch.int32
    b, _ = data.lm_batch(ds, 6, device="cpu")
    assert not torch.equal(a1, b)
    s0, _ = data.lm_batch(ds, 5, shard=0, num_shards=2, device="cpu")
    s1, _ = data.lm_batch(ds, 5, shard=1, num_shards=2, device="cpu")
    assert s0.shape == (8, 32)
    assert not torch.equal(s0, s1)
    other, _ = data.lm_batch(data.make_lm_dataset(1000, 32, 16, seed=1), 5,
                             device="cpu")
    assert not torch.equal(other, a1)


def test_lm_batch_follows_the_reference_recurrence():
    """At 8×256: the port's own draws (x0, then c_b, from
    ``default_rng([seed, step, shard])``) run through the reference's
    recurrence give the stream; the tokens differ from it at 10% ± 3%
    (the noise) and equal it elsewhere; labels are the roll. Both
    packages' batches carry the same bigram structure."""
    v, seed, stp = 65024, 4, 9
    ds = data.make_lm_dataset(v, 256, 8, seed=seed)
    tokens, labels = data.lm_batch(ds, stp, device="cpu")
    tokens, labels = tokens.numpy(), labels.numpy()
    assert tokens.shape == (8, 256) and tokens.dtype == np.int32
    np.testing.assert_array_equal(labels, np.roll(tokens, -1, axis=1))
    assert tokens.min() >= 0 and tokens.max() < v
    rng = np.random.default_rng([seed, stp, 0])
    x = rng.integers(0, v, (8, 1)).astype(np.int64)
    offs = rng.integers(0, 7, (8, 1))
    clean = []
    for _ in range(256):                 # the reference's scan, x_1 first
        x = (x * (31 % v or 1) + offs) % v
        clean.append(x[:, 0])
    clean = np.stack(clean, 1)
    noise = tokens != clean
    assert 0.07 <= noise.mean() <= 0.13, noise.mean()
    jtok, jlab = jdata.lm_batch(jdata.make_lm_dataset(v, 256, 8, seed=seed),
                                stp)
    for t in (tokens, np.asarray(jtok)):
        ok = _transitions_ok(t, v)
        assert ok.min() >= 0.6 and 0.74 <= ok.mean() <= 0.88, ok


# ---------------------------------------------------------------------------
# The loss and its gradients against the reference
# ---------------------------------------------------------------------------

def _batch_np(cfg, b: int = B, s: int = S, stp: int = 0) -> dict:
    """The port's sampler's batch, and the arch's stub embeddings from
    numpy, as numpy arrays."""
    ds = data.make_lm_dataset(cfg.vocab_size, s, b, seed=1)
    tok, lab = data.lm_batch(ds, stp, device="cpu")
    batch = {"tokens": tok.numpy(), "labels": lab.numpy()}
    rng = np.random.default_rng([7, stp])
    if cfg.family == "encdec":
        batch["encoder_embeds"] = (0.1 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    return batch


class _RecordRef:
    """Within the block, every input of the reference's `lsq_fake_quant`
    (the projections' in ``layers``, the experts' in ``moe``) is appended
    to ``self.inputs[module]`` in call order, by an ordered host callback
    (so jitted, scanned and differentiated calls record too)."""

    MODULES = {"layers": jlayers, "moe": jmoe}

    def __init__(self):
        self.inputs = {name: [] for name in self.MODULES}
        self.real = {name: m.lsq_fake_quant for name, m in
                     self.MODULES.items()}

    def __enter__(self):
        for name, mod in self.MODULES.items():
            def recording(x, s, gs, _name=name):
                jax.debug.callback(
                    lambda v: self.inputs[_name].append(np.array(v)), x,
                    ordered=True)
                return self.real[_name](x, s, gs)
            mod.lsq_fake_quant = recording
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        for name, mod in self.MODULES.items():
            mod.lsq_fake_quant = self.real[name]

    def clear(self):
        for v in self.inputs.values():
            v.clear()


class _forced:
    """The port's `lsq_fake_quant` calls (projections and experts) with the
    recorded reference codes forced where they differ at a tie."""

    def __init__(self, rec: _RecordRef):
        self.ctx = [ties.forced([torch.from_numpy(a) for a in
                                 rec.inputs[name]], "lsq_fake_quant",
                                module=mod)
                    for name, mod in (("layers", layers), ("moe", moe))]

    def __enter__(self):
        self.counts = [c.__enter__() for c in self.ctx]
        return self.counts

    def __exit__(self, *exc):
        for c in reversed(self.ctx):
            c.__exit__(*exc)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """(params, batch, loss, grads by path, recorder) of the reference's
    ``value_and_grad`` of `lm_loss` (w1a8_train, no remat); numpy."""
    jcfg = jconfigs.get_reduced(name)
    jp = jtransformer.init_lm_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch_np(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    def loss_fn(p):
        return jstep.lm_loss(jcfg, p, jb, mode="w1a8_train", remat=False)
    rec = _RecordRef()
    if jcfg.encoder_layers:
        # under value_and_grad, scan's partial evaluation hoists the cross
        # stack's k, v projections of the (stage-invariant) encoder output
        # out of the loop, so they would be recorded once for all stages:
        # record from the forward alone
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
        with rec:
            jax.jit(loss_fn)(jp)
    else:
        with rec:
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
            jax.block_until_ready(grads)
    paths = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
             jax.tree_util.tree_flatten_with_path(grads)[0]}
    return (jax.tree_util.tree_map(np.asarray, jp), batch, float(loss), paths,
            rec)


def _port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_matches_reference(name):
    params_np, batch, want, _, rec = _reference(name)
    cfg = configs.get_reduced(name)
    params = convert.lm_params_from_numpy(params_np, device="cpu")
    with torch.no_grad(), _forced(rec) as counts:
        got = step.lm_loss(cfg, params, _port_batch(batch),
                           mode="w1a8_train", remat=False)
    assert sum(map(len, counts)) == sum(map(len, rec.inputs.values()))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    with pytest.raises(TypeError):        # no ShardCtx on one device
        step.lm_loss(cfg, params, _port_batch(batch), mode="w1a8_train",
                     ctx=object())
    with pytest.raises(TypeError):
        step.make_train_step(cfg, adamw(1e-3), ctx=object())


@pytest.mark.parametrize("name", ARCHS)
def test_lm_grads_match_reference(name):
    """Every gradient leaf against ``jax.value_and_grad`` (the counterpart
    of tests/test_arch_smoke.py::test_train_step_smoke, held to the
    reference's numbers), tie codes forced."""
    params_np, batch, want_loss, want, rec = _reference(name)
    cfg = configs.get_reduced(name)
    params = convert.lm_params_from_numpy(params_np, device="cpu")
    fn = functools.partial(step.lm_loss, cfg, mode="w1a8_train", remat=False)
    with _forced(rec):
        loss, flat = step.loss_and_grads(fn, params, _port_batch(batch))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = dict(tree_items(step.unflatten_like(params, flat)))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == w.shape, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-3 * scale, f"{name} {path}: {err} > 1e-3 * {scale}"
    # the step gradients are there: LSQ reaches every W1A8 projection
    assert any("act_step" in p and float(np.abs(w).max()) > 0
               for p, w in want.items())


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Two AdamW steps, batches of the port's sampler: loss and gradient
    norm per step within rtol 1e-4, the params and the AdamW state after
    each within 1e-3·max|x| of the reference's, codes that differ at a tie
    forced to the reference's. The second step starts from the reference's
    first-step state, carried over by `convert.lm_params_from_numpy`
    (``mu``, ``nu`` and the int32 ``step``): the first update moves each
    LSQ step by about ±lr, and a step one ulp off the reference's moves a
    code across a tie that `train.ties` cannot see (it compares codes at
    the port's step), which changes the next gradients by percents."""
    name = "chatglm3-6b"
    cfg, jcfg = configs.get_reduced(name), jconfigs.get_reduced(name)
    jopt, opt = jadamw(1e-3), adamw(1e-3)
    jtrain = jax.jit(jstep.make_train_step(jcfg, jopt, remat=False,
                                           microbatches=microbatches))
    train = step.make_train_step(cfg, opt, remat=False,
                                 microbatches=microbatches)
    jp = jtransformer.init_lm_params(jax.random.PRNGKey(2), jcfg)
    jstate = jopt[0](jp)
    rec = _RecordRef()        # one recorder: the jitted step keeps its trace
    for i in range(2):
        params, state = (convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, t), device="cpu")
            for t in (jp, jstate))
        assert state["step"].dtype == torch.int32
        batch = _batch_np(cfg, b=4, stp=i)
        rec.clear()
        with rec:
            jp, jstate, jm = jtrain(jp, jstate, {k: jnp.asarray(v) for k, v
                                                 in batch.items()})
        with _forced(rec):
            params, state, m = train(params, state, _port_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert int(m["step"]) == int(jm["step"]) == i + 1
        assert m["step"].dtype == torch.int32
        want = convert.lm_params_from_numpy(jax.tree_util.tree_map(
            np.asarray, {"params": jp, "opt_state": jstate}), device="cpu")
        got = {"params": params, "opt_state": state}
        for (path, a), (wpath, b) in zip(tree_items(got), tree_items(want)):
            assert path == wpath
            scale = max(float(b.abs().max()), 1e-12)
            assert float((a - b).abs().max()) <= 1e-3 * scale, path


def test_microbatches_2_equal_1():
    """tests/test_train.py::test_grad_accum_matches_full_batch: the
    accumulated loss and weight gradients equal one batch's; the LSQ
    steps' gradients are √2 times one batch's (see the module docstring);
    and the step's metrics."""
    cfg = configs.get_reduced("qwen2.5-14b")
    params = transformer.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    batch = _port_batch(_batch_np(cfg, b=8, stp=3))
    fn = functools.partial(step.lm_loss, cfg, mode="w1a8_train", remat=False)
    l1, g1 = step.accumulated_grads(fn, params, batch, 1)
    l2, g2 = step.accumulated_grads(fn, params, batch, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for (path, a), b in zip(tree_items(params), zip(g1, g2)):
        want = b[0] * math.sqrt(2) if "act_step" in path else b[0]
        scale = float(want.abs().max())
        assert float((b[1] - want).abs().max()) <= 1e-5 * scale, path
    with pytest.raises(ValueError, match="microbatches"):
        step.accumulated_grads(fn, params, batch, 3)


@pytest.mark.parametrize("name", ["chatglm3-6b", "mixtral-8x7b",
                                  "mamba2-1.3b", "seamless-m4t-medium"])
def test_remat_equals_no_remat(name):
    """Stricter than tests/test_train.py::test_remat_matches_no_remat
    (1e-5): the loss and every gradient bit for bit."""
    cfg = configs.get_reduced(name)
    params = transformer.init_lm_params(cfg, torch.Generator().manual_seed(1),
                                        device="cpu")
    batch = _port_batch(_batch_np(cfg, stp=3))
    out = {}
    for remat in (False, True):
        fn = functools.partial(step.lm_loss, cfg, mode="w1a8_train",
                               remat=remat)
        out[remat] = step.loss_and_grads(fn, params, batch)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_loss_decreases_lm():
    """tests/test_train.py::test_loss_decreases_lm on the port."""
    cfg = configs.get_reduced("chatglm3-6b")
    params = transformer.init_lm_params(cfg, torch.Generator().manual_seed(2),
                                        device="cpu")
    opt = adamw(3e-3)
    train = step.make_train_step(cfg, opt, remat=False)
    state = opt[0](params)
    ds = data.make_lm_dataset(cfg.vocab_size, 16, 8)
    losses = []
    for i in range(40):
        toks, labels = data.lm_batch(ds, i, device="cpu")
        params, state, m = train(params, state,
                                 {"tokens": toks, "labels": labels})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.25, losses[::8]


def test_ties_force_lsq_rail_flips():
    """An input within an ulp of LSQ's lower rail, on one side of it in
    the recorded run and on the other here, has the same code in both but
    takes the gradient only where it is ≥ 0: `train.ties.forced` gives it
    the recorded run's value, so the gradients agree; one far from the
    rail raises."""
    from repro_torch.core.quant import lsq_fake_quant
    step = torch.tensor(0.05)
    ref = torch.tensor([1e-9, 0.3, 0.71])
    x = torch.tensor([-1e-9, 0.3, 0.71], requires_grad=True)
    mod = type("M", (), {"lsq_fake_quant": staticmethod(lsq_fake_quant)})
    with ties.forced([ref], "lsq_fake_quant", module=mod) as counts:
        y = mod.lsq_fake_quant(x, step, 1.0)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert counts == [1] and torch.equal(g, torch.ones(3))
    with pytest.raises(AssertionError, match="rail"):
        with ties.forced([torch.tensor([0.02, 0.3, 0.71])],
                         "lsq_fake_quant", module=mod):
            mod.lsq_fake_quant(x, step, 1.0)
