"""Port parity, the MoE FFN: the same numpy inputs and params through
`repro.models.moe` and `repro_torch.models.moe` on the CPU, at the reduced
configs (d 64, 4 or 8 experts).

Tolerances, and why:

* float `moe_ffn`: within 1e-5·max|y|. The same f32 products summed in
  another order (one rounding of a sum of 64–96 terms is about 1e-7
  relative; the gates' softmax and the k-term combine add a few more).
* `w1a8_eval` and packed `moe_ffn`: within 1e-4·max|y| with the codes
  that round across a tie forced to the reference's (`train.ties`, each
  within 1e-3 of a tie on both sides). The packed experts form Σ
  code·sign exactly and multiply by α·step once, where the reference sums
  code·step·sign in f32 and multiplies by α: a few roundings apart.
* the `w1a8_train` expert GEMM and its gradients against ``jax.vjp``:
  within 1e-5·max (the same codes from the same input; the step's
  gradient is a sum over every input).
* routing: `plan_dispatch`'s capacity, the top-k indices (ties included)
  and the dropped assignments exactly; `load_balance_loss` within 1e-6
  relative.
* the grouped popcount matmul's plain version: bit for bit against a
  per-expert loop of the 2-D plain version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import packed as jpacked  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.w1a8_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.w1a8_matmul import ref as mm_ref  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.train import ties  # noqa: E402


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return torch.from_numpy(x.view(np.int32).copy())
    return torch.from_numpy(np.array(x))


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def record_ref(monkeypatch, fn):
    """Runs a reference call with every activation quantizer input
    recorded in call order: the projections' `quantize_act`, the MoE
    experts' `lsq_fake_quant` (w1a8_eval) and the packed experts'
    `repro.core.quant.quantize_act`, each through an ordered host
    callback. The experts' LSQ is replaced by its forward value."""
    recorded, real = [], jquant.quantize_act

    def recording(x, step):
        jax.debug.callback(lambda v: recorded.append(np.array(v)), x,
                           ordered=True)
        return real(x, step)
    monkeypatch.setattr(jlayers, "quantize_act", recording)
    monkeypatch.setattr(jquant, "quantize_act", recording)
    monkeypatch.setattr(jmoe, "lsq_fake_quant",
                        lambda x, step, gs: recording(x, step) * step)
    out = fn()
    jax.effects_barrier()
    monkeypatch.undo()
    return out, recorded


def forced(recorded):
    return ties.forced([torch.from_numpy(a) for a in recorded],
                       "quantize_act", module=layers)


def _np_tree(tree):
    return {k: np.array(v) for k, v in tree.items()}


# name: (arch, config overrides, tokens, router biased toward expert 0)
CASES = {
    "mixtral": ("mixtral-8x7b", {}, 13, False),
    "kimi-shared": ("kimi-k2-1t-a32b", {}, 11, False),
    "dropping": ("mixtral-8x7b", {"capacity_factor": 1.0}, 24, True),
}


def moe_case(case):
    """(cfg, jcfg, reference params, x as numpy) of a case."""
    name, over, t, biased = CASES[case]
    cfg = dataclasses.replace(configs.get_reduced(name), **over)
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **over)
    jp = _np_tree(jmoe.init_moe(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((t, cfg.d_model)) * 2).astype(np.float32)
    if biased:                 # every token's first choice is expert 0
        jp["router"][:, 0] += 0.5
        x += 1.0
    return cfg, jcfg, jp, x


def test_plan_dispatch_over_a_grid():
    for name in ("mixtral-8x7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        for cf in (1.0, 1.25, 4.0):
            cfg = dataclasses.replace(configs.get_config(name),
                                      capacity_factor=cf)
            jcfg = dataclasses.replace(jconfigs.get_config(name),
                                       capacity_factor=cf)
            for t in (1, 2, 3, 4, 7, 8, 12, 33, 100, 512, 4096):
                assert moe.plan_dispatch(cfg, t).ep == 1
                for ep in (1, 2, 4):
                    got = moe.plan_dispatch(cfg, t, ep)
                    want = jmoe.plan_dispatch(jcfg, t, ep)
                    assert dataclasses.astuple(got) == \
                        dataclasses.astuple(want), (name, cf, t, ep)


def test_top_k_ties_as_jax():
    """Integer logits with many equal values: the same experts in the
    same order as ``jax.lax.top_k`` (the lower index first)."""
    rng = np.random.default_rng(41)
    logits = rng.integers(-2, 3, (64, 16)).astype(np.float32)
    logits[0] = 1.0                                   # all equal
    for k in (1, 2, 8, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        v, i = moe.top_k(_t(logits), k)
        assert np.array_equal(i.numpy(), np.asarray(ji)), k
        assert np.array_equal(v.numpy(), np.asarray(jv)), k


def test_load_balance_loss():
    cfg, jcfg, jp, x = moe_case("mixtral")
    want = jmoe.load_balance_loss({k: jnp.asarray(v) for k, v in jp.items()},
                                  jnp.asarray(x), jcfg)
    got = moe.load_balance_loss({k: _t(v) for k, v in jp.items()}, _t(x),
                                cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("mode", ["float", "w1a8_eval", "packed"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn(case, mode, monkeypatch):
    cfg, jcfg, jp, x = moe_case(case)
    if mode == "packed":
        jp = _np_tree(jpacked._pack_moe(
            {k: jnp.asarray(v) for k, v in jp.items()}))
    jmode = "w1a8_eval" if mode == "packed" else mode
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    p = {k: _t(v) for k, v in jp.items()}
    if case == "dropping":        # expert 0 is asked for past its capacity
        cap = moe.plan_dispatch(cfg, x.shape[0]).capacity
        _, idx = moe.top_k(moe.router_logits(p, _t(x)), cfg.top_k)
        assert int((idx == 0).sum()) > cap
    if mode == "float":
        want = jmoe.moe_ffn(jparams, jcfg, jnp.asarray(x), mode=jmode)
        _close(moe.moe_ffn(p, cfg, _t(x), mode=jmode), want, 1e-5, case)
        return
    want, recorded = record_ref(monkeypatch, lambda: jmoe.moe_ffn(
        jparams, jcfg, jnp.asarray(x), mode=jmode))
    with forced(recorded) as counts:
        got = moe.moe_ffn(p, cfg, _t(x), mode=jmode)
    assert len(counts) == len(recorded) == 3
    _close(got, want, 1e-4, f"{case} {mode} ({sum(counts)} forced)")


def test_expert_mm_w1a8_train_gradients():
    """The QAT expert GEMM and its gradients (x, w, act_step) against
    ``jax.vjp``; weights past ±1 exercise the STE clip and inputs past 255
    steps the LSQ rails."""
    cfg, jcfg, jp, _ = moe_case("mixtral")
    rng = np.random.default_rng(42)
    w = jp["up"].copy()
    w[:, ::7] *= 40.0
    x = (rng.standard_normal((4, 8, 64)) * 6).astype(np.float32)
    x[0, 0, :4] = 20.0
    g = rng.standard_normal((4, 8, w.shape[-1])).astype(np.float32)

    def ref(w, step, x):
        return jmoe._expert_mm({"up": w, "act_step": step}, "up", x,
                               "w1a8_train")
    want, vjp = jax.vjp(ref, jnp.asarray(w), jnp.asarray(jp["act_step"]),
                        jnp.asarray(x))
    jgw, jgs, jgx = vjp(jnp.asarray(g))
    tw, ts, tx = (_t(v).requires_grad_() for v in (w, jp["act_step"], x))
    got = moe._expert_mm({"up": tw, "act_step": ts}, "up", tx,
                         "w1a8_train", None)
    got.backward(_t(g))
    _close(got, want, 1e-5, "forward")
    _close(tx.grad, jgx, 1e-5, "dx")
    _close(tw.grad, jgw, 1e-5, "dw")
    _close(ts.grad, jgs, 1e-5, "dstep")


def test_grouped_plain_version_is_a_loop_of_the_2d_one():
    """`w1a8_matmul_grouped` on CPU tensors (its plain version) against
    the 2-D plain version expert by expert, bit for bit, K ragged against
    the word (70) and the span (300); rows from each count on, and every
    row of an empty expert, are zero."""
    rng = np.random.default_rng(43)
    for k, n in ((70, 24), (300, 40)):
        e, cap = 5, 16
        counts = torch.tensor([0, 3, 16, 7, 0], dtype=torch.int32)
        a = _t(rng.integers(0, 256, (e, cap, k), dtype=np.uint8))
        w = packing.pack_signs(_t(rng.standard_normal(
            (e, k, n)).astype(np.float32)), axis=1)
        div = _t(rng.uniform(0.001, 0.01, (e, n)).astype(np.float32))
        bias = _t(rng.standard_normal((e, n)).astype(np.float32))
        got = mm_ops.w1a8_matmul_grouped(a, w, counts, div, bias, k=k)
        assert got.shape == (e, cap, n) and got.dtype == torch.float32
        for i in range(e):
            c = int(counts[i])
            want = mm_ref.w1a8_matmul_popcount_ref(a[i, :c], w[i], k,
                                                   div[i], bias[i])
            assert torch.equal(got[i, :c], want), (k, i)
            assert not got[i, c:].any(), (k, i)
