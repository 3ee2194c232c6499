"""Port parity, the Mamba mixers: the same numpy inputs and params through
`repro.models.mamba` and `repro_torch.models.mamba` on the CPU, at the
reduced configs (mamba2-1.3b: d 64, state 16, headdim 16; jamba's Mamba-1:
d 64, state 8).

Tolerances, and why:

* the causal conv and its step: within 1e-6·max|y| (the same W = 4
  products summed in the same order; the step's reference sums them in an
  einsum).
* `ssd_chunked`: within 1e-5·max|y| and of the final state. The chunk's
  cumulative sum of dt·a, the masked exp and three einsums run in another
  order; chunks of 4 over S = 11 (S > chunk, S not a multiple of it, a
  short last chunk where the reference pads with dt = 0) and a carried
  ``init_state``.
* `selective_scan_chunked`: within 1e-5·max|y|. The reference's
  ``lax.associative_scan`` and the port's `pair_scan` combine the chunk's
  steps in the same pair form, each in a tree of its own: the decay
  products and sums round in another order (a chunk of 4 to 128 steps,
  each rounding about 1e-7 relative).
* softplus: the port forms logaddexp(x, 0) as ``jax.nn.softplus`` does,
  within 1e-6 relative (and 1e-37 absolute: far below zero one side
  flushes a denormal the other keeps), where ``F.softplus`` (threshold
  20) would return x itself above 20 (a gap of at most 2e-9 relative).
* the mixers, prefill caches and decode steps in float: within 1e-5·max;
  in ``w1a8_eval`` within 1e-4·max with the reference's tie codes forced
  (`train.ties`), as tests/test_torch_lm.py explains.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmb  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models import mamba as mb  # noqa: E402
from repro_torch.train import ties  # noqa: E402

ARCHS = {"mamba2": "mamba2-1.3b", "mamba1": "jamba-1.5-large-398b"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def mixer_params(kind):
    """(cfg, jcfg, reference params of one Mamba mixer, the port's)."""
    name = ARCHS[kind]
    cfg, jcfg = configs.get_reduced(name), jconfigs.get_reduced(name)
    jp = jmb.init_mamba(jax.random.PRNGKey(8), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return cfg, jcfg, jp, convert.lm_params_from_numpy(tree, device="cpu")


def test_causal_conv_and_step():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    _close(mb.causal_conv(_t(x), _t(w), _t(b)),
           jmb.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           1e-6, "conv")
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    y, s = mb.causal_conv_step(_t(x[:, 0]), _t(state), _t(w), _t(b))
    jy, js = jmb.causal_conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                                  jnp.asarray(w), jnp.asarray(b))
    _close(y, jy, 1e-6, "step")
    assert np.array_equal(s.numpy(), np.asarray(js))


def test_softplus_as_reference():
    x = np.concatenate([np.linspace(-40, 40, 801), [-100.0, 0.0, 20.0,
                                                   20.5, 90.0]]) \
        .astype(np.float32)
    np.testing.assert_allclose(mb.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-37)


@pytest.mark.parametrize("carry", [False, True])
def test_ssd_chunked(carry):
    rng = np.random.default_rng(51)
    b, s, h, p, n = 2, 11, 3, 4, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, h).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if carry else None
    for chunk in (4, 128):
        want, wstate = jmb.ssd_chunked(
            jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
            jnp.asarray(cm), chunk=chunk,
            init_state=None if init is None else jnp.asarray(init))
        got, state = mb.ssd_chunked(
            _t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk,
            init_state=None if init is None else _t(init))
        _close(got, want, 1e-5, f"y chunk {chunk}")
        _close(state, wstate, 1e-5, f"state chunk {chunk}")


@pytest.mark.parametrize("carry", [False, True])
def test_selective_scan_chunked(carry):
    rng = np.random.default_rng(52)
    b, s, c, n = 2, 11, 6, 5
    u = rng.standard_normal((b, s, c)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, c)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (c, n)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    init = rng.standard_normal((b, c, n)).astype(np.float32) \
        if carry else None
    for chunk in (4, 128):
        want, wstate = jmb.selective_scan_chunked(
            jnp.asarray(u), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
            jnp.asarray(cm), chunk=chunk,
            init_state=None if init is None else jnp.asarray(init))
        got, state = mb.selective_scan_chunked(
            _t(u), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk,
            init_state=None if init is None else _t(init))
        _close(got, want, 1e-5, f"y chunk {chunk}")
        _close(state, wstate, 1e-5, f"state chunk {chunk}")


def test_init_mamba_tree_and_cache_match_reference():
    for kind in ARCHS:
        cfg, jcfg, jp, _ = mixer_params(kind)
        spec = mb.init_mamba(cfg)
        assert sorted(spec) == sorted(jp)
        for key, leaf in spec.items():
            want = jp[key]
            if isinstance(leaf, dict):
                assert {k: v.shape for k, v in leaf.items()} == \
                    {k: tuple(v.shape) for k, v in want.items()}, key
            else:
                assert leaf.shape == tuple(want.shape), key
        got = mb.init_mamba_cache(cfg, 3, device="cpu")
        want = jmb.init_mamba_cache(jcfg, 3)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        # the constant leaves as the reference's (log in another libm)
        made = transformer.materialize(spec, torch.Generator(),
                                       device="cpu")
        for key in ("A_log", "D"):
            np.testing.assert_allclose(made[key].numpy(),
                                       np.asarray(jp[key]), rtol=1e-6)


def _record(monkeypatch, fn):
    recorded, real = [], jlayers.quantize_act

    def recording(x, step):
        jax.debug.callback(lambda v: recorded.append(np.array(v)), x,
                           ordered=True)
        return real(x, step)
    monkeypatch.setattr(jlayers, "quantize_act", recording)
    out = fn()
    jax.effects_barrier()
    monkeypatch.undo()
    return out, recorded


@pytest.mark.parametrize("mode", ["float", "w1a8_eval"])
@pytest.mark.parametrize("kind", list(ARCHS))
def test_mixer_prefill_and_decode_step(kind, mode, monkeypatch):
    """The mixer over S = 9, the prefill's output and cache (S = 9, and a
    prompt of 2, shorter than the conv's W - 1 = 3), and two decode steps
    from the first prefill's cache, each against the reference's."""
    cfg, jcfg, jp, p = mixer_params(kind)
    mixer = {"mamba2": (jmb.mamba2_mixer, jmb.mamba2_prefill,
                        jmb.mamba2_decode_step),
             "mamba1": (jmb.mamba1_mixer, jmb.mamba1_prefill,
                        jmb.mamba1_decode_step)}[kind]
    port = transformer.mamba_fns(cfg)
    rng = np.random.default_rng(53)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    steps = rng.standard_normal((2, 2, 1, cfg.d_model)).astype(np.float32)

    def ref():
        out = [mixer[0](jp, jcfg, jnp.asarray(x), mode=mode)]
        out += mixer[1](jp, jcfg, jnp.asarray(x[:, :2]), mode=mode)
        y, cache = mixer[1](jp, jcfg, jnp.asarray(x), mode=mode)
        out += [y, cache]
        for i in range(2):
            y, cache = mixer[2](jp, jcfg, jnp.asarray(steps[i]), cache,
                                mode)
            out += [y, cache]
        return out

    def run():
        out = [port[0](p, cfg, _t(x), mode=mode)]
        out += port[1](p, cfg, _t(x[:, :2]), mode=mode)
        y, cache = port[1](p, cfg, _t(x), mode=mode)
        out += [y, cache]
        for i in range(2):
            y, cache = port[2](p, cfg, _t(steps[i]), cache, mode)
            out += [y, cache]
        return out

    rel = 1e-5 if mode == "float" else 1e-4
    if mode == "float":
        want, got = ref(), run()
    else:
        want, recorded = _record(monkeypatch, ref)
        with ties.forced([torch.from_numpy(a) for a in recorded],
                         "quantize_act", module=layers) as counts:
            got = run()
        assert len(counts) == len(recorded) == 2 * 5
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for key in w:
                _close(g[key], w[key], rel, f"{kind} {mode} #{i} {key}")
        else:
            _close(g, w, rel, f"{kind} {mode} #{i}")
