"""Port parity, the LM stack (dense, MoE, SSM, hybrid, enc-dec and VLM
families): the same numpy inputs and params through `repro` and
`repro_torch` on the CPU, at the reduced configs (2 to 8 layers, d 64,
vocab 128).

Tolerances, and why:

* float paths (layers, `lm_forward` in "float"): within 1e-5·max|y|. The
  two frameworks sum the same f32 products in another order; one rounding
  of a sum of 64–128 terms is about 1e-7 relative, and two layers (eight
  for jamba) of norms, softmax, scans and residual adds keep it below
  1e-5.
* `w1a8_eval` and packed `lm_forward`: within 1e-4·max|logit| with the
  codes that round across a tie forced to the reference's
  (`train.ties`, each within 1e-3 of a tie on both sides). Without the
  forcing, one code that flips at a tie changes every later layer. The
  packed path forms Σ code·sign exactly and multiplies by α·step once,
  where the reference sums code·step·sign in f32 and multiplies by α: a few
  roundings apart per projection, 1e-4 leaves room for two layers.
* the `w1a8_train` gradients against ``jax.vjp``: within 1e-5·max|g| (the
  same f32 products; LSQ's step gradient is a sum over all inputs).
* `deploy_lm`'s sign words and `w1a8_linear_infer_int`'s sums bit for bit;
  α within rtol 1e-6 (a mean over K in another order); steps equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import w1a8 as jw1a8  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import packed as jpacked  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.core import packing, w1a8  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.serve import packed  # noqa: E402
from repro_torch.serve.engine import prefill  # noqa: E402
from repro_torch.train import ties  # noqa: E402

ARCHS = configs.ARCH_NAMES


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


@functools.lru_cache(maxsize=None)
def _ref_init(name, seed):
    return jtransformer.init_lm_params(jax.random.PRNGKey(seed),
                                       jconfigs.get_reduced(name))


def ref_params(name, seed=0):
    """(cfg, reference params as jax arrays, the port's converted); each
    (arch, seed) is drawn once a session."""
    jp = _ref_init(name, seed)
    return (configs.get_reduced(name), jp,
            convert.lm_params_from_numpy(_np(jp), device="cpu"))


@pytest.fixture
def record_ref_quant(monkeypatch):
    """Runs a reference call with every activation quantizer input
    recorded, in call order (an ordered host callback, so traced and
    scanned calls record too): the projections' `quantize_act`, the MoE
    experts' `lsq_fake_quant` (w1a8_eval; replaced by its forward value)
    and the packed experts' `repro.core.quant.quantize_act`."""
    def run(fn):
        recorded, real = [], jquant.quantize_act

        def recording(x, step):
            jax.debug.callback(lambda v: recorded.append(np.array(v)), x,
                               ordered=True)
            return real(x, step)
        monkeypatch.setattr(jlayers, "quantize_act", recording)
        monkeypatch.setattr(jquant, "quantize_act", recording)
        monkeypatch.setattr(jmoe, "lsq_fake_quant",
                            lambda x, step, gs: recording(x, step) * step)
        try:
            out = fn()
            jax.effects_barrier()
        finally:
            monkeypatch.undo()
        return out, recorded
    return run


def forced(recorded):
    """The port's projections with the reference's tie codes forced."""
    return ties.forced([torch.from_numpy(a) for a in recorded],
                       "quantize_act", module=layers)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_shapes():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        for get in ("get_config", "get_reduced"):
            got = dataclasses.asdict(getattr(configs, get)(name))
            assert got == dataclasses.asdict(getattr(jconfigs, get)(name))
        cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
        assert (cfg.hd, cfg.heads_eff, cfg.period) == \
            (jcfg.hd, jcfg.heads_eff, jcfg.period)
        assert [(cfg.mixer_kind(i), cfg.ffn_kind(i)) for i in range(8)] == \
            [(jcfg.mixer_kind(i), jcfg.ffn_kind(i)) for i in range(8)]
        assert [s.name for s in shapes.applicable_shapes(name)] == \
            [s.name for s in jshapes.applicable_shapes(name)]
        assert shapes.skip_reason(name, "long_500k") == \
            jshapes.skip_reason(name, "long_500k")
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", ARCHS)
def test_count_lm_params_full_config_on_meta(name):
    """The full config's params, shapes only: the port builds them on
    ``meta``, the reference through ``jax.eval_shape``."""
    got = transformer.count_lm_params(transformer.init_lm_params(
        configs.get_config(name), None, device="meta"))
    want = jtransformer.count_lm_params(jax.eval_shape(
        lambda: jtransformer.init_lm_params(jax.random.PRNGKey(0),
                                            jconfigs.get_config(name))))
    assert got == want


def test_shard_ctx_raises():
    """The forward and the engine refuse a ctx that is not a ShardCtx, and
    take a ShardCtx: on a (1, 1) mesh of one gloo rank the sharded MoE
    gives the local path's logits bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    cfg = configs.get_reduced("mixtral-8x7b")
    p = transformer.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    toks = torch.zeros((1, 3), dtype=torch.int32)
    for fn in (lambda: transformer.lm_forward(cfg, p, toks, ctx=object()),
               lambda: prefill(cfg, p, toks, max_len=8, ctx=object())):
        with pytest.raises(TypeError, match="ctx"):
            fn()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        ctx = transformer.ShardCtx(make_test_mesh(1, 1, device="cpu"),
                                   ("data",), "model", "data")
        with torch.no_grad():
            assert torch.equal(transformer.lm_forward(cfg, p, toks, ctx=ctx),
                               transformer.lm_forward(cfg, p, toks))
            got, _ = prefill(cfg, p, toks, max_len=8, ctx=ctx)
            want, _ = prefill(cfg, p, toks, max_len=8)
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def test_init_lm_params_tree_matches_reference():
    """Same keys, nesting and shapes as the reference's init; a seeded
    generator draws the same params twice."""
    for name in ARCHS:
        cfg = configs.get_reduced(name)
        p = transformer.init_lm_params(cfg, torch.Generator().manual_seed(3),
                                       device="cpu")
        jp = _ref_init(name, 0)
        want = [(jax.tree_util.keystr(k), v.shape) for k, v in
                jax.tree_util.tree_flatten_with_path(jp)[0]]
        got = [(k, tuple(v.shape)) for k, v in transformer.tree_items(p)]
        assert got == want, name
        again = transformer.init_lm_params(
            cfg, torch.Generator().manual_seed(3), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            transformer.tree_leaves(p), transformer.tree_leaves(again)))
    with pytest.raises(ValueError, match="Generator"):
        transformer.init_lm_params(cfg, None, device="cpu")


@pytest.mark.parametrize("name", ["mixtral-8x7b", "kimi-k2-1t-a32b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium", "gemma2-27b"])
def test_init_packed_lm_equals_deploy_of_init(name):
    """The stage-wise packed init (one f32 leaf of one stage at a time)
    against `deploy_lm` of the whole f32 init, leaf for leaf, under the
    same seed."""
    cfg = configs.get_reduced(name)
    want = packed.deploy_lm(transformer.init_lm_params(
        cfg, torch.Generator().manual_seed(9), device="cpu"))
    got = packed.init_packed_lm(cfg, torch.Generator().manual_seed(9),
                                device="cpu")
    items, want_items = transformer.tree_items(got), \
        transformer.tree_items(want)
    assert [k for k, _ in items] == [k for k, _ in want_items]
    for (key, g), (_, w) in zip(items, want_items):
        assert g.dtype == w.dtype and torch.equal(g, w), key


def test_init_draws_stage_major():
    """The f32 init draws the embedding, then every leaf of stage 0 in
    slot order, then of stage 1: one stage's leaf at a time."""
    cfg = configs.get_reduced("granite-20b")
    p = transformer.init_lm_params(cfg, torch.Generator().manual_seed(9),
                                   device="cpu")
    gen = torch.Generator().manual_seed(9)

    def draw(leaf, std):
        return torch.empty(leaf.shape).normal_(generator=gen).mul_(std)
    assert torch.equal(draw(p["embed"]["emb"], 0.02), p["embed"]["emb"])
    attn = p["slots"][0]["attn"]
    for st in range(2):
        for key in ("wq", "wk", "wv", "wo"):
            w = attn[key]["w"][st]
            assert torch.equal(draw(w, w.shape[0] ** -0.5), w), (st, key)
        for key in ("up", "down"):                    # not gated
            w = p["slots"][0]["mlp"][key]["w"][st]
            assert torch.equal(draw(w, w.shape[0] ** -0.5), w), (st, key)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _linear_params(rng, k, n, *, bias):
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
         "act_step": np.float32(0.05)}
    if bias:
        p["b"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return p


@pytest.mark.parametrize("mode", ["float", "w1a8_eval", "packed"])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_modes(mode, bias):
    """One projection in each inference mode; K = 72 and N = 40 are off
    the kernels' grids. Codes come from the same f32 x/step on both sides,
    so they are equal; the sums differ in order only."""
    rng = np.random.default_rng(11)
    pn = _linear_params(rng, 72, 40, bias=bias)
    x = (rng.standard_normal((2, 5, 72)) * 4).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    p = {k: _t(v) for k, v in pn.items()}
    if mode == "packed":
        jp = jpacked._pack_linear(jp)
        p = packed._pack_linear(p)
    want = jlayers.linear(jp, jnp.asarray(x), "w1a8_eval"
                          if mode == "packed" else mode)
    got = layers.linear(p, _t(x), "w1a8_eval" if mode == "packed" else mode)
    _close(got, want, 1e-5, mode)


def test_linear_w1a8_train_gradients():
    """The QAT projection's forward and its gradients (x, w, act_step, b)
    against ``jax.vjp``; weights beyond ±1 exercise the STE clip and
    activations past 255 steps the LSQ rails."""
    rng = np.random.default_rng(12)
    pn = _linear_params(rng, 48, 24, bias=True)
    pn["w"][::7] *= 40.0
    x = (rng.standard_normal((3, 4, 48)) * 6).astype(np.float32)
    x[0, 0, :4] = 20.0                              # x/step past 255
    g = rng.standard_normal((3, 4, 24)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    want, vjp = jax.vjp(lambda p, x: jlayers.linear(p, x, "w1a8_train"),
                        jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    p = {k: _t(v).requires_grad_() for k, v in pn.items()}
    xt = _t(x).requires_grad_()
    got = layers.linear(p, xt, "w1a8_train")
    got.backward(_t(g))
    _close(got, want, 1e-5, "forward")
    _close(xt.grad, jgx, 1e-5, "dx")
    for k in pn:
        _close(p[k].grad, jgp[k], 1e-5, f"d{k}")


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm(kind):
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 3, 64)) * 3 + 1).astype(np.float32)
    pn = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32)}
    if kind == "layer":
        pn["bias"] = rng.standard_normal(64).astype(np.float32)
    want = jlayers.norm({k: jnp.asarray(v) for k, v in pn.items()},
                        jnp.asarray(x), kind)
    got = layers.norm({k: _t(v) for k, v in pn.items()}, _t(x), kind)
    _close(got, want, 1e-6, kind)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(3, 10)]).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4,
                        fraction=fraction)
    got = layers.rope(_t(x), _t(pos), theta=1e4, fraction=fraction)
    _close(got, want, 1e-6, f"fraction {fraction}")
    if fraction < 1:                  # the second half passes through
        assert torch.equal(got[..., 8:], _t(x)[..., 8:])


ATTN_CASES = {
    "gqa": ("chatglm3-6b", {}, 0, 9),
    "mqa": ("granite-20b", {}, 0, 9),
    "window+softcap": ("gemma2-27b", {}, 8, 13),
    "flash_block": ("qwen2.5-14b", {"flash_block": 4}, 0, 10),
    "flash_block+window+softcap": ("gemma2-27b", {"flash_block": 4}, 5, 11),
    "flat_head_attn": ("chatglm3-6b", {"flat_head_attn": True}, 0, 6),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention(case):
    name, over, window, s = ATTN_CASES[case]
    cfg = dataclasses.replace(configs.get_reduced(name), **over)
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), **over)
    _, jp, p = ref_params(name)
    jattn = jax.tree_util.tree_map(lambda v: v[0], jp["slots"][0]["attn"])
    attn = transformer.stage(p["slots"][0]["attn"], 0)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(s), np.arange(s) + 2]).astype(np.int32)
    want = jax.jit(lambda p, x, pos: jlayers.attention(
        p, jcfg, x, mode="float", window=window, positions=pos))(
        jattn, jnp.asarray(x), jnp.asarray(pos))
    got = layers.attention(attn, cfg, _t(x), mode="float", window=window,
                           positions=_t(pos))
    _close(got, want, 1e-5, case)


def test_cross_attention():
    cfg = configs.get_reduced("qwen2.5-14b")
    _, jp, p = ref_params("qwen2.5-14b")
    jattn = jax.tree_util.tree_map(lambda v: v[0], jp["slots"][0]["attn"])
    attn = transformer.stage(p["slots"][0]["attn"], 0)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 64)).astype(np.float32)
    want = jlayers.attention(jattn, jconfigs.get_reduced("qwen2.5-14b"),
                             jnp.asarray(x), mode="float", causal=False,
                             kv_x=jnp.asarray(kv))
    got = layers.attention(attn, cfg, _t(x), mode="float", causal=False,
                           kv_x=_t(kv))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["chatglm3-6b", "granite-20b"])
def test_mlp_and_embed(name):
    """Gated SiLU (chatglm3) and non-gated tanh-GELU (granite); the tied
    unembed; gemma2's final softcap."""
    cfg, jp, p = ref_params(name)
    jcfg = jconfigs.get_reduced(name)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jm = jax.tree_util.tree_map(lambda v: v[0], jp["slots"][0]["mlp"])
    m = transformer.stage(p["slots"][0]["mlp"], 0)
    _close(layers.mlp(m, cfg, _t(x), "float"),
           jlayers.mlp(jm, jcfg, jnp.asarray(x), "float"), 1e-5, "mlp")
    toks = np.array([[1, 5, 127], [0, 3, 9]], np.int32)
    assert torch.equal(layers.embed(p["embed"], _t(toks)),
                       _t(jlayers.embed(jp["embed"], jnp.asarray(toks))))
    capped = dataclasses.replace(cfg, final_softcap=0.5)
    jcapped = dataclasses.replace(jcfg, final_softcap=0.5)
    _close(layers.unembed(p["embed"], capped, _t(x) * 20),
           jlayers.unembed(jp["embed"], jcapped, jnp.asarray(x) * 20), 1e-6,
           "unembed")


# ---------------------------------------------------------------------------
# lm_forward and deployment
# ---------------------------------------------------------------------------

def forward_inputs(cfg, rng):
    """Tokens, and the modality inputs of the enc-dec (encoder_embeds)
    and VLM (prefix_embeds) archs, as numpy."""
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    extra = {}
    if cfg.encoder_layers:
        extra["encoder_embeds"] = rng.standard_normal(
            (2, 7, cfg.d_model)).astype(np.float32)
    if cfg.prefix_len:
        extra["prefix_embeds"] = rng.standard_normal(
            (2, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return toks, extra


@pytest.mark.parametrize("mode", ["float", "w1a8_eval", "packed"])
@pytest.mark.parametrize("name", ARCHS)
def test_lm_forward(name, mode, record_ref_quant):
    cfg, jp, p = ref_params(name)
    jcfg = jconfigs.get_reduced(name)
    toks, extra = forward_inputs(cfg, np.random.default_rng(18))
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: _t(v) for k, v in extra.items()}
    if mode == "packed":
        jp = jpacked.deploy_lm(jp)
        p = convert.lm_params_from_numpy(_np(jp), device="cpu")
    jmode = "w1a8_eval" if mode == "packed" else mode
    if mode == "float":
        want = jax.jit(lambda p, t, e: jtransformer.lm_forward(
            jcfg, p, t, **e))(jp, jnp.asarray(toks), jextra)
        got = transformer.lm_forward(cfg, p, _t(toks), mode=jmode, **textra)
        _close(got, want, 1e-5, name)
        return
    want, recorded = record_ref_quant(lambda: jtransformer.lm_forward(
        jcfg, jp, jnp.asarray(toks), mode=jmode, **jextra))
    with forced(recorded) as counts:
        got = transformer.lm_forward(cfg, p, _t(toks), mode=jmode, **textra)
    assert len(counts) == len(recorded) == quantizer_calls(cfg)
    _close(got, want, 1e-4, f"{name} {mode} ({sum(counts)} forced)")


def quantizer_calls(cfg) -> int:
    """Activation quantizer calls of one W1A8 forward: 4 an attention
    mixer (q, k, v, o), 2 a Mamba mixer (in, out), 2 or 3 a dense MLP, 3
    an MoE FFN (up, gate, down over the dispatch buffer); with an encoder,
    its layers' and one cross-attention a decoder layer."""
    mlp = 3 if cfg.gated_mlp else 2
    n = 0
    for i in range(cfg.num_layers):
        n += 4 if cfg.mixer_kind(i % cfg.period).startswith("attn") else 2
        n += {"none": 0, "moe": 3, "dense": mlp}[cfg.ffn_kind(i % cfg.period)]
    if cfg.encoder_layers:
        n += cfg.encoder_layers * (4 + mlp) + 4 * cfg.num_layers
    return n


def test_cross_stack_runs_without_encoder_embeds():
    """As the reference's `lm_forward`, an enc-dec tree runs its cross
    stack after every stage even without ``encoder_embeds``: the cross
    slot then attends to the decoder's own states, non-causally."""
    cfg, jp, p = ref_params("seamless-m4t-medium")
    jcfg = jconfigs.get_reduced("seamless-m4t-medium")
    toks, _ = forward_inputs(cfg, np.random.default_rng(18))
    want = jax.jit(lambda p, t: jtransformer.lm_forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    got = transformer.lm_forward(cfg, p, _t(toks))
    _close(got, want, 1e-5)
    no_cross = {k: v for k, v in p.items() if k != "cross"}
    assert not torch.allclose(transformer.lm_forward(cfg, no_cross,
                                                     _t(toks)), got)


@pytest.mark.parametrize("name", ARCHS)
def test_deploy_lm_bit_exact(name):
    """The port's `deploy_lm` of the converted params against the
    reference's: same tree, sign words bit for bit, α within rtol 1e-6,
    steps and biases equal; the byte account equal."""
    _, jp, p = ref_params(name)
    want = _np(jpacked.deploy_lm(jp))
    got = packed.deploy_lm(p)
    jitems = jax.tree_util.tree_flatten_with_path(want)[0]
    items = transformer.tree_items(got)
    assert [jax.tree_util.keystr(k) for k, _ in jitems] == \
        [k for k, _ in items]
    for (path, w), (_, g) in zip(jitems, items):
        key = jax.tree_util.keystr(path)
        g = g.numpy()
        if "_packed" in key:                      # w_, up_, gate_, down_
            assert g.dtype == np.int32 and w.dtype == np.uint32
            assert np.array_equal(g.view(np.uint32), w), key
        elif "alpha" in key:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            assert np.array_equal(g, w), key
    assert packed.packed_param_bytes(got) == \
        jpacked.packed_param_bytes(jpacked.deploy_lm(jp))


def test_pack_moe_as_the_reference():
    """An expert stack (stages, E, K, N) with the reference's keys."""
    rng = np.random.default_rng(19)
    pn = {"router": rng.standard_normal((2, 16, 4)).astype(np.float32),
          "act_step": np.full((2,), 0.05, np.float32)}
    for name, (k, n) in {"up": (16, 40), "gate": (16, 40),
                         "down": (40, 16)}.items():
        pn[name] = rng.standard_normal((2, 4, k, n)).astype(np.float32)
    want = _np(jpacked._pack_moe({k: jnp.asarray(v) for k, v in pn.items()}))
    got = packed._pack_moe({k: _t(v) for k, v in pn.items()})
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        if key.endswith("_packed"):
            assert np.array_equal(g.view(np.uint32), w), key
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)


def test_pack_signs_stacked_leaf_bit_exact():
    """A stage-stacked leaf packed along K (axis 1), K ragged against the
    word: the same words as the reference's, without an int64 copy."""
    rng = np.random.default_rng(20)
    w = rng.standard_normal((3, 70, 9)).astype(np.float32)
    w[0, ::5] = 0.0
    w[1, 1::4] = -0.0
    want = np.asarray(jpacked.packing.pack_signs(jnp.asarray(w), axis=1))
    got = packing.pack_signs(_t(w), axis=1)
    assert got.dtype == torch.int32 and got.shape == (3, 3, 9)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("packed_tree", [False, True])
def test_lm_params_numpy_round_trip(packed_tree):
    _, jp, _ = ref_params("gemma2-27b")
    if packed_tree:
        jp = jpacked.deploy_lm(jp)
    tree = _np(jp)
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tree, device="cpu"))
    flat, tdef = jax.tree_util.tree_flatten(tree)
    flat2, tdef2 = jax.tree_util.tree_flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# core/w1a8.py
# ---------------------------------------------------------------------------

def _w1a8_layer(rng, k=70, n=24):
    return {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(
                np.float32),
            "act_step": rng.uniform(0.03, 0.08, k).astype(np.float32),
            "bias": (rng.standard_normal(n) * 0.1).astype(np.float32)}


def test_w1a8_linear_train_and_float_ref():
    rng = np.random.default_rng(21)
    pn = _w1a8_layer(rng)
    x = (rng.standard_normal((6, 70)) * 3).astype(np.float32)
    g = rng.standard_normal((6, 24)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    want, vjp = jax.vjp(jw1a8.w1a8_linear_train, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    p = {k: _t(v).requires_grad_() for k, v in pn.items()}
    xt = _t(x).requires_grad_()
    got = w1a8.w1a8_linear_train(p, xt)
    got.backward(_t(g))
    _close(got, want, 1e-5, "train")
    _close(xt.grad, jgx, 1e-5, "dx")
    for k in pn:
        _close(p[k].grad, jgp[k], 1e-5, f"d{k}")
    _close(w1a8.w1a8_linear_float_ref({k: _t(v) for k, v in pn.items()},
                                      _t(x)),
           jw1a8.w1a8_linear_float_ref(jp, jnp.asarray(x)), 1e-5, "ref")


def test_w1a8_deploy_infer_and_int_bit_exact():
    """deploy bit for bit; the int path's sums and outputs bit for bit
    (one uniform step); the bf16 infer path within 1e-5·max|y|."""
    rng = np.random.default_rng(22)
    pn = _w1a8_layer(rng, k=200, n=40)
    pn["act_step"] = np.float32(0.04)
    jdep = jw1a8.deploy_w1a8_linear({k: jnp.asarray(v)
                                     for k, v in pn.items()})
    dep = w1a8.deploy_w1a8_linear({k: _t(v) for k, v in pn.items()})
    assert dep["k"] == jdep["k"] == 200
    assert np.array_equal(dep["w_packed"].numpy().view(np.uint32),
                          np.asarray(jdep["w_packed"]))
    for key in ("mul_prev", "bias"):
        assert np.array_equal(dep[key].numpy(), np.asarray(jdep[key]))
    np.testing.assert_allclose(dep["div_post"].numpy(),
                               np.asarray(jdep["div_post"]), rtol=1e-6)
    dep["div_post"] = _t(jdep["div_post"])
    a = rng.integers(0, 256, (2, 9, 200)).astype(np.uint8)
    a[0, 0] = 255                                   # the largest sums
    want = jw1a8.w1a8_linear_infer_int(jdep, jnp.asarray(a))
    got = w1a8.w1a8_linear_infer_int(dep, _t(a))
    assert np.array_equal(got.numpy(), np.asarray(want))
    signs = np.where(pn["w"] >= 0, 1, -1).astype(np.int64)
    assert np.array_equal(w1a8.int_sums(dep, _t(a)).numpy(),
                          a.astype(np.int64) @ signs)
    _close(w1a8.w1a8_linear_infer(dep, _t(a)),
           jw1a8.w1a8_linear_infer(jdep, jnp.asarray(a)), 1e-5, "infer")
    y = (rng.standard_normal((4, 40)) * 3).astype(np.float32)
    step = np.float32(0.02)
    assert np.array_equal(
        w1a8.requantize(_t(y), torch.tensor(step)).numpy(),
        np.asarray(jw1a8.requantize(jnp.asarray(y), jnp.asarray(step))))


def test_init_w1a8_linear_shapes():
    p = w1a8.init_w1a8_linear(torch.Generator().manual_seed(0), 70, 24,
                              device="cpu")
    jp = jw1a8.init_w1a8_linear(jax.random.PRNGKey(0), 70, 24)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert float(p["act_step"][0]) == float(jp["act_step"][0])
