"""Port parity, tensor parallelism: the production layout on gloo ranks of
(data, model) = (1, 2), (1, 4) and (2, 2) meshes (`torch_ranks.spawn`,
once for the module), against the port's one-device path and the
reference's one-device ``jax.value_and_grad`` of `lm_loss`.

Each rank holds its block of every leaf (`dist.sharding.shard_tree`) and
runs on it: column- and row-parallel projections, attention on its query
heads, the embedding, head and loss on its vocabulary block, Mamba's
products gathered around its whole scans, the experts expert- and
tensor-parallel. Archs (reduced): chatglm3-6b (2 KV heads: at |model| 4
the K/V products are gathered), gemma2-27b (softcaps, a sliding window,
post norms), chatglm3-6b with 6 query heads (over 4 ranks the heads split
1, 2, 1, 2 and wq's column blocks fall inside heads), mamba2-1.3b
(``in_proj``'s blocks fall across its components), mixtral-8x7b (TP dense
layers beside EP experts), seamless-m4t-medium (the encoder) and
internvl2-76b (the vision prefix). mixtral also decodes one long-context
row with the KV sequence over 'data' (`serve.sp`).

Tolerances, and why:

* the forward's logits (w1a8_train, codes forced to the reference's by
  rows on the ranks and by call on one device, `train.ties`): within
  1e-5·max|logits| of the one-device forward's (row-parallel products and
  the vocabulary's split sum in another order).
* the sharded SGD-M step (no clip, so the moment is the gradient): the
  loss rtol 1e-5 of the reference's and the one-device step's; every
  gathered gradient leaf within 1e-4·max|g| of the one-device step's, as
  tests/test_torch_sharded_step.py holds them, and within 1e-3·max|g| of
  the reference's, the bound tests/test_torch_lm_train.py holds the
  one-device step to (gemma2's softcaps carry the forward's rounding
  differences into its small act step gradients).
* packed prefill and 8 greedy decode steps: the tokens equal the
  one-device unpacked path's and the reference's (`repro.serve.engine`),
  and the logits within 1e-3 of each (chip phase 10's bound: Σ
  code·sign·α·step against f32 sums of the same products).
* greedy `generate(ctx=)` on the same blocks (its ticks `decode_tick`
  under the ctx): the eager steps' tokens bit for bit (the same ops).
* no non-MoE leaf is all-gathered in the step, the prefill or the decode
  steps (the probe does see `dist.sharding.gather_tree`'s gathers).
* a fresh sharded draw (`train.loop.resume_or_init`): bit for bit the
  block `dist.sharding.shard_by` cuts from the whole draw.
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_lm_train as lm_train  # noqa: E402
import torch_ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.models.transformer import (init_lm_params,  # noqa: E402
                                            keep_all, lm_forward,
                                            tree_items)
from repro_torch.optim import adamw, sgdm  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.loop import block_cutter, resume_or_init  # noqa: E402

WORLD = 4
MESHES = ((1, 2), (1, 4), (2, 2))
LR, NO_CLIP = 0.1, 1e9
DECODE_STEPS, MAX_LEN, PROMPT = 8, 16, 4
# name: (arch, config fields replaced, served)
ARCHS = {
    "chatglm3-6b": ("chatglm3-6b", {}, True),
    "gemma2-27b": ("gemma2-27b", {}, True),
    "heads6": ("chatglm3-6b", {"num_heads": 6, "head_dim": 16}, True),
    "mamba2-1.3b": ("mamba2-1.3b", {}, True),
    "mixtral-8x7b": ("mixtral-8x7b", {}, True),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, False),
    "internvl2-76b": ("internvl2-76b", {}, False),
}
CASES = [f"{name}@{d}x{m}" for name in ARCHS for d, m in MESHES]
SERVED = [c for c in CASES if ARCHS[c.split("@")[0]][2]]
SP_CASE = "mixtral-8x7b-sp@2x2"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(case: str) -> tuple:
    name, mesh = case.split("@")
    return name, tuple(int(v) for v in mesh.split("x"))


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """(params, batch, loss, grads by path, recorder) of the reference's
    ``value_and_grad`` of `lm_loss` (tests/test_torch_lm_train.py's, with
    the config's fields replaced where the case says)."""
    arch, over, _ = ARCHS[name]
    if not over:
        return lm_train._reference(arch)
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **over)
    jp = jtransformer.init_lm_params(jax.random.PRNGKey(0), jcfg)
    batch = lm_train._batch_np(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jstep.lm_loss(jcfg, p, jb, mode="w1a8_train", remat=False)
    rec = lm_train._RecordRef()
    with rec:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
        jax.block_until_ready(grads)
    paths = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
             jax.tree_util.tree_flatten_with_path(grads)[0]}
    return (jax.tree_util.tree_map(np.asarray, jp), batch, float(loss), paths,
            rec)


@functools.lru_cache(maxsize=None)
def _reference_serve(name: str, rows: int) -> tuple:
    """(logits, tokens) of the reference's unpacked w1a8_eval prefill and
    greedy decode steps (`repro.serve.engine`) on the params and prompts
    the ranks serve."""
    arch, over, _ = ARCHS[name]
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **over)
    jp = jax.tree_util.tree_map(jnp.asarray, _reference(name)[0])
    pre = jax.jit(lambda p, t: jengine.prefill(jcfg, p, t, max_len=MAX_LEN,
                                               mode="w1a8_eval"))
    step = jax.jit(lambda p, c, t: jengine.decode_step(jcfg, p, c, t,
                                                       mode="w1a8_eval"))
    logits, cache = pre(jp, jnp.asarray(_prompts(_cfg(name), rows)))
    out = [np.asarray(logits)]
    for _ in range(DECODE_STEPS):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        logits, cache = step(jp, cache, nxt)
        out.append(np.asarray(logits))
    logits = np.stack(out)
    return logits, np.argmax(logits, -1)


def _cfg(name: str):
    arch, over, _ = ARCHS[name]
    return dataclasses.replace(configs.get_reduced(arch), **over)


def _prompts(cfg, rows: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    return rng.integers(0, cfg.vocab_size, (rows, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _one_device(name: str) -> dict:
    """The port's one-device forward and SGD-M step from the reference's
    params, codes forced to the reference's; the unpacked greedy serve."""
    params_np, batch, _, _, rec = _reference(name)
    cfg = _cfg(name)
    params = convert.lm_params_from_numpy(params_np, device="cpu")
    tb = lm_train._port_batch(batch)
    kw = {k: tb[k] for k in ("encoder_embeds", "prefix_embeds") if k in tb}
    with torch.no_grad(), lm_train._forced(rec):
        logits = lm_forward(cfg, params, tb["tokens"], mode="w1a8_train",
                            **kw)
    opt = sgdm(LR)
    step = step_mod.make_train_step(cfg, opt, remat=False,
                                    max_grad_norm=NO_CLIP)
    with lm_train._forced(rec):
        _, s, metrics = step(params, opt[0](params), tb)
    out = {"logits": logits.numpy(), "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "m": {p: v.numpy() for p, v in tree_items(s["m"])}}
    if ARCHS[name][2]:
        # 4 rows, and the long-context case's 1
        for rows in (4, 1) if name == "mixtral-8x7b" else (4,):
            logits, toks = torch_ranks._greedy(
                cfg, params, torch.from_numpy(_prompts(cfg, rows)), None,
                DECODE_STEPS, MAX_LEN)
            out[f"serve{rows}"] = (logits.numpy(), toks.numpy())
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {}
    for case in CASES:
        name, mesh = _split(case)
        params_np, batch, _, _, rec = _reference(name)
        cases[case] = {"arch": ARCHS[name][0], "over": ARCHS[name][1],
                       "mesh": mesh, "params": params_np, "batch": batch,
                       "recorded": rec.inputs["layers"] + rec.inputs["moe"]}
        if ARCHS[name][2]:
            cases[case]["prompts"] = _prompts(_cfg(name), 4)
    params_np = _reference("mixtral-8x7b")[0]
    cases[SP_CASE] = {"arch": "mixtral-8x7b", "over": {}, "mesh": (2, 2),
                      "params": params_np, "sp": True,
                      "prompts": _prompts(_cfg("mixtral-8x7b"), 1)}
    inputs = {"cases": cases, "meshes": MESHES, "lr": LR,
              "max_norm": NO_CLIP, "decode_steps": DECODE_STEPS,
              "max_len": MAX_LEN}
    return torch_ranks.spawn("tp", WORLD, inputs,
                             tmp_path_factory.mktemp("tp"), timeout=240.0)


def _ranks_of(got: list, case: str) -> list:
    return [r[case] for r in got if case in r]


def _within(got, want, rel: float, what: str) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _rows(res: dict, mesh: tuple, total: int) -> slice:
    rows = total // mesh[0]
    return slice(res["coords"][0] * rows, (res["coords"][0] + 1) * rows)


@pytest.mark.parametrize("case", CASES)
def test_tp_forward_logits_against_one_device(case, ranks):
    name, mesh = _split(case)
    want = _one_device(name)["logits"]
    got = _ranks_of(ranks, case)
    assert len(got) == mesh[0] * mesh[1]
    for r in got:
        _within(r["logits"], want[_rows(r, mesh, want.shape[0])], 1e-5,
                f"{case} logits at {r['coords']}")


@pytest.mark.parametrize("case", CASES)
def test_tp_train_step_against_one_device_and_reference(case, ranks):
    name, _ = _split(case)
    _, _, want_loss, want, _ = _reference(name)
    one = _one_device(name)
    got = _ranks_of(ranks, case)
    for r in got:
        np.testing.assert_allclose(float(r["loss"]), want_loss, rtol=1e-5)
        np.testing.assert_allclose(float(r["loss"]), one["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(r["grad_norm"]), one["grad_norm"],
                                   rtol=1e-5)
    grads = {p: np.asarray(v) for p, v in tree_items(got[0]["grads"])}
    assert set(grads) == set(want) == set(one["m"])
    for path, g in grads.items():
        _within(g, one["m"][path], 1e-4, f"{case} {path} (one device)")
        _within(g, want[path], 1e-3, f"{case} {path} (reference)")


@pytest.mark.parametrize("case", SERVED + [SP_CASE])
def test_tp_packed_prefill_and_decode_against_one_device(case, ranks):
    """Packed prefill and 8 greedy decode steps on the ranks' blocks: the
    tokens of the one-device unpacked path and of the reference's
    (`repro.serve.engine.prefill` / ``decode_step``), the logits within
    1e-3 of each."""
    name, mesh = _split(case)
    sp = case == SP_CASE
    name = "mixtral-8x7b" if sp else name
    wants = {"one device": _one_device(name)["serve1" if sp else "serve4"],
             "reference": _reference_serve(name, 1 if sp else 4)}
    for r in _ranks_of(ranks, case):
        logits, toks = r["serve"]
        for what, (want_logits, want_toks) in wants.items():
            rows = slice(None) if sp else _rows(r, mesh, want_toks.shape[1])
            assert np.array_equal(toks, want_toks[:, rows]), (case, what)
            err = float(np.abs(logits - want_logits[:, rows]).max())
            assert err <= 1e-3, f"{case}: logits {err} off the {what}'s"


@pytest.mark.parametrize("case", SERVED + [SP_CASE])
def test_tp_generate_equals_eager_greedy(case, ranks):
    """Greedy `generate(ctx=)` on the ranks' packed blocks, its ticks
    `decode_tick` under the ctx: the eager prefill and decode steps'
    tokens bit for bit (on the card each tick is one CUDA graph replay
    of that tick, `chip_smoke.py` phases 15a and 17a')."""
    for r in _ranks_of(ranks, case):
        toks = r["serve"][1]
        assert r["generate"].shape == toks.T.shape, case
        assert np.array_equal(r["generate"], toks.T), (case, r["coords"])


def test_no_non_moe_leaf_gathered_whole(ranks):
    """The step, the prefill and the decode steps read no non-MoE leaf
    with an all-gather; the probe sees `gather_tree`'s gathers."""
    seen = 0
    for r in ranks:
        for case, res in r.items():
            assert res.get("step_leaf_gathers", []) == [], case
            assert res.get("serve_leaf_gathers", []) == [], case
            probe = res.get("probe_leaf_gathers")
            if probe is not None and _split(case)[1][1] > 1:
                assert probe, case
                seen += 1
    assert seen


class _Mesh:
    """A shape-only ('data', 'model') mesh at one rank's coordinates."""

    def __init__(self, data: int, model: int, coords: tuple):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}
        self.coords = dict(zip(self.axis_names, coords))

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_fresh_sharded_draw_is_the_cut_whole_draw(arch, mesh):
    """`resume_or_init` without a checkpoint draws each rank's blocks a
    leaf at a time (`init_lm_params(cut=)`): bit for bit `shard_by` of the whole
    draw, at every coordinate; the AdamW moments its zeros."""
    cfg = configs.get_reduced(arch)
    opt = adamw(1e-3)

    def init_fn(d, cut=keep_all):
        gen = None if d.type == "meta" else \
            torch.Generator(device=d).manual_seed(3)
        params = init_lm_params(
            cfg, gen, device=d,
            cut=lambda p, x, st: cut("['params']" + p, x, st))
        return {"params": params, "opt_state": opt[0](params)}

    whole = init_fn(torch.device("cpu"))
    template = init_fn(torch.device("meta"))
    for coords in itertools.product(range(mesh[0]), range(mesh[1])):
        m = _Mesh(*mesh, coords)
        shardings = sharding.tree_shardings(template, cfg, m)
        got, start = resume_or_init(None, init_fn, device="cpu",
                                    shardings=shardings, mesh=m)
        want = sharding.shard_by(whole, shardings, m)
        assert start == 0
        got, want = dict(tree_items(got)), dict(tree_items(want))
        assert set(got) == set(want)
        for path, w in want.items():
            assert got[path].shape == w.shape and torch.equal(
                got[path], w), (coords, path)
        # the draw holds blocks only: a split leaf is smaller than whole
        emb = "['params']['embed']['emb']"
        assert got[emb].shape[0] == cfg.vocab_size // mesh[1]


def test_block_cutter_drops_the_stage_dim():
    """A stacked leaf's stage is cut with its placements one dim lower."""
    cfg = configs.get_reduced("chatglm3-6b")
    m = _Mesh(1, 2, (0, 1))
    meta = init_lm_params(cfg, None, device="meta")
    cut = block_cutter(sharding.tree_shardings(meta, cfg, m), m)
    path = "['slots'][0]['mlp']['up']['w']"
    whole = torch.arange(2 * 64 * 128, dtype=torch.float32).reshape(2, 64,
                                                                   128)
    assert torch.equal(cut(path, whole, False), whole[..., 64:])
    assert torch.equal(cut(path, whole[1], True), whole[1][:, 64:])
    # a row-parallel leaf splits its K, the second-to-last dim
    down = whole.reshape(2, 128, 64)
    assert torch.equal(cut("['slots'][0]['mlp']['down']['w']", down[0],
                           True), down[0][64:])
