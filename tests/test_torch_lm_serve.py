"""Port parity, LM serving: ring and Mamba caches, prefill and decode
steps against the reference's, and `LMBackend` under the `Scheduler` (CPU,
reduced configs), for the dense, MoE, SSM and hybrid families.

Tolerances, and why:

* float logits, cached K/V and Mamba states: within 1e-5·max|y| (the same
  f32 products summed in another order, two layers, eight for jamba);
  ring positions and lengths exact.
* decode ≡ teacher-forced forward (the port against itself): each step's
  logits within 1e-5·max|logit| of `lm_forward`'s at that position. The
  MoE archs' reduced configs set capacity_factor = num_experts, which
  `plan_dispatch` documents as its no-drop bound, so a token's experts do
  not depend on the batch it came in.
* packed steps: within 1e-4·max|logit| with the codes that round across a
  tie forced to the reference's (`train.ties`, each within 1e-3 of a tie
  on both sides), as tests/test_torch_lm.py explains.
* served greedy tokens: equal to the reference backend's, the packed run
  with its tie codes forced.
* sampled tokens: the port draws from a `torch.Generator` (the reference's
  ``jax.random`` draws cannot be reproduced without JAX), so they are held
  to the port's own host-checked path and to a rerun with the same seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.serve import (LMBackend, SamplingParams, Scheduler,  # noqa: E402
                               ServeRequest, cache_bytes, generate,
                               init_cache, merge_rows, prefill)
from repro_torch.serve import cache as cache_mod  # noqa: E402
from repro_torch.serve.engine import decode_step  # noqa: E402
from repro_torch.train import ties  # noqa: E402

ARCHS = configs.ARCH_NAMES
# the MoE, SSM and hybrid families served
NEW_FAMILIES = ("mixtral-8x7b", "mamba2-1.3b", "jamba-1.5-large-398b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


_INIT = {}


def ref_params(name, packed=False):
    """(cfg, jcfg, reference params, the port's converted), seed 5."""
    if name not in _INIT:
        _INIT[name] = jtransformer.init_lm_params(
            jax.random.PRNGKey(5), jconfigs.get_reduced(name))
    jp = _INIT[name]
    if packed:
        jp = jserve.deploy_lm(jp)
    return (configs.get_reduced(name), jconfigs.get_reduced(name), jp,
            convert.lm_params_from_numpy(_np(jp), device="cpu"))


class RefQuant:
    """Records the reference's activation quantizer inputs in call order
    (an ordered host callback, so jitted and scanned calls record too), to
    force the port's tie codes: the projections' `quantize_act`, the MoE
    experts' `lsq_fake_quant` (w1a8_eval; replaced by its forward value)
    and the packed experts' `repro.core.quant.quantize_act`."""

    def __init__(self, monkeypatch):
        self.recorded, real = [], jquant.quantize_act

        def recording(x, step):
            jax.debug.callback(lambda v: self.recorded.append(np.array(v)),
                               x, ordered=True)
            return real(x, step)
        self.mp = monkeypatch
        monkeypatch.setattr(jlayers, "quantize_act", recording)
        monkeypatch.setattr(jquant, "quantize_act", recording)
        monkeypatch.setattr(jmoe, "lsq_fake_quant",
                            lambda x, step, gs: recording(x, step) * step)

    def close(self):
        jax.effects_barrier()
        self.mp.undo()

    def forced(self):
        return ties.forced([torch.from_numpy(a) for a in self.recorded],
                           "quantize_act", module=layers)


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma2-27b", "chatglm3-6b",
                                  "mixtral-8x7b", "kimi-k2-1t-a32b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium", "internvl2-76b"])
def test_init_cache_matches_reference(name):
    """gemma2's local layers keep a ring of the window (8), its global
    layers max_len; every slot leaf carries the batch on axis 1."""
    cfg = configs.get_reduced(name)
    got = init_cache(cfg, 3, 32, device="cpu")
    want = _np(jserve.init_cache(jconfigs.get_reduced(name), 3, 32))
    flat, tdef = jax.tree_util.tree_flatten(want)
    assert [tuple(x.shape) for x in transformer.tree_leaves(got)] == \
        [x.shape for x in flat]
    for g, w in zip(transformer.tree_leaves(got), flat):
        assert np.array_equal(g.numpy(), w)
    if name == "gemma2-27b":
        assert got["slots"][0]["k"].shape[2] == 8
        assert got["slots"][1]["k"].shape[2] == 32
    attn = [c for c in got["slots"] if "pos" in c]
    assert all(int(c["pos"].max()) == cache_mod.BIGPOS for c in attn)


@pytest.mark.parametrize("name", ARCHS)
def test_cache_bytes_full_config(name):
    assert cache_bytes(configs.get_config(name), 4, 4096) == \
        jserve.cache_bytes(jconfigs.get_config(name), 4, 4096)


def test_merge_rows_matches_reference():
    rng = np.random.default_rng(30)
    cfg = configs.get_reduced("gemma2-27b")
    jcfg = jconfigs.get_reduced("gemma2-27b")

    def rand_cache(batch):
        c = _np(jserve.init_cache(jcfg, batch, 16))
        c = jax.tree_util.tree_map(
            lambda x: rng.integers(0, 50, x.shape).astype(x.dtype), c)
        return c
    pool, new = rand_cache(4), rand_cache(2)
    want = _np(jserve.merge_rows(jax.tree_util.tree_map(jnp.asarray, pool),
                                 jax.tree_util.tree_map(jnp.asarray, new),
                                 [3, 1]))

    def to_torch(c):
        return transformer.tree_map(torch.from_numpy, {
            "slots": tuple(c["slots"]), "lengths": c["lengths"]})
    tpool = to_torch(pool)
    got = merge_rows(tpool, to_torch(new), [3, 1])
    for g, w in zip(transformer.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(g.numpy(), w)
    # the pool passed in is left as it was
    for g, w in zip(transformer.tree_leaves(tpool),
                    jax.tree_util.tree_leaves(pool)):
        assert np.array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# prefill and decode steps
# ---------------------------------------------------------------------------

def _compare_cache(got, want, what):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            transformer.tree_leaves(got)):
        key = jax.tree_util.keystr(path)
        if "pos" in key or "lengths" in key:
            assert np.array_equal(g.numpy(), np.asarray(w)), (what, key)
        else:
            _close(g, w, 1e-5, f"{what} {key}")


def _ref_steps(jcfg, jp, prompt, mode, n):
    """The reference's prefill (max_len 16) and ``n`` greedy decode
    steps: [(logits, cache as numpy), ...]."""
    pre = jax.jit(lambda p, t: jengine.prefill(jcfg, p, t, max_len=16,
                                               mode=mode))
    step = jax.jit(lambda p, c, t: jengine.decode_step(jcfg, p, c, t,
                                                       mode=mode))
    steps = [pre(jp, jnp.asarray(prompt))]
    for _ in range(n):
        nxt = jnp.argmax(steps[-1][0], -1).astype(jnp.int32)
        steps.append(step(jp, steps[-1][1], nxt[:, None]))
    return [(np.asarray(lg), _np(c)) for lg, c in steps]


STEP_CASES = [(name, "float") for name in ("chatglm3-6b", "qwen2.5-14b",
                                           "granite-20b", "gemma2-27b")
              + NEW_FAMILIES] + \
    [("chatglm3-6b", "packed"), ("gemma2-27b", "packed"),
     ("mixtral-8x7b", "packed")]


@pytest.mark.parametrize("name,mode", STEP_CASES)
def test_prefill_and_decode_steps(name, mode, monkeypatch):
    """Prefill a prompt of 6, then 5 decode steps, each step's logits and
    cache against the reference's on the same tokens; gemma2's local ring
    (window 8) wraps from the third step on. The packed runs (chatglm3's
    half-width RoPE, gemma2's window, softcaps and post-norms) force the
    reference's tie codes."""
    packed = mode == "packed"
    cfg, jcfg, jp, p = ref_params(name, packed=packed)
    jmode = "w1a8_eval" if packed else "float"
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    rec = RefQuant(monkeypatch)
    steps = _ref_steps(jcfg, jp, prompt, jmode, 5)
    rec.close()
    assert bool(rec.recorded) == packed
    rel = 1e-4 if packed else 1e-5
    with rec.forced() as counts:
        logits, cache = prefill(cfg, p, torch.from_numpy(prompt),
                                max_len=16, mode=jmode)
        _close(logits, steps[0][0], rel, "prefill logits")
        _compare_cache(cache, steps[0][1], "prefill cache")
        for i, (jlog, jcache) in enumerate(steps[1:]):
            nxt = torch.from_numpy(np.argmax(steps[i][0], -1)
                                   .astype(np.int32))
            logits, cache = decode_step(cfg, p, cache, nxt[:, None],
                                        mode=jmode)
            _close(logits, jlog, rel, f"step {i}")
            if not packed:
                _compare_cache(cache, jcache, f"step {i}")
            assert cache["lengths"].tolist() == [7 + i] * 2
    assert len(counts) == len(rec.recorded)


def test_generate_greedy_equals_reference():
    cfg, jcfg, jp, p = ref_params("granite-20b")
    prompt = np.array([[1, 2, 3, 4], [9, 8, 7, 6]], np.int32)
    want = jengine.generate(jcfg, jp, jnp.asarray(prompt), max_new=5,
                            max_len=16)
    got = generate(cfg, p, torch.from_numpy(prompt), max_new=5, max_len=16)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_decode_equals_teacher_forced_forward(name):
    """Prefill 4 tokens, then decode the next 6 of a fixed sequence: each
    step's logits are the forward's over the whole sequence at that
    position (the port against itself); and greedy `generate` emits the
    reference's tokens."""
    cfg, jcfg, jp, p = ref_params(name)
    seq = np.random.default_rng(32).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    full = transformer.lm_forward(cfg, p, torch.from_numpy(seq))
    logits, cache = prefill(cfg, p, torch.from_numpy(seq[:, :4]),
                            max_len=16)
    _close(logits, full[:, 3], 1e-5, "prefill")
    for t in range(4, 10):
        logits, cache = decode_step(cfg, p, cache,
                                    torch.from_numpy(seq[:, t:t + 1]))
        _close(logits, full[:, t], 1e-5, f"step at {t}")
    want = jengine.generate(jcfg, jp, jnp.asarray(seq[:, :4]), max_new=5,
                            max_len=16)
    got = generate(cfg, p, torch.from_numpy(seq[:, :4]), max_new=5,
                   max_len=16)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# LMBackend under the Scheduler
# ---------------------------------------------------------------------------

def _requests():
    """Mixed prompt lengths (grouped prefill), 5 requests through 2 slots
    (slot recycling)."""
    prompts = [[1, 2, 3], [4, 1, 6, 2], [7, 2, 3], [9, 9, 1, 5], [3, 3, 3]]
    return [ServeRequest(rid=i, prompt=p,
                         sampling=SamplingParams(max_new=4 + i % 2))
            for i, p in enumerate(prompts)]


def _tokens(results):
    return {r.rid: (list(r.tokens), r.finish_reason) for r in results}


@pytest.mark.parametrize("mode", ["float", "packed"])
def test_backend_greedy_tokens_equal_reference(mode, monkeypatch):
    packed = mode == "packed"
    cfg, jcfg, jp, p = ref_params("qwen2.5-14b", packed=packed)
    rec = RefQuant(monkeypatch)
    want = _tokens(jserve.Scheduler(jserve.LMBackend(
        jcfg, jp, slots=2, max_len=16, mode="w1a8_eval")).run(_requests()))
    rec.close()
    for done_mask in (False, True):
        with rec.forced() as counts:
            got = _tokens(Scheduler(LMBackend(
                cfg, p, slots=2, max_len=16, mode="w1a8_eval",
                done_mask=done_mask, device="cpu")).run(_requests()))
        assert got == want, (done_mask, got, want)
        assert len(counts) == len(rec.recorded)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_backend_greedy_tokens_equal_reference_moe_ssm_hybrid(name):
    """Float params: the port's `LMBackend`, both termination paths,
    against the reference's `LMBackend` on the same params and stream."""
    cfg, jcfg, jp, p = ref_params(name)

    def reqs():                # one prompt length: one prefill to compile
        return [ServeRequest(rid=i, prompt=[1 + i, 2, 3],
                             sampling=SamplingParams(max_new=3 + i % 2))
                for i in range(4)]
    want = _tokens(jserve.Scheduler(jserve.LMBackend(
        jcfg, jp, slots=2, max_len=16)).run(reqs()))
    for done_mask in (False, True):
        got = _tokens(Scheduler(LMBackend(
            cfg, p, slots=2, max_len=16, done_mask=done_mask,
            device="cpu")).run(reqs()))
        assert got == want, (name, done_mask)


@pytest.fixture(scope="module")
def granite():
    cfg = configs.get_reduced("granite-20b")
    gen = torch.Generator().manual_seed(6)
    return cfg, transformer.init_lm_params(cfg, gen, device="cpu")


def _serve(cfg, params, reqs, *, done_mask, slots=2, seed=17):
    sched = Scheduler(LMBackend(cfg, params, slots=slots, max_len=32,
                                done_mask=done_mask, seed=seed,
                                device="cpu"))
    results = sched.run(reqs)
    return {r.rid: (r.tokens, r.finish_reason, r.n_ticks)
            for r in results}, sched.metrics.summary()


def test_done_mask_equals_host_checked(granite):
    """Greedy, sampled and multi-stop requests, one stopping at its first
    (prefill) token: the device done-mask path emits the host-checked
    path's tokens, with one bool a slot read back a tick."""
    cfg, params = granite
    oracle = generate(cfg, params, torch.tensor([[1, 2, 3]]), max_new=8,
                      max_len=32)[0].tolist()

    def reqs():
        return [
            ServeRequest(rid=0, prompt=[1, 2, 3], sampling=SamplingParams(
                max_new=8, stop_tokens=(oracle[0],))),
            ServeRequest(rid=1, prompt=[1, 2, 3], sampling=SamplingParams(
                max_new=8, stop_tokens=(10_000, oracle[3]))),
            ServeRequest(rid=2, prompt=[4, 1, 2, 5], sampling=SamplingParams(
                max_new=6, temperature=0.8)),
            ServeRequest(rid=3, prompt=[7, 2, 3], sampling=SamplingParams(
                max_new=5)),
            ServeRequest(rid=4, prompt=[9, 9, 1], sampling=SamplingParams(
                max_new=3, temperature=1.2, stop_tokens=(3,))),
        ]

    host, host_summary = _serve(cfg, params, reqs(), done_mask=False)
    dev, dm_summary = _serve(cfg, params, reqs(), done_mask=True)
    assert dev == host
    first_stop = oracle.index(oracle[3]) + 1
    assert dev[0][0] == [oracle[0]] and dev[0][1] == "stop"
    assert dev[1][0] == oracle[:first_stop] and dev[1][1] == "stop"
    assert dev[3][1] == "length" and len(dev[3][0]) == 5
    assert dm_summary["host_syncs"] == dm_summary["ticks"]
    assert 0 < dm_summary["completion_syncs"] <= dm_summary["ticks"]
    assert dm_summary["host_sync_bytes_per_tick"] == 2      # 2 slots × bool
    assert host_summary["host_sync_bytes_per_tick"] == 8    # 2 slots × i32
    # the same seed draws the same tokens; the greedy row is generate's
    again, _ = _serve(cfg, params, reqs(), done_mask=True)
    assert again == dev
    assert dev[3][0] == generate(cfg, params, torch.tensor([[7, 2, 3]]),
                                 max_new=5, max_len=32)[0].tolist()


def test_done_mask_slot_recycling(granite):
    """6 requests through a 2-slot pool: recycled slots reset the device
    token buffer and done bits."""
    cfg, params = granite

    def reqs():
        return [ServeRequest(rid=i, prompt=[1 + i, 2, 3],
                             sampling=SamplingParams(max_new=3 + i % 2))
                for i in range(6)]
    host, _ = _serve(cfg, params, reqs(), done_mask=False)
    dev, _ = _serve(cfg, params, reqs(), done_mask=True)
    assert dev == host
    for i in range(6):
        assert host[i][0] == generate(
            cfg, params, torch.tensor([[1 + i, 2, 3]]), max_new=3 + i % 2,
            max_len=32)[0].tolist()


def test_run_lm_on_the_cpu():
    """The launcher's lm workload, reduced and packed: the two termination
    paths agree (it raises otherwise) and the record carries the numbers
    the card's run prints."""
    rec = launch_serve.main(["--workload", "lm", "--device", "cpu",
                             "--reduced", "--packed", "--arch",
                             "chatglm3-6b", "--requests", "3", "--slots",
                             "2", "--max-new", "4", "--max-len", "16"])
    assert rec["workload"] == "lm" and rec["device"] == "cpu"
    assert rec["requests_completed"] == 3 and rec["tokens"] == 12
    assert rec["tok_per_s"] > 0 and rec["tick_p95_ms"] >= \
        rec["tick_p50_ms"] > 0
    assert rec["kernel_launches_per_decode_step"] == {}     # no card
    assert rec["packed_bytes"]["ratio"] > 2
    assert rec["baseline_host_check"]["host_sync_bytes_per_tick"] == 8
