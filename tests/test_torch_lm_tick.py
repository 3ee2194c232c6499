"""The LM decode tick on fixed state tensors (`engine.decode_tick`), the
state `LMBackend` keeps for it, the in-place row write of admission
(`cache.write_rows`) and the launch accounting of a tick's graph replays
(CPU, reduced configs of a dense, an MoE and an SSM-hybrid arch).

Tolerances: none. The tick runs the same ops in the same order as the
eager `decode_step` / `decode_step_donemask` it stands for, from clones of
the same state and of the same generator, so every token, count, done bit
and cache leaf is held bit for bit. The reference's tick is jitted; the
port's on the card is one CUDA graph replay of this tick, held against the
eager step on the card by `chip_smoke.py` phase 19.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.transformer import (init_lm_params,  # noqa: E402
                                            tree_items, tree_leaves)
from repro_torch.serve import (LMBackend, SamplingParams,  # noqa: E402
                               ServeRequest, generate, init_cache,
                               merge_rows)
from repro_torch.serve import backends  # noqa: E402
from repro_torch.serve.cache import write_rows  # noqa: E402
from repro_torch.serve.engine import (clone_generator,  # noqa: E402
                                      clone_state, decode_step,
                                      decode_step_donemask, decode_tick,
                                      prefill, sample_tokens)

# a dense, an MoE and an SSM-hybrid arch
ARCHS = ("granite-20b", "mixtral-8x7b", "jamba-1.5-large-398b")
SLOTS, MAX_LEN = 2, 16

_PARAMS = {}


def _model(name):
    if name not in _PARAMS:
        cfg = configs.get_reduced(name)
        gen = torch.Generator().manual_seed(9)
        _PARAMS[name] = cfg, init_lm_params(cfg, gen, device="cpu")
    return _PARAMS[name]


def _request(rid, prompt, sampled, stops=()):
    return ServeRequest(rid=rid, prompt=prompt, sampling=SamplingParams(
        max_new=12, temperature=0.8 if sampled else 0.0,
        stop_tokens=tuple(stops)))


def _backend(name, *, done_mask, seed=17):
    cfg, params = _model(name)
    return LMBackend(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                     done_mask=done_mask, seed=seed, device="cpu")


def _ptrs(backend):
    return {path: t.data_ptr() for path, t in tree_items(backend._state)}


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("done_mask", [False, True])
def test_state_tensors_keep_their_storage(name, sampled, done_mask):
    """Admit, step, release and re-admit write into the tensors the tick
    was built over (a captured graph reads those addresses), and the
    backend's own names are those tensors."""
    backend = _backend(name, done_mask=done_mask)
    state = backend._state
    assert state["cache"] is backend.cache
    assert state["last_tok"] is backend.last_tok
    if done_mask:
        for key in ("tok_buf", "n_gen", "done"):
            assert state[key] is getattr(backend, key)
    ptrs = _ptrs(backend)
    assert len(ptrs) == len(tree_leaves(backend.cache)) + \
        (7 if done_mask else 2)
    backend.admit([(0, _request(0, [1, 2, 3], sampled)),
                   (1, _request(1, [4, 5], False))])
    assert _ptrs(backend) == ptrs
    for _ in range(2):
        backend.step()
        backend.harvest()
        assert _ptrs(backend) == ptrs
    backend.release(0)
    backend.admit([(0, _request(2, [6, 1, 2], sampled))])
    backend.step()
    backend.harvest()
    assert _ptrs(backend) == ptrs
    assert int(backend.cache["lengths"][0]) == 4     # re-admitted: 3 + 1


@pytest.mark.parametrize("name", ["gemma2-27b", "jamba-1.5-large-398b"])
def test_write_rows_equals_merge_rows(name):
    """Ring, full and Mamba leaves: the in-place write leaves the pool as
    `merge_rows` returns it, and ``new`` as it was."""
    cfg = configs.get_reduced(name)
    gen = torch.Generator().manual_seed(3)

    def rand_cache(batch):
        c = init_cache(cfg, batch, MAX_LEN, device="cpu")
        for leaf in tree_leaves(c):
            leaf.copy_(torch.randint(0, 50, leaf.shape, generator=gen)
                       .to(leaf.dtype))
        return c
    pool, new = rand_cache(4), rand_cache(2)
    new_before = [x.clone() for x in tree_leaves(new)]
    want = merge_rows(pool, new, [3, 1])
    ptrs = [x.data_ptr() for x in tree_leaves(pool)]
    write_rows(pool, new, [3, 1])
    assert [x.data_ptr() for x in tree_leaves(pool)] == ptrs
    for got, w in zip(tree_leaves(pool), tree_leaves(want)):
        assert torch.equal(got, w)
    for got, w in zip(tree_leaves(new), new_before):
        assert torch.equal(got, w)


def _eager_tick(backend, snap, gen):
    """The eager step the backend's tick stands for, on ``snap`` (a clone
    of its state) with the host's per-row inputs, drawing from ``gen``."""
    cfg, params = backend.cfg, backend.params
    temp = torch.from_numpy(backend.temp.copy())
    if not backend.done_mask:
        logits, cache = decode_step(cfg, params, snap["cache"],
                                    snap["last_tok"][:, None])
        tok = sample_tokens(logits, temp, gen)
        return {"cache": cache, "last_tok": tok}
    cache, tok, tok_buf, n_gen, done = decode_step_donemask(
        cfg, params, snap["cache"], snap["last_tok"], snap["tok_buf"],
        snap["n_gen"], snap["done"],
        torch.from_numpy(backend._stops_pad.copy()),
        torch.from_numpy(backend._max_new_host.astype(np.int32)), temp,
        gen)
    return {"cache": cache, "last_tok": tok, "tok_buf": tok_buf,
            "n_gen": n_gen, "done": done}


@pytest.mark.parametrize("name", ["granite-20b", "mixtral-8x7b"])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("done_mask", [False, True])
def test_tick_equals_eager_step(name, sampled, done_mask):
    """Tick for tick, the backend's tick on its fixed tensors against the
    eager step on clones of them and of its generator: tokens, counts,
    done bits, the token buffer and every cache leaf bit for bit; the
    generator ends where the eager draws leave its clone."""
    backend = _backend(name, done_mask=done_mask)
    backend.admit([(0, _request(0, [1, 2, 3], sampled, stops=(7,))),
                   (1, _request(1, [4, 5, 6], sampled))])
    for _ in range(4):
        snap = clone_state(backend._state)
        gen = clone_generator(backend._gen) if sampled else None
        want = _eager_tick(backend, snap, gen)
        backend.step()
        got = backend._state
        for key, w in want.items():
            if key == "cache":
                for (path, g), x in zip(tree_items(got["cache"]),
                                        tree_leaves(w)):
                    assert torch.equal(g, x), path
            else:
                assert torch.equal(got[key], w), key
        if sampled:
            assert torch.equal(backend._gen.get_state(), gen.get_state())
        backend.harvest()


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_generate_equals_the_eager_loop(temperature):
    """`generate`'s ticks emit the eager loop's tokens: `decode_step`, then
    `sample_tokens` from a generator in the same state."""
    cfg, params = _model("granite-20b")
    prompts = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    got = generate(cfg, params, prompts, max_new=5, max_len=MAX_LEN,
                   temperature=temperature, generator=gens[0])
    logits, cache = prefill(cfg, params, prompts, max_len=MAX_LEN)
    temp = torch.full((2,), temperature)
    gen = gens[1] if temperature > 0 else None
    nxt, want = sample_tokens(logits, temp, gen), []
    for i in range(5):
        want.append(nxt)
        if i < 4:
            logits, cache = decode_step(cfg, params, cache, nxt[:, None])
            nxt = sample_tokens(logits, temp, gen)
    assert torch.equal(got, torch.stack(want, dim=1))


@pytest.fixture
def stub_kernels():
    """Two kernels whose launches run nothing and report no error (as in
    tests/test_torch_graph.py)."""
    kernels = [_build.Kernel("stub.cu", name, []) for name in ("a", "b")]
    for k in kernels:
        k._fn = lambda *args: 0
    yield kernels
    for k in kernels:
        _build.KERNELS.remove(k)


class _StandIn:
    """A graph whose replay runs the tick it was captured over, eagerly."""

    def __init__(self, run):
        self.replay = run


def _step_as_on_the_card(backend):
    """`LMBackend.step` down the card's path (the rest stays on the CPU)."""
    backend.device = torch.device("cuda")
    try:
        backend.step()
    finally:
        backend.device = torch.device("cpu")


@pytest.mark.parametrize("replays", [1, 3])
def test_replays_add_the_captured_launches(stub_kernels, monkeypatch,
                                           replays):
    """On the card's path (a stand-in graph in place of the capture) each
    tick replays the graph of its variant, captured once at the first tick
    that needs it; ``decode_launches`` gets each replay's captured
    launches and nothing of the capture, and the tokens are the CPU
    path's."""
    a, b = stub_kernels
    captured = []

    def capture(cfg, params, state, gen, *, mode):
        captured.append(gen is not None)
        a()                                   # the warm tick: not counted
        with _build.capturing() as launches:
            a()
            a()
            b()
        return _build.Graph(_StandIn(lambda: decode_tick(
            cfg, params, state, gen, mode=mode)), launches)
    monkeypatch.setattr(backends, "capture_tick", capture)
    plain = _backend("granite-20b", done_mask=True)
    card = _backend("granite-20b", done_mask=True)
    for backend in (plain, card):
        backend.admit([(0, _request(0, [1, 2, 3], False)),
                       (1, _request(1, [4, 5, 6], False))])
    for _ in range(replays):
        plain.step()
        _step_as_on_the_card(card)
    assert captured == [False]
    assert dict(card.decode_launches) == {"a": 2 * replays, "b": replays}
    assert (a.launches, b.launches) == (1 + 2 * replays, replays)
    assert card.decode_steps == replays
    assert torch.equal(card.tok_buf, plain.tok_buf)
    # a sampled row: the sampled variant's graph, captured once more
    card.release(1)
    card.admit([(1, _request(2, [7, 8], True))])
    _step_as_on_the_card(card)
    _step_as_on_the_card(card)
    assert captured == [False, True]
    assert dict(card.decode_launches) == {"a": 2 * (replays + 2),
                                          "b": replays + 2}


def test_failed_capture_raises(monkeypatch):
    """No fallback: a capture that fails raises out of the tick."""
    def capture(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(backends, "capture_tick", capture)
    backend = _backend("granite-20b", done_mask=False)
    backend.admit([(0, _request(0, [1, 2, 3], False))])
    with pytest.raises(RuntimeError, match="capturing"):
        _step_as_on_the_card(backend)
    assert backend.decode_steps == 0
