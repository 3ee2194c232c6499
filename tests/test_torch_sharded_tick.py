"""The sharded LM decode tick (`engine.decode_tick(ctx=)`) and
`engine.generate(ctx=)` on the CPU: the (1, 1) layout of a one-rank gloo
group in this process, reduced granite-20b (dense), mixtral-8x7b (MoE:
the expert-parallel all-to-alls, the uint8 dispatch wire off and on) and
jamba-1.5-large-398b (hybrid: Mamba channels under the plan).

Tolerances: none. The tick runs the ops of the eager `decode_step(ctx=)`
(and `sample_tokens`, or `decode_step_donemask`) in the same order, from
clones of the same state and generator, so every token, count, done bit
and cache leaf is held bit for bit. At one rank the all-to-alls are
copies and the sums over one rank are skipped, so `generate(ctx=)` emits
the local `generate`'s tokens bit for bit (with the wire on, the local
path's with its expert outputs rounded through bf16, as the wire's
return leg rounds them; tests/test_torch_moe_ep.py holds the layer),
and, in float mode, the reference's (`repro.serve.engine.generate` on
the same converted params). On the card each tick is one CUDA graph
replay with its NCCL collectives captured (`engine.capture_tick(ctx=)`),
held against this eager tick by `chip_smoke.py` phase 15a; the
multi-rank ticks run on gloo ranks in tests/test_torch_tp.py and
tests/test_torch_moe_ep.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serve import engine as jengine  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import (ShardCtx,  # noqa: E402
                                            tree_items, tree_leaves)
from repro_torch.serve.engine import (clone_generator,  # noqa: E402
                                      clone_state, decode_step,
                                      decode_step_donemask, decode_tick,
                                      generate, prefill, sample_tokens)
from test_torch_lm_serve import ref_params  # noqa: E402

# name: (arch, the uint8 dispatch wire, packed)
CASES = {"granite-20b": ("granite-20b", False, False),
         "mixtral-8x7b": ("mixtral-8x7b", False, False),
         "mixtral-8x7b-wire": ("mixtral-8x7b", True, True),
         "jamba-1.5-large-398b": ("jamba-1.5-large-398b", False, False)}
MAX_LEN, MAX_NEW, TICKS = 16, 5, 2
PROMPTS = np.array([[1, 2, 3, 4], [9, 8, 7, 6]], np.int32)


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _case(name: str, mesh):
    """(cfg, jcfg, reference params, the port's, mode, ctx)."""
    arch, wire, packed = CASES[name]
    cfg, jcfg, jp, p = ref_params(arch, packed=packed)
    ctx = ShardCtx(mesh, ("data",), "model",
                   "data" if cfg.num_experts else None, a2a_quant=wire)
    return cfg, jcfg, jp, p, "w1a8_eval" if packed else "float", ctx


def _state(cfg, p, mode, ctx, *, sampled: bool, done_mask: bool) -> dict:
    """A tick's state after a prefill of PROMPTS under ``ctx``: one row
    greedy, the other at 0.8 where ``sampled``; the done-mask tick's
    token buffer, counts, stop tokens and budgets where ``done_mask``."""
    with torch.no_grad():
        logits, cache = prefill(cfg, p, torch.from_numpy(PROMPTS),
                                max_len=MAX_LEN, mode=mode, ctx=ctx)
    b = PROMPTS.shape[0]
    temp = torch.tensor([0.0, 0.8 if sampled else 0.0])
    state = {"cache": cache, "last_tok": sample_tokens(logits, temp),
             "temp": temp}
    if done_mask:
        state.update(tok_buf=torch.zeros((b, MAX_NEW), dtype=torch.int32),
                     n_gen=torch.zeros((b,), dtype=torch.int32),
                     done=torch.zeros((b,), dtype=torch.bool),
                     stop_tokens=torch.tensor([[7, -1], [3, 5]],
                                              dtype=torch.int32),
                     max_new=torch.tensor([MAX_NEW, 2], dtype=torch.int32))
    return state


def _eager(cfg, p, snap: dict, gen, mode, ctx) -> dict:
    """The eager step the tick stands for, on ``snap``."""
    if "done" not in snap:
        logits, cache = decode_step(cfg, p, snap["cache"],
                                    snap["last_tok"][:, None], mode=mode,
                                    ctx=ctx)
        return {"cache": cache,
                "last_tok": sample_tokens(logits, snap["temp"], gen)}
    cache, tok, tok_buf, n_gen, done = decode_step_donemask(
        cfg, p, snap["cache"], snap["last_tok"], snap["tok_buf"],
        snap["n_gen"], snap["done"], snap["stop_tokens"], snap["max_new"],
        snap["temp"], gen, mode=mode, ctx=ctx)
    return {"cache": cache, "last_tok": tok, "tok_buf": tok_buf,
            "n_gen": n_gen, "done": done}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("done_mask", [False, True])
def test_sharded_tick_equals_eager_step(name, sampled, done_mask, mesh):
    """Tick for tick under the ctx: the tick on its fixed tensors against
    the eager sharded step on clones of them and of the generator: every
    cache leaf, the tokens (and the done-mask tick's buffer, counts and
    done bits) bit for bit; the generator ends where the eager draws
    leave its clone, and the tick writes into the tensors it was given."""
    cfg, _, _, p, mode, ctx = _case(name, mesh)
    state = _state(cfg, p, mode, ctx, sampled=sampled, done_mask=done_mask)
    gen = torch.Generator().manual_seed(11) if sampled else None
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    with torch.no_grad():
        for t in range(TICKS):
            snap = clone_state(state)
            twin = clone_generator(gen)
            want = _eager(cfg, p, snap, twin, mode, ctx)
            decode_tick(cfg, p, state, gen, mode=mode, ctx=ctx)
            for key, w in want.items():
                pairs = (zip(tree_items(state["cache"]), tree_leaves(w))
                         if key == "cache" else [((key, state[key]), w)])
                for (path, g), x in pairs:
                    assert torch.equal(g, x), (name, t, path)
            if sampled:
                assert torch.equal(gen.get_state(), twin.get_state())
    assert [t.data_ptr() for t in tree_leaves(state)] == ptrs
    assert state["cache"]["lengths"].tolist() == [4 + TICKS] * 2


def _bf16_down(real):
    """``real`` (`moe._expert_mm`) with the down projection's outputs
    rounded through bf16, as the uint8 wire's return leg rounds them."""
    def rounded(p_, name, *args, **kw):
        y = real(p_, name, *args, **kw)
        return y.to(torch.bfloat16).to(y.dtype) if name == "down" else y
    return rounded


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_generate_equals_local_and_reference(name, mesh,
                                                     monkeypatch):
    """Greedy `generate(ctx=)` on the (1, 1) mesh: the local `generate`'s
    tokens (with the wire on, the local path's with bf16 expert outputs),
    and in float mode the reference's `generate` on the same params."""
    cfg, jcfg, jp, p, mode, ctx = _case(name, mesh)
    prompts = torch.from_numpy(PROMPTS)
    with torch.no_grad():
        got = generate(cfg, p, prompts, max_new=MAX_NEW, max_len=MAX_LEN,
                       mode=mode, ctx=ctx)
        if ctx.a2a_quant:
            monkeypatch.setattr(moe, "_expert_mm",
                                _bf16_down(moe._expert_mm))
        local = generate(cfg, p, prompts, max_new=MAX_NEW, max_len=MAX_LEN,
                         mode=mode)
    assert torch.equal(got, local), name
    if mode == "float":
        want = jengine.generate(jcfg, jp, jnp.asarray(PROMPTS),
                                max_new=MAX_NEW, max_len=MAX_LEN)
        assert np.array_equal(got.numpy(), np.asarray(want)), name
