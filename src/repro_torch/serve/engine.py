"""Serving engine: prefill + decode with slot-based continuous batching
(counterpart of ``repro/serve/engine.py``).

`decode_step` — one token for every active row against the stage-stacked
cache; the reference's scan over stages is a Python loop here. Windowed
layers (gemma2's local ones, mixtral's) use **ring KV caches** bounded by
the window; Mamba layers carry their O(1) conv and SSM states. With packed
W1A8 params (`serve.packed.deploy_lm`) each dense projection is one launch
of the popcount matmul, which reads 1 bit a weight, and each expert
projection of an MoE layer one grouped launch of it for all the experts.
As in the reference, an enc-dec tree's ``cross`` stack is not read here:
the engine decodes the decoder stack alone.

With a `ShardCtx` (``ctx=``) the layers run sharded, as in
`models.transformer.lm_forward`: this rank's rows of the batch and its
block of every leaf, attention on its query heads, and a cache that holds
the rank's block (`serve.cache.init_cache` under the ctx: its rows, its
KV heads where they split over 'model', its Mamba channels). For long
context (a batch smaller than the data ranks, so ``ctx.dp_axes`` is
empty) the KV sequence splits over 'data' (`serve.cache.sp_axis`): each
rank writes the ring slots it
holds, and a decode step's attention combines the ranks' partial softmax
(`serve.sp.sp_decode_attention`). The logits come back whole (B, vocab):
the ranks' vocabulary blocks gathered.

`decode_step` writes the new K/V rows and Mamba states into the cache's
tensors in place (as a donated buffer would be) and returns the cache with
the lengths advanced; `prefill` builds a fresh cache.

`decode_tick` runs a whole serving tick (`decode_step` and the sampling,
or `decode_step_donemask`) on fixed state tensors and writes every output
back into them; `capture_tick` captures it as one CUDA graph, the
counterpart of the reference's jitted tick, which `serve.backends.
LMBackend` and `generate` replay once a token on the card. Under a
`ShardCtx` the graph holds the step's NCCL collectives too (the EP
all-to-alls, the TP sums and gathers, the SP softmax reductions), as the
reference jits its step under a ctx.

Sampling draws from a `torch.Generator` on the logits' device (Gumbel-max
over exponential draws): the reference's ``jax.random.categorical`` draws
cannot be reproduced without JAX. Greedy rows (temperature 0) take the
argmax, as the reference's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.dist.collectives import gather_cols
from repro_torch.kernels import _build
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import (ModelConfig, _div, attention,
                                       attention_out, attention_qkv, embed,
                                       local_kv, norm, rope, softcap,
                                       unembed)
from repro_torch.models.transformer import (add_mixer_out, check_ctx,
                                            ffn_block, kinds, mamba_fns,
                                            stage, stage_count, tp_of,
                                            tree_map, window_of)
from repro_torch.device import full_f32
from repro_torch.serve.cache import (BIGPOS, init_cache,  # noqa: F401
                                     sp_axis)
from repro_torch.serve.sp import sp_decode_attention


# ---------------------------------------------------------------------------
# Attention with cache (decode: 1 token; ring writes via pos % L)
# ---------------------------------------------------------------------------

def _cache_heads(cfg: ModelConfig, kc: torch.Tensor, tp) -> tuple:
    """The KV heads [c0, c1) a cache leaf (…, KV_held, hd) holds: the
    rank's block where it holds fewer than all."""
    kvh = cfg.num_kv_heads
    return (0, kvh) if kc.shape[-2] == kvh else tp.block(kvh)


def _ring(ctx, held: int) -> tuple:
    """(the whole ring's slots, the first this rank holds) where its cache
    holds ``held`` of them: all of them unless the KV sequence splits over
    `serve.cache.sp_axis`."""
    axis = sp_axis(ctx)
    if axis is None:
        return held, 0
    return (held * axis_sizes(ctx.mesh)[axis],
            ctx.mesh.get_local_rank(axis) * held)


def _write(buf: torch.Tensor, bi, slot, new: torch.Tensor, mine) -> None:
    """``new`` into ``buf[bi, slot]``, only where ``mine`` (None: all)."""
    if mine is None:
        buf[bi, slot] = new
        return
    shape = mine.shape + (1,) * (new.dim() - 1)
    buf[bi, slot] = torch.where(mine.reshape(shape), new, buf[bi, slot])


def _attn_decode(p, cfg: ModelConfig, x, kc, vc, pc, pos, *, mode,
                 window: int, ctx=None):
    """One token's attention; kc, vc (B, L, KV, hd) and pc (B, L) are one
    stage's cache (this rank's block under ``ctx``), written in place at
    ring slot pos % L."""
    b = x.shape[0]
    hd = cfg.hd
    tp = tp_of(ctx, cfg)
    sp = sp_axis(ctx)
    c0, c1 = _cache_heads(cfg, kc, tp)
    q, k, v, (h0, h1), _ = attention_qkv(
        p, cfg, x, x, mode, tp, kv_range=None if tp is None else (c0, c1))
    q = rope(q, pos[:, None], theta=cfg.rope_theta,
             fraction=cfg.rope_fraction)
    k = rope(k, pos[:, None], theta=cfg.rope_theta,
             fraction=cfg.rope_fraction)
    held = kc.shape[1]
    length, first = _ring(ctx, held)
    slot, mine = (pos % length).long(), None
    if held < length:                           # the slots this rank holds
        mine = (slot >= first) & (slot < first + held)
        slot = torch.clamp(slot - first, 0, held - 1)
    bi = torch.arange(b, device=x.device)
    _write(kc, bi, slot, k[:, 0].to(kc.dtype), mine)
    _write(vc, bi, slot, v[:, 0].to(vc.dtype), mine)
    _write(pc, bi, slot, pos.to(pc.dtype), mine)
    g = cfg.heads_eff // cfg.num_kv_heads
    if tp is None:
        kl, vl = kc, vc
    else:
        g0, g1 = h0 // g, (h1 - 1) // g + 1
        kl, vl = local_kv(kc[:, :, g0 - c0:g1 - c0],
                          vc[:, :, g0 - c0:g1 - c0], h0, h1, g, g0)
    if sp is not None:
        if cfg.attn_softcap > 0:
            raise NotImplementedError("sequence-parallel decode attention "
                                      "has no softcap")
        out = sp_decode_attention(ctx.mesh, sp, q[:, 0], kl, vl,
                                  pc, pos)
        return attention_out(p, cfg, out.reshape(b, 1, -1).to(x.dtype),
                             mode, tp)
    kvl = kl.shape[2]
    qg = q.reshape(b, 1, kvl, (h1 - h0) // kvl, hd)
    with full_f32():
        logits = _div(torch.einsum("bskgd,btkd->bkgst", qg, kl),
                      math.sqrt(hd))
    logits = logits.to(torch.float32)
    if cfg.attn_softcap > 0:
        logits = softcap(logits, cfg.attn_softcap)
    valid = pc <= pos[:, None]                           # causal+unwritten
    if window > 0:
        valid &= pc > (pos[:, None] - window)
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    with full_f32():
        out = torch.einsum("bkgst,btkd->bskgd", probs, vl).reshape(b, 1, -1)
    return attention_out(p, cfg, out, mode, tp)


def _whole_logits(logits: torch.Tensor, tp) -> torch.Tensor:
    """The rank's vocabulary block of logits gathered whole."""
    if tp is None or tp.vocab() is None:
        return logits
    return gather_cols(logits, tp.group)


def _to_block(x: torch.Tensor, shape: tuple, tp) -> torch.Tensor:
    """``x`` cut to the rank's block wherever a dim of the cache leaf
    ``shape`` holds less of it."""
    for dim, (have, want) in enumerate(zip(x.shape, shape)):
        if have != want:
            a, b = tp.block(have)
            x = x.narrow(dim, a, b - a)
    return x


# ---------------------------------------------------------------------------
# decode_step / prefill
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, *, mode: str = "float",
                ctx=None) -> Tuple[torch.Tensor, dict]:
    """tokens (B, 1) → (logits (B, vocab), the cache advanced by one)."""
    check_ctx(ctx)
    tp = tp_of(ctx, cfg)
    pos = cache["lengths"]
    x = embed(params["embed"], tokens, tp)
    for st in range(stage_count(params)):
        x = decode_stage(cfg, stage(params["slots"], st), cache["slots"], st,
                         x, pos, mode=mode, ctx=ctx)
    x = norm(params["final_norm"], x, cfg.norm_kind)
    logits = _whole_logits(unembed(params["embed"], cfg, x, tp)[:, 0, :], tp)
    return logits, {"slots": cache["slots"], "lengths": pos + 1}


def decode_stage(cfg: ModelConfig, slots, cache_slots, st: int,
                 x: torch.Tensor, pos: torch.Tensor, *, mode: str,
                 ctx=None) -> torch.Tensor:
    """One stage of `decode_step`: its period's slots against stage ``st``
    of the cache, written in place."""
    step_fn = mamba_fns(cfg)[2]
    tp = tp_of(ctx, cfg)
    for i, (mk, fk) in enumerate(kinds(cfg)):
        slot, c = slots[i], cache_slots[i]
        h = norm(slot["norm1"], x, cfg.norm_kind)
        if mk.startswith("attn"):
            out = _attn_decode(slot["attn"], cfg, h, c["k"][st], c["v"][st],
                               c["pos"][st], pos, mode=mode,
                               window=window_of(cfg, mk), ctx=ctx)
        else:
            out, new = step_fn(slot["mamba"], cfg, h,
                               {k: v[st] for k, v in c.items()}, mode, tp)
            for k, v in new.items():
                c[k][st] = v.to(c[k].dtype)
        x = add_mixer_out(slot, cfg, x, out)
        x = ffn_block(slot, cfg, x, fk, mode, ctx)
    return x


def sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Per-row temperature sampling: argmax where temp is 0 (or with no
    ``generator``), else a categorical draw from softmax(logits / temp)
    by Gumbel-max on exponential draws from ``generator``. (B,) int32."""
    greedy = torch.argmax(logits, dim=-1)
    if generator is None:
        return greedy.to(torch.int32)
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    noise = torch.empty_like(scaled).exponential_(generator=generator)
    sampled = torch.argmax(scaled - torch.log(noise), dim=-1)
    return torch.where(temp > 0, sampled, greedy).to(torch.int32)


def decode_step_donemask(cfg: ModelConfig, params: dict, cache: dict,
                         last_tok: torch.Tensor, tok_buf: torch.Tensor,
                         n_gen: torch.Tensor, done: torch.Tensor,
                         stop_tokens: torch.Tensor, max_new: torch.Tensor,
                         temp: torch.Tensor,
                         generator: Optional[torch.Generator], *,
                         mode: str = "float", ctx=None) -> tuple:
    """One decode tick with **device-side stop detection**: sampling, the
    token-buffer append and the stop-token / max_new tests stay on the
    device; a host reads back only the (B,) bool ``done``.

    State (device tensors, B = pool slots): last_tok (B,) int32; tok_buf
    (B, cap) int32, row r valid in [0, n_gen); n_gen (B,) int32; done (B,)
    bool, True for finished *and* vacant rows; stop_tokens (B, S) int32,
    -1 padding; max_new (B,) int32; temp (B,) f32 (0 → greedy).
    ``generator`` is None unless some live row samples, the host-checked
    path's rule, so both paths draw alike. tok_buf is written in place.

    Returns (cache, last_tok, tok_buf, n_gen, done).
    """
    logits, cache = decode_step(cfg, params, cache, last_tok[:, None],
                                mode=mode, ctx=ctx)
    tok = sample_tokens(logits, temp, generator)
    live = ~done
    bi = torch.arange(tok_buf.shape[0], device=tok_buf.device)
    idx = torch.clamp(n_gen, max=tok_buf.shape[1] - 1).long()
    tok_buf[bi, idx] = torch.where(live, tok, tok_buf[bi, idx])
    n_gen = n_gen + live.to(torch.int32)
    is_stop = torch.any(tok[:, None] == stop_tokens, dim=1)
    done = done | (live & (is_stop | (n_gen >= max_new)))
    return cache, tok, tok_buf, n_gen, done


# ---------------------------------------------------------------------------
# The tick on fixed state tensors, and its CUDA graph
# ---------------------------------------------------------------------------

def decode_tick(cfg: ModelConfig, params: dict, state: dict,
                generator: Optional[torch.Generator], *,
                mode: str = "float", ctx=None) -> None:
    """One decode tick on the fixed tensors of ``state``, every output
    written back into them, so that a CUDA graph captured over the tick
    (`capture_tick`) replays it; on the CPU it is called as it is.

    ``state``: ``cache`` (an `init_cache` tree), ``last_tok`` (B,) int32
    and ``temp`` (B,) f32. With ``done`` also in it (and ``tok_buf``,
    ``n_gen``, ``stop_tokens``, ``max_new``, as `decode_step_donemask`
    takes them) the tick is the done-mask one; else the host-checked one,
    `decode_step` then `sample_tokens`. Either way ``last_tok`` gets the
    sampled row and the cache's ``lengths`` advance by one.
    """
    cache = state["cache"]
    if "done" in state:
        new, tok, _, n_gen, done = decode_step_donemask(
            cfg, params, cache, state["last_tok"], state["tok_buf"],
            state["n_gen"], state["done"], state["stop_tokens"],
            state["max_new"], state["temp"], generator, mode=mode,
            ctx=ctx)
        state["n_gen"].copy_(n_gen)
        state["done"].copy_(done)
    else:
        logits, new = decode_step(cfg, params, cache,
                                  state["last_tok"][:, None], mode=mode,
                                  ctx=ctx)
        tok = sample_tokens(logits, state["temp"], generator)
    cache["lengths"].copy_(new["lengths"])
    state["last_tok"].copy_(tok)


def clone_state(state: dict) -> dict:
    """A copy of a `decode_tick` state, every tensor cloned."""
    return tree_map(torch.clone, state)


def clone_generator(generator: Optional[torch.Generator]
                    ) -> Optional[torch.Generator]:
    """A generator on the same device in the same state (None for None)."""
    if generator is None:
        return None
    twin = torch.Generator(device=generator.device)
    twin.set_state(generator.get_state())
    return twin


def capture_tick(cfg: ModelConfig, params: dict, state: dict,
                 generator: Optional[torch.Generator], *,
                 mode: str = "float", ctx=None) -> _build.Graph:
    """`decode_tick` on ``state`` captured as a CUDA graph (the counterpart
    of the reference's jitted tick), under ``ctx`` if one is given. One
    eager warm tick runs first on a side stream, on clones of the state
    and of the generator, so it loads the kernels, fills lazy caches and
    creates the process groups' NCCL communicators (none can be created
    under capture) while the live rows and draws stay as they were; the
    capture itself runs nothing. A ``generator`` is registered with the
    graph, so each replay draws from it anew, as an eager tick would; a
    PyTorch that cannot register one raises, and so does a capture that
    fails.

    The capture's error mode is ``thread_local``: it holds this thread to
    the capture's rules and leaves other threads alone, since the NCCL
    process group's watchdog thread queries the events of the collectives
    that ran before the capture while it runs."""
    dev = state["last_tok"].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.no_grad(), torch.cuda.stream(side):
        decode_tick(cfg, params, clone_state(state),
                    clone_generator(generator), mode=mode, ctx=ctx)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator "
                f"with a CUDA graph: a sampled tick cannot be captured")
        graph.register_generator_state(generator)
    with _build.capturing() as launches, torch.no_grad(), \
            torch.cuda.device(dev), \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        decode_tick(cfg, params, state, generator, mode=mode, ctx=ctx)
    return _build.Graph(graph, launches)


def _attn_prefill(p, cfg: ModelConfig, h, c: dict, st: int, positions, *,
                  mode: str, window: int, ctx=None):
    """A prompt's attention; its K/V written into stage ``st`` of the
    slot's cache ``c`` (the ring slots this rank holds under ``ctx``)."""
    b, s = positions.shape
    dev = h.device
    tp = tp_of(ctx, cfg)
    c0, c1 = _cache_heads(cfg, c["k"], tp)
    _, k, v, _, _ = attention_qkv(p, cfg, h, h, mode, tp,
                                  kv_range=None if tp is None else (c0, c1),
                                  with_q=False)
    kr = rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    out = attention(p, cfg, h, mode=mode, causal=True, window=window,
                    positions=positions, tp=tp)
    held = c["k"].shape[2]
    length, first = _ring(ctx, held)
    take = min(s, length)
    src_from = s - take
    ring = (torch.arange(take, device=dev) + src_from) % length
    src = torch.arange(src_from, s, device=dev)
    if held < length:                        # the slots this rank holds
        mine = (ring >= first) & (ring < first + held)
        ring, src = ring[mine] - first, src[mine]
    c["k"][st][:, ring] = kr[:, src].to(c["k"].dtype)
    c["v"][st][:, ring] = v[:, src].to(c["v"].dtype)
    c["pos"][st][:, ring] = src.to(torch.int32)[None, :]
    return out


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: int, mode: str = "float",
            ctx=None) -> Tuple[torch.Tensor, dict]:
    """Process the prompt (B, S) and build the decode cache: attention K/V
    for the prompt are written at positions [0, S), the last min(S, L) of
    them into a windowed layer's ring; Mamba slots carry the post-prompt
    recurrent state."""
    check_ctx(ctx)
    tp = tp_of(ctx, cfg)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    x = embed(params["embed"], tokens, tp)
    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=dev, ctx=ctx)
    pre_fn = mamba_fns(cfg)[1]
    for st in range(stage_count(params)):
        slots = stage(params["slots"], st)
        for i, (mk, fk) in enumerate(kinds(cfg)):
            slot, c = slots[i], cache["slots"][i]
            h = norm(slot["norm1"], x, cfg.norm_kind)
            if mk.startswith("attn"):
                out = _attn_prefill(slot["attn"], cfg, h, c, st, positions,
                                    mode=mode, window=window_of(cfg, mk),
                                    ctx=ctx)
            else:
                out, new = pre_fn(slot["mamba"], cfg, h, mode=mode, tp=tp)
                for k, v in new.items():
                    c[k][st] = _to_block(v, c[k].shape[1:], tp).to(
                        c[k].dtype)
            x = add_mixer_out(slot, cfg, x, out)
            x = ffn_block(slot, cfg, x, fk, mode, ctx)
    x = norm(params["final_norm"], x, cfg.norm_kind)
    logits = _whole_logits(unembed(params["embed"], cfg, x, tp)[:, -1, :],
                           tp)
    return logits, {"slots": cache["slots"],
                    "lengths": torch.full((b,), s, dtype=torch.int32,
                                          device=dev)}


def generate(cfg: ModelConfig, params: dict, prompts: torch.Tensor, *,
             max_new: int, max_len: int, mode: str = "float",
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             ctx=None) -> torch.Tensor:
    """Greedy / temperature sampling: (B, S) prompts → (B, max_new)
    tokens. A positive temperature draws from ``generator``.

    Each token after the first is one `decode_tick` (under ``ctx``, a
    `ShardCtx`, if one is given): on the card one replay of a graph
    captured before the first (`capture_tick`), as the reference jits its
    step, with a ctx's collectives in the graph; on the CPU the tick
    itself."""
    logits, cache = prefill(cfg, params, prompts, max_len=max_len,
                            mode=mode, ctx=ctx)
    temp = torch.full((prompts.shape[0],), float(temperature),
                      dtype=torch.float32, device=prompts.device)
    gen = generator if temperature > 0 else None
    if temperature > 0 and gen is None:
        raise ValueError("temperature > 0 needs a generator")
    toks = []
    nxt = sample_tokens(logits, temp, gen)
    state = {"cache": cache, "last_tok": nxt, "temp": temp}
    graph = None
    for i in range(max_new):
        toks.append(nxt.clone())
        if i == max_new - 1:
            break
        if not nxt.is_cuda:
            decode_tick(cfg, params, state, gen, mode=mode, ctx=ctx)
            continue
        if graph is None:
            graph = capture_tick(cfg, params, state, gen, mode=mode,
                                 ctx=ctx)
        graph.replay()
    return torch.stack(toks, dim=1)
