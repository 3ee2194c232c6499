"""Generic LM assembly over stage-stacked params: dense / MoE / SSM /
hybrid / enc-dec (counterpart of ``repro/models/transformer.py``).

The layer pattern repeats with period ``cfg.period`` (1 for uniform stacks,
2 for gemma2's local / global pair and jamba's MoE every other layer, 8
for jamba's 1 attention : 7 Mamba). Each param leaf under
``params["slots"]`` carries a leading ``(num_layers // period,)`` stage
axis, as the reference's; where the reference scans over that axis, the
port loops over it in Python.

W1A8 (the paper's technique): every body projection runs through
`layers.linear` in the requested mode; embedding and LM head stay full
precision (the Conv1/Conv11 rule).

MoE layers run `moe.moe_ffn`: every expert local without a `ShardCtx`;
with one, expert-parallel over ``ctx.ep_axis`` (all-to-all of the
dispatch buffer), the expert hidden dim tensor-parallel over
``ctx.tp_axis`` (its sum over the model ranks), as the reference's
``shard_map`` does. One rank computes what its shard of the reference's
global arrays would: under a ctx ``tokens`` are this rank's share of the
batch over ``ctx.dp_axes`` and every leaf is the rank's block under
`dist.sharding.tree_shardings` (where an MoE leaf's layout differs from
the reference's ``in_specs``, `_apply_moe` re-lays it first). The dense
layers run tensor-parallel over ``ctx.tp_axis`` by the plan
`dist.sharding.tp_plan` derives from the same rules (`models.layers`):
column- and row-parallel projections, attention on the rank's heads, the
embedding and head on its vocabulary block (`lm_forward` then returns the
rank's block of the logits), Mamba's products gathered around its whole
scans (`models.mamba`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (Leaf, ModelConfig, attention, embed,
                                       init_attention, init_embed, init_mlp,
                                       init_norm, mlp, norm, unembed)
# the param and cache trees' map, leaves and paths (nested dicts and tuples)
from repro_torch.optim.optimizers import (tree_items,  # noqa: F401
                                          tree_leaves, tree_map,
                                          tree_map_with_path)


def kinds(cfg: ModelConfig) -> list:
    """(mixer, ffn) kind of each slot of one stage."""
    return [(cfg.mixer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.period)]


def window_of(cfg: ModelConfig, mixer_kind: str) -> int:
    """The attention window of a slot (0: none)."""
    if mixer_kind == "attn_local" or (cfg.sliding_window and
                                      not cfg.local_global):
        return cfg.sliding_window
    return 0


def stage(tree, i: int):
    """Stage ``i`` of stage-stacked slots: every leaf indexed on axis 0."""
    return tree_map(lambda x: x[i], tree)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Distribution context threaded through the model (None ⇒ local).
    ``mesh`` is a `DeviceMesh` (`launch.mesh`); the axes name its dims."""
    mesh: Any
    dp_axes: tuple            # axes the batch / tokens are sharded over
    tp_axis: Optional[str]    # tensor-parallel axis ('model')
    ep_axis: Optional[str]    # expert-parallel axis (None ⇒ replicated)
    a2a_quant: bool = False   # uint8-wire MoE dispatch
    _plans: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)


def check_ctx(ctx) -> None:
    if ctx is not None and not isinstance(ctx, ShardCtx):
        raise TypeError(f"ctx must be a ShardCtx or None, got "
                        f"{type(ctx).__name__}")


def tp_of(ctx: Optional[ShardCtx], cfg: ModelConfig):
    """The rank's `dist.sharding.TPPlan` under ``ctx`` (None: local),
    made once a ctx and config."""
    if ctx is None or ctx.tp_axis is None:
        return None
    plan = ctx._plans.get(id(cfg))
    if plan is None or plan.cfg is not cfg:
        from repro_torch.dist.sharding import tp_plan
        plan = ctx._plans[id(cfg)] = tp_plan(cfg, ctx.mesh, ctx.tp_axis)
    return plan


# ---------------------------------------------------------------------------
# Init: a tree of `layers.Leaf` specs, then tensors drawn stage by stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stack:
    """A subtree of leaf specs stacked over ``n`` stages: every leaf gets
    a leading (n,) axis and is drawn one stage at a time."""
    tree: Any
    n: int


def _init_slot(cfg: ModelConfig, mixer_kind: str, ffn_kind: str) -> dict:
    slot = {"norm1": init_norm(cfg.d_model, cfg.norm_kind)}
    if mixer_kind.startswith("attn"):
        slot["attn"] = init_attention(cfg)
    else:
        slot["mamba"] = mb.init_mamba(cfg)
    if cfg.post_norms:
        slot["post_norm1"] = init_norm(cfg.d_model, cfg.norm_kind)
    if ffn_kind != "none":
        slot["norm2"] = init_norm(cfg.d_model, cfg.norm_kind)
        if ffn_kind == "moe":
            slot["moe"] = moe_mod.init_moe(cfg)
        else:
            slot["mlp"] = init_mlp(cfg)
        if cfg.post_norms:
            slot["post_norm2"] = init_norm(cfg.d_model, cfg.norm_kind)
    return slot


def lm_param_specs(cfg: ModelConfig) -> dict:
    """The reference's param tree as leaf specs: ``embed``,
    ``final_norm``, ``slots`` (one dict per slot of the period, stacked
    over num_layers // period stages) and, for enc-dec, ``encoder`` and
    ``cross``."""
    period = cfg.period
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    specs = {"embed": init_embed(cfg),
             "final_norm": init_norm(cfg.d_model, cfg.norm_kind),
             "slots": Stack(tuple(_init_slot(cfg, mk, fk)
                                  for mk, fk in kinds(cfg)),
                            cfg.num_layers // period)}
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, num_layers=cfg.encoder_layers,
                                      attn_every=0, local_global=False,
                                      num_experts=0)
        specs["encoder"] = {
            "slots": Stack((_init_slot(enc_cfg, "attn", "dense"),),
                           cfg.encoder_layers),
            "final_norm": init_norm(cfg.d_model, cfg.norm_kind)}
        specs["cross"] = Stack({"norm": init_norm(cfg.d_model,
                                                  cfg.norm_kind),
                                "attn": init_attention(cfg)},
                               cfg.num_layers)
    return specs


def keep_all(path: str, leaf, stacked: bool):
    """The identity ``cut`` (`allocate`): every leaf whole."""
    return leaf


def allocate(spec, lead: tuple, dtype, dev, cut=keep_all,
             paths: Optional[dict] = None, path: str = ""):
    """Tensors for ``spec`` with constants filled; drawn leaves are left
    empty. ``cut(path, whole, stacked)`` gives the part of each leaf to
    hold (one stage's where ``stacked``; default all of it), and
    ``paths``, where given, gets each tensor's path by id."""
    if isinstance(spec, Stack):
        return allocate(spec.tree, (spec.n,), dtype, dev, cut, paths, path)
    if isinstance(spec, Leaf):
        meta = torch.empty(spec.shape, dtype=dtype, device="meta")
        shape = tuple(cut(path, meta, bool(lead)).shape)
        t = torch.empty(lead + shape, dtype=dtype, device=dev)
        if not spec.std and dev.type != "meta":
            fill = spec.fill
            if callable(fill):
                t.copy_(cut(path, fill(dtype, dev), bool(lead)))
            else:
                t.fill_(fill)
        if paths is not None:
            paths[id(t)] = path
        return t
    if isinstance(spec, tuple):
        return tuple(allocate(s, lead, dtype, dev, cut, paths,
                              f"{path}[{i}]") for i, s in enumerate(spec))
    return {k: allocate(v, lead, dtype, dev, cut, paths, f"{path}[{k!r}]")
            for k, v in spec.items()}


def write_leaf(out: dict, name: str, st: Optional[int],
               x: torch.Tensor) -> None:
    """`draw`'s default sink: ``x`` into stage ``st`` of ``out[name]``
    (the whole leaf outside a stack)."""
    (out[name] if st is None else out[name][st]).copy_(x)


def draw(spec, out, gen, dtype, dev, sink=write_leaf,
         st: Optional[int] = None) -> None:
    """Draws the random leaves of ``spec`` in the spec's order, each one
    stage's leaf at a time, N(0, 1) from ``gen`` times the leaf's std,
    and hands it to ``sink(node, name, stage, tensor)`` with the node of
    ``out`` that holds it (``stage`` None outside a stack). A stack draws
    stage-major: every leaf of stage 0, then of stage 1, and so on."""
    if isinstance(spec, Stack):
        for i in range(spec.n):
            draw(spec.tree, out, gen, dtype, dev, sink, i)
        return
    if isinstance(spec, tuple):
        for s, o in zip(spec, out):
            draw(s, o, gen, dtype, dev, sink, st)
        return
    for name, s in spec.items():
        if not isinstance(s, Leaf):
            draw(s, out[name], gen, dtype, dev, sink, st)
        elif s.std:
            x = torch.empty(s.shape, dtype=dtype, device=dev)
            sink(out, name, st, x.normal_(generator=gen).mul_(s.std))
            del x                        # gone before the next is drawn


def materialize(specs, generator: Optional[torch.Generator], device=None,
                dtype=torch.float32, cut=keep_all):
    """Tensors for a spec tree on ``device`` (default: the card), random
    leaves drawn from ``generator`` (which lives on ``device``). On
    ``meta`` only the shapes are made and ``generator`` may be None.
    ``cut(path, leaf, stacked)`` keeps a part of each leaf (`allocate`;
    e.g. a rank's block, `train.loop.block_cutter`): each leaf of each
    stage is still drawn whole, in the same order, and the rest freed
    before the next draw, so the part is bit for bit the whole draw's
    and the peak is one stage's leaf beside the parts."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError(f"init_lm_params needs a torch.Generator on {dev}")
    paths: dict = {}
    out = allocate(specs, (), dtype, dev, cut, paths)

    def sink(node: dict, name: str, st: Optional[int], x: torch.Tensor):
        t = node[name]
        write_leaf(node, name, st, cut(paths[id(t)], x, st is not None))
    if dev.type != "meta":
        draw(specs, out, generator, dtype, dev, sink)
    return out


def init_lm_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                   device=None, dtype=torch.float32, cut=keep_all) -> dict:
    """Random-init params in the reference's tree (`lm_param_specs`),
    drawn from ``generator``, which lives on ``device`` (default: the
    card). Each leaf of a stage-stacked subtree is allocated whole and
    drawn one stage at a time, stage-major, so a packed init
    (`serve.packed.init_packed_lm`) can draw the same values one stage's
    leaf at a time. On ``device="meta"`` only the shapes are made and
    ``generator`` may be None: `count_lm_params` of a full config needs
    no memory. ``cut``: `materialize`'s (a rank's blocks of the tree,
    without the whole tree)."""
    return materialize(lm_param_specs(cfg), generator, device, dtype, cut)


def count_lm_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def add_mixer_out(slot: dict, cfg: ModelConfig, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """The residual add after a mixer (post-norm first, for gemma2)."""
    if cfg.post_norms:
        out = norm(slot["post_norm1"], out, cfg.norm_kind)
    return x + out.to(x.dtype)


def moe_axes(cfg: ModelConfig, slot_moe: dict, ctx: ShardCtx) -> tuple:
    """(ep, tp, shared tp) axis names of one MoE layer under ``ctx``, the
    reference's choices: EP only where the experts split evenly; the
    expert hidden dim F split only where every F-indexed leaf splits (the
    packed words too); the shared experts' F likewise."""
    sizes = axis_sizes(ctx.mesh)
    ep = ctx.ep_axis if (ctx.ep_axis and cfg.num_experts %
                         sizes[ctx.ep_axis] == 0) else None
    tp = ctx.tp_axis
    tp_n = sizes[tp] if tp else 1
    packed = "up_packed" in slot_moe
    ok = tp and cfg.d_ff % tp_n == 0 and \
        (not packed or (cfg.d_ff // 32) % tp_n == 0)
    sh_ok = tp and cfg.shared_experts and \
        (cfg.d_ff * cfg.shared_experts) % tp_n == 0
    return ep, tp if ok else None, tp if sh_ok else None


def _apply_moe(slot_moe: dict, cfg: ModelConfig, x: torch.Tensor,
               mode: str, ctx: Optional[ShardCtx]) -> torch.Tensor:
    b, s, d = x.shape
    toks = x.reshape(b * s, d)
    if ctx is None:
        return moe_mod.moe_ffn(slot_moe, cfg, toks,
                               mode=mode).reshape(b, s, d)
    from repro_torch.dist.sharding import moe_in_layout
    ep, tp, tp_sh = moe_axes(cfg, slot_moe, ctx)

    def group(axis):
        return None if axis is None else ctx.mesh.get_group(axis)
    y = moe_mod.moe_ffn(moe_in_layout(slot_moe, cfg, ctx.mesh, ep, tp,
                                      tp_sh),
                        cfg, toks, mode=mode, ep_group=group(ep),
                        tp_group=group(tp), shared_tp=group(tp_sh),
                        a2a_quant=ctx.a2a_quant)
    return y.reshape(b, s, d)


def ffn_block(slot: dict, cfg: ModelConfig, x: torch.Tensor, ffn_kind: str,
              mode: str, ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """norm2 → dense MLP or MoE (→ post-norm) → residual add."""
    if ffn_kind == "none":
        return x
    h = norm(slot["norm2"], x, cfg.norm_kind)
    if ffn_kind == "moe":
        out = _apply_moe(slot["moe"], cfg, h, mode, ctx)
    else:
        out = mlp(slot["mlp"], cfg, h, mode, tp_of(ctx, cfg))
    if cfg.post_norms:
        out = norm(slot["post_norm2"], out, cfg.norm_kind)
    return x + out.to(x.dtype)


def mamba_fns(cfg: ModelConfig) -> tuple:
    """(mixer, prefill, decode step) of the config's SSM kind."""
    if cfg.ssm_kind == "mamba2":
        return mb.mamba2_mixer, mb.mamba2_prefill, mb.mamba2_decode_step
    return mb.mamba1_mixer, mb.mamba1_prefill, mb.mamba1_decode_step


def _apply_slot(slot: dict, cfg: ModelConfig, x: torch.Tensor, *,
                mixer_kind: str, ffn_kind: str, mode: str,
                positions: torch.Tensor,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    h = norm(slot["norm1"], x, cfg.norm_kind)
    tp = tp_of(ctx, cfg)
    if mixer_kind.startswith("attn"):
        out = attention(slot["attn"], cfg, h, mode=mode, causal=True,
                        window=window_of(cfg, mixer_kind),
                        positions=positions, tp=tp)
    else:
        out = mamba_fns(cfg)[0](slot["mamba"], cfg, h, mode=mode, tp=tp)
    x = add_mixer_out(slot, cfg, x, out)
    return ffn_block(slot, cfg, x, ffn_kind, mode, ctx)


def stage_count(params: dict) -> int:
    return tree_leaves(params["slots"])[0].shape[0]


def apply_stage(cfg: ModelConfig, slots, x: torch.Tensor, *, mode: str,
                positions: torch.Tensor, ctx: Optional[ShardCtx] = None,
                cross: Optional[dict] = None,
                enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One stage of the body: its period's slots, then, for enc-dec, its
    cross-attention stage (``cross``) over ``enc_out``."""
    for i, (mk, fk) in enumerate(kinds(cfg)):
        x = _apply_slot(slots[i], cfg, x, mixer_kind=mk, ffn_kind=fk,
                        mode=mode, positions=positions, ctx=ctx)
    if cross is not None:
        h = norm(cross["norm"], x, cfg.norm_kind)
        x = x + attention(cross["attn"], cfg, h, mode=mode, causal=False,
                          positions=positions, kv_x=enc_out,
                          tp=tp_of(ctx, cfg)).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Forward (train/eval)
# ---------------------------------------------------------------------------

def lm_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
               mode: str = "float",
               prefix_embeds: Optional[torch.Tensor] = None,
               encoder_embeds: Optional[torch.Tensor] = None,
               ctx: Optional[ShardCtx] = None,
               remat: bool = False) -> torch.Tensor:
    """tokens (B, S) int → logits (B, S_total, vocab).

    prefix_embeds: (B, S_p, D) modality stub (vision patches) prepended to
    the token embeddings (internvl2). encoder_embeds: (B, S_enc, D)
    encoder input features for enc-dec (seamless): the encoder stack runs,
    then each decoder stage cross-attends to its output. As in the
    reference, a tree with a ``cross`` stack runs it after every stage
    even without ``encoder_embeds``: as non-causal self-attention.

    remat: each stage (with its cross stage) runs under
    ``torch.utils.checkpoint`` where autograd records, as the reference's
    ``jax.checkpoint``: its activations are recomputed in the backward,
    not kept. A stage draws no random number and reads no state the
    forward changes, so the recomputed forward quantizes exactly as the
    first did.

    ctx: a `ShardCtx`; the layers then run sharded (see the module's
    docstring for what this rank's ``tokens`` and ``params`` hold), and
    where the plan splits the vocabulary the logits are the rank's block
    (B, S_total, vocab / n)."""
    check_ctx(ctx)
    tp = tp_of(ctx, cfg)
    x = embed(params["embed"], tokens, tp)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    enc_out = None
    if encoder_embeds is not None:
        enc_out = encode(cfg, params, encoder_embeds, mode=mode, ctx=ctx)
    cross = params.get("cross")

    def run_stage(x: torch.Tensor, st: int) -> torch.Tensor:
        return apply_stage(cfg, stage(params["slots"], st), x, mode=mode,
                           positions=positions, ctx=ctx,
                           cross=None if cross is None else stage(cross, st),
                           enc_out=enc_out)

    checkpointed = remat and torch.is_grad_enabled()
    for st in range(stage_count(params)):
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(
                run_stage, x, st, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x = run_stage(x, st)
    x = norm(params["final_norm"], x, cfg.norm_kind)
    return unembed(params["embed"], cfg, x, tp)


def encode(cfg: ModelConfig, params: dict, feats: torch.Tensor, *,
           mode: str = "float",
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Bidirectional encoder over stub features (B, S_enc, D); under
    ``ctx`` its layers run tensor-parallel as the decoder's."""
    check_ctx(ctx)
    tp = tp_of(ctx, cfg)
    enc = params["encoder"]
    b, s, _ = feats.shape
    positions = torch.arange(s, device=feats.device).expand(b, s)
    x = feats.to(params["embed"]["emb"].dtype)
    for st in range(stage_count(enc)):
        x = encoder_stage(cfg, stage(enc["slots"][0], st), x, mode=mode,
                          positions=positions, tp=tp)
    return norm(enc["final_norm"], x, cfg.norm_kind)


def encoder_stage(cfg: ModelConfig, slot: dict, x: torch.Tensor, *,
                  mode: str, positions: torch.Tensor,
                  tp=None) -> torch.Tensor:
    """One bidirectional encoder layer (``tp``: its `TPPlan`)."""
    h = norm(slot["norm1"], x, cfg.norm_kind)
    x = x + attention(slot["attn"], cfg, h, mode=mode, causal=False,
                      positions=positions, tp=tp).to(x.dtype)
    h = norm(slot["norm2"], x, cfg.norm_kind)
    return x + mlp(slot["mlp"], cfg, h, mode, tp).to(x.dtype)
