"""The LM train step: QAT loss, microbatch gradient accumulation, clip,
update. Counterpart of ``repro/train/step.py`` (`lm_loss`,
`make_train_step`, and the pipelined `make_pipeline_train_step` over
``dist.pipeline``).

Gradients come from ``torch.autograd.grad`` on detached copies of the
param leaves, so a step changes no tensor it was handed. Autograd runs the
backward at that call, after the forward's `device.full_f32` blocks have
closed, and would run its matmuls in the global TF32 setting: the forward
and the backward both run inside `full_f32`. With ``microbatches`` > 1
the batch splits along dim 0 into equal slices; each slice's loss and
grads are summed in f32 and the sums divided by the count, as the
reference's ``lax.scan`` does. No graph is held across slices.

With a `ShardCtx` (``make_train_step(ctx=)``, `sharded_train_step`) a rank
holds its block of every param and optimizer leaf between steps
(`dist.sharding.shard_tree`) and takes its rows of the global batch over
``ctx.dp_axes``. The step runs on those blocks as they are, no leaf
gathered: the dense layers tensor-parallel over ``ctx.tp_axis``
(`models.layers`: column- and row-parallel projections, attention on the
rank's heads, the embedding, head and loss on its vocabulary block), the
MoE layers expert- and tensor-parallel (`models.moe`). Each rank
differentiates its shard's loss over the number of data shards, and each
gradient comes out as the rank's block of its leaf. A leaf's gradient is
then summed over the data ranks unless the leaf is split over them (the
experts under EP are whole on their rank); an act step's over the model
ranks too where its projection runs row-parallel (each model rank
quantizes its slice of the input), the MoE act step's where the expert
hidden dim is split. LSQ scales a step's gradient by 1/sqrt(rows · 255),
and a rank quantizes its own rows: the act steps' gradients are scaled to
the one-device step's rows (a linear's B·S; an MoE buffer's E·cap at the
whole batch's capacity). The clip's global norm sums each leaf's squares
once over the mesh. The optimizer must update element by element (AdamW,
SGD-M): Adafactor's factored moments reduce across a leaf's rows and
columns.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.quant import lsq_grad_scale
from repro_torch.device import full_f32
from repro_torch.dist import sharding
from repro_torch.dist.collectives import all_reduce, axis_size, psum
from repro_torch.dist.pipeline import (pipeline_train_local,
                                       reduce_pipeline_outputs)
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import embed, norm, unembed
from repro_torch.models.moe import plan_dispatch
from repro_torch.models.transformer import (_apply_slot, check_ctx,
                                            init_lm_params, lm_forward,
                                            moe_axes, tp_of, tree_items)
from repro_torch.optim import (apply_updates, clip_by_global_norm,
                               tree_leaves, tree_map)
from repro_torch.optim.optimizers import (full_like0, sum_of_squares,
                                          unflatten_like)

Z_LOSS = 1e-4
EMBEDS = ("encoder_embeds", "prefix_embeds")


def token_loss(logits: torch.Tensor, labels: torch.Tensor,
               tp=None) -> torch.Tensor:
    """Mean next-token NLL, log-softmax in f32, plus the z-loss
    1e-4·mean(logsumexp²). ``tp``: a `dist.sharding.TPPlan` whose
    vocabulary split makes ``logits`` the rank's block (`vocab_loss`)."""
    if tp is not None and tp.vocab() is not None:
        return vocab_loss(logits, labels, tp)
    logits = logits.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    zloss = Z_LOSS * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return torch.mean(nll) + zloss


def vocab_loss(logits: torch.Tensor, labels: torch.Tensor,
               tp) -> torch.Tensor:
    """`token_loss` of vocabulary-parallel logits, the rank's block [v0,
    v1): the global max and the sum of exponentials all-reduced over the
    group, the target's logit taken on the rank that holds it and summed.
    The whole (B, S, V) logits never exist on a rank."""
    v0, v1 = tp.vocab()
    logits = logits.to(torch.float32)
    m = all_reduce(torch.amax(logits.detach(), dim=-1), tp.group,
                   dist.ReduceOp.MAX)
    sumexp = psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                  tp.group)
    lse = m + torch.log(sumexp)
    t = labels.long() - v0
    held = (t >= 0) & (t < v1 - v0)
    picked = torch.gather(logits, -1, torch.clamp(
        t, 0, v1 - v0 - 1)[..., None])[..., 0]
    target = psum(torch.where(held, picked, 0.0), tp.group)
    zloss = Z_LOSS * torch.mean(lse ** 2)
    return torch.mean(lse - target) + zloss


def lm_loss(cfg, params: dict, batch: dict, *, mode: str, ctx=None,
            remat: bool = True) -> torch.Tensor:
    """`token_loss` over the batch's tokens (the modality prefix's logits
    dropped). ``batch``: tokens and labels (B, S) int, and
    ``encoder_embeds`` / ``prefix_embeds`` where the arch takes them.
    ``ctx``: a `ShardCtx` for `lm_forward` (the batch is then this rank's
    rows)."""
    kw = {k: batch[k] for k in EMBEDS if k in batch}
    logits = lm_forward(cfg, params, batch["tokens"], mode=mode, ctx=ctx,
                        remat=remat, **kw)
    seq = batch["tokens"].shape[1]
    return token_loss(logits[:, -seq:, :], batch["labels"],
                      tp_of(ctx, cfg))


def loss_and_grads(loss_fn: Callable, params, batch) -> tuple:
    """→ (loss, grads as a list in `tree_leaves` order) of
    ``loss_fn(params, batch)``, forward and backward in full f32. A leaf
    the loss does not reach gets zeros, as ``jax.value_and_grad`` gives
    it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree_leaves(leaves)
    with torch.enable_grad(), full_f32():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def accumulated_grads(loss_fn: Callable, params, batch: dict,
                      microbatches: int) -> tuple:
    """(loss, grads in `tree_leaves` order) of ``batch`` split along dim 0
    into ``microbatches`` equal slices: the slices' losses and grads summed
    in f32, then divided by the count."""
    if microbatches == 1:
        return loss_and_grads(loss_fn, params, batch)
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"a batch of {b} does not split into "
                         f"{microbatches} microbatches")
    m = b // microbatches
    loss_sum, gsum = None, None
    for i in range(microbatches):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss, grads = loss_and_grads(loss_fn, params, mb)
        if gsum is None:
            loss_sum = loss.to(torch.float32)
            gsum = [g.to(torch.float32) for g in grads]
            continue
        loss_sum = loss_sum + loss
        for j, g in enumerate(grads):
            # out of place: autograd may hand two leaves one tensor
            gsum[j] = gsum[j] + g
            grads[j] = None
    return (loss_sum / full_like0(loss_sum, microbatches),
            [g / full_like0(g, microbatches) for g in gsum])


def make_train_step(cfg, optimizer, *, mode: str = "w1a8_train",
                    microbatches: int = 1, max_grad_norm: float = 1.0,
                    ctx=None, remat: bool = True,
                    loss_fn: Optional[Callable] = None):
    """→ train_step(params, opt_state, batch) → (params, opt_state,
    metrics), metrics ``{"loss", "grad_norm", "step"}`` as tensors on the
    params' device (a step makes no host sync).

    batch: dict of tensors whose dim 0 is the step's global batch, split
    into ``microbatches`` equal slices accumulated in f32. ``loss_fn(params,
    batch)`` replaces `lm_loss` (mode and remat then unused). ``ctx``: a
    `ShardCtx`; the step is then `sharded_train_step`'s."""
    check_ctx(ctx)
    if ctx is not None:
        if loss_fn is not None:
            raise ValueError("a sharded step takes no loss_fn")
        return sharded_train_step(cfg, optimizer, ctx, mode=mode,
                                  microbatches=microbatches,
                                  max_grad_norm=max_grad_norm, remat=remat)
    _, update = optimizer
    loss_fn = loss_fn or functools.partial(lm_loss, cfg, mode=mode,
                                           remat=remat)

    def train_step(params, opt_state, batch):
        loss, grads = accumulated_grads(loss_fn, params, batch, microbatches)
        grads, gnorm = clip_by_global_norm(unflatten_like(params, grads),
                                           max_grad_norm)
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return train_step


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over the ranks of each mesh axis in ``axes``."""
    for axis in axes:
        if axis_sizes(mesh)[axis] > 1:
            x = all_reduce(x, mesh.get_group(axis))
    return x


def _dp_index(mesh, dp_axes: tuple) -> int:
    """This rank's data shard: its coordinates on ``dp_axes``, row-major."""
    idx = 0
    for axis in dp_axes:
        idx = idx * axis_sizes(mesh)[axis] + mesh.get_local_rank(axis)
    return idx


def sharded_train_step(cfg, optimizer, ctx, *, mode: str = "w1a8_train",
                       microbatches: int = 1, max_grad_norm: float = 1.0,
                       remat: bool = True):
    """train_step(params, opt_state, batch) → (params, opt_state, metrics)
    of one rank of ``ctx.mesh`` (the module's docstring says what a rank
    holds and how the gradients reduce). ``params`` and ``opt_state`` are
    the rank's `dist.sharding.shard_tree` of the whole trees; ``batch`` is
    the global batch, of which the rank takes its rows. metrics: the whole
    batch's loss and the global grad norm, equal on every rank. Every rank
    of the mesh calls it."""
    _, update = optimizer
    mesh, dp_axes = ctx.mesh, tuple(ctx.dp_axes)
    sizes = axis_sizes(mesh)
    dp_n = math.prod(sizes[a] for a in dp_axes)
    shard = _dp_index(mesh, dp_axes)
    specs = sharding.tree_specs(init_lm_params(cfg, None, device="meta"),
                                cfg, mesh)
    moe_tp = bool(cfg.num_experts) and moe_axes(cfg, {}, ctx)[1] is not None
    loss_fn = functools.partial(lm_loss, cfg, mode=mode, ctx=ctx,
                                remat=remat)

    def shard_loss(params, batch):
        loss = loss_fn(params, batch)
        return loss / full_like0(loss, dp_n)

    def row_parallel(path: str) -> bool:
        """Whether the act step at ``path`` feeds a row-parallel
        projection (its weight split over the model axis)."""
        w = path[:path.rindex("[")] + "['w']"
        return sharding.path_keys(path)[-2] in sharding.ROW_PARALLEL and \
            ctx.tp_axis in specs.get(w, ())

    def reduce_axes(path: str, keys: list, spec: tuple) -> list:
        held = {a for a in spec if a is not None}
        axes = [] if held & set(dp_axes) else list(dp_axes)
        if keys[-1] == "act_step" and (
                ("moe" in keys and moe_tp) or
                ("moe" not in keys and row_parallel(path))):
            axes.append(ctx.tp_axis)
        return axes

    def act_step_scale(keys: list, tokens: int) -> float:
        """The one-device step's LSQ grad scale over this rank's."""
        if "moe" in keys:
            e = cfg.num_experts
            local = e * plan_dispatch(cfg, tokens).capacity
            whole = e * plan_dispatch(cfg, tokens * dp_n).capacity
        else:
            local, whole = tokens, tokens * dp_n
        return lsq_grad_scale(whole) / lsq_grad_scale(local)

    def train_step(params, opt_state, batch):
        bsz = batch["tokens"].shape[0]
        if bsz % dp_n or (bsz // dp_n) % microbatches:
            raise ValueError(f"global batch {bsz} must split into {dp_n} "
                             f"data shards × {microbatches} microbatches")
        rows = bsz // dp_n
        local = {k: v[shard * rows:(shard + 1) * rows]
                 for k, v in batch.items()}
        loss, grads = accumulated_grads(shard_loss, params, local,
                                        microbatches)
        seq = local["tokens"].shape[1] + (
            local["prefix_embeds"].shape[1] if "prefix_embeds" in local
            else 0)
        tokens = rows // microbatches * seq
        out, total = [], None
        for i, (path, _) in enumerate(tree_items(params)):
            g, grads[i] = grads[i], None      # the rank's block
            keys, spec = sharding.path_keys(path), specs[path]
            if keys[-1] == "act_step":
                g = g * act_step_scale(keys, tokens)
            g = _sum_over(g, mesh, reduce_axes(path, keys, spec))
            out.append(g)
            held = {a for a in spec if a is not None}
            copies = math.prod(n for a, n in sizes.items() if a not in held)
            sq = torch.sum(torch.square(g.to(torch.float32)))
            sq = sq / full_like0(sq, copies)
            total = sq if total is None else total + sq
        loss = _sum_over(loss, mesh, dp_axes)
        total = _sum_over(total, mesh, list(sizes))
        grads, gnorm = clip_by_global_norm(unflatten_like(params, out),
                                           max_grad_norm, total)
        del out                       # only the clipped gradients stay
        updates, opt_state = update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return train_step


def make_pipeline_train_step(cfg, optimizer, *, mesh, num_micro: int,
                             mode: str = "w1a8_train",
                             schedule: str = "1f1b",
                             grad_wire: str = "fp32",
                             max_grad_norm: float = 1.0,
                             stage_axis: str = "stage",
                             dp_axis: str = "data"):
    """The pipelined train_step(params, opt_state, batch) → (params,
    opt_state, metrics) of one rank of ``mesh`` ((data, stage)).

    The body's ``num_layers`` slots partition into ``n = |stage_axis|``
    contiguous stages; microbatches stream through the 1F1B (or GPipe)
    schedule of ``dist.pipeline``. The embedding runs before the pipeline
    and its VJP after it, on the input cotangent the pipeline returns; the
    final norm, ``unembed`` and the z-loss are the loss head. Grads reduce
    across ``dp_axis``, over the int8 wire when ``grad_wire == 'int8'``.

    A rank holds its stage's rows of the layer-stacked leaves of params
    and optimizer state (`dist.sharding.stage_slice`), every other leaf
    whole; ``batch`` is the global batch, of which the rank takes its
    data shard's rows. The clip's global norm sums the squares of the
    stage-sliced leaves over ``stage_axis`` and adds the replicated
    leaves' once, so every rank clips by the one norm and the replicated
    leaves stay equal across ranks. ``optimizer`` must update leaf by leaf
    and element by element (AdamW, SGD-M): Adafactor's factored moments
    and update clip reduce across the layers of a leaf."""
    n = axis_size(mesh, stage_axis)
    dp_n = axis_size(mesh, dp_axis)
    if cfg.period != 1:
        raise ValueError("--pipeline needs a uniform layer stack (period 1);"
                         f" {cfg.name} has period {cfg.period}")
    if cfg.encoder_layers or cfg.frontend == "vision":
        raise ValueError(f"--pipeline does not support {cfg.name}'s "
                         "encoder/vision front-end")
    if cfg.ffn_kind(0) == "moe":
        raise ValueError("--pipeline does not support MoE FFNs yet")
    if cfg.num_layers % n:
        raise ValueError(f"{cfg.num_layers} layers do not partition into "
                         f"{n} pipeline stages")
    lps = cfg.num_layers // n
    mk, fk = cfg.mixer_kind(0), cfg.ffn_kind(0)
    _, update = optimizer
    stage_group, dp_group = mesh.get_group(stage_axis), \
        mesh.get_group(dp_axis)
    shard = mesh.get_local_rank(dp_axis)

    def stage_fn(w, x):
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for i in range(lps):
            slot = tree_map(lambda leaf: leaf[i], w)
            x = _apply_slot(slot, cfg, x, mixer_kind=mk, ffn_kind=fk,
                            mode=mode, positions=positions)
        return x

    def loss_fn(top, y, aux):
        h = norm(top["final_norm"], y, cfg.norm_kind)
        return token_loss(unembed(top["embed"], cfg, h), aux["labels"])

    local = pipeline_train_local(stage_fn, loss_fn, mesh=mesh,
                                 axis=stage_axis, num_stages=n,
                                 num_micro=num_micro, schedule=schedule)

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        bsz = tokens.shape[0]
        if bsz % dp_n or (bsz // dp_n) % num_micro:
            raise ValueError(f"global batch {bsz} must split into {dp_n} DP"
                             f" shards × {num_micro} microbatches")
        rows = bsz // dp_n
        tokens = tokens[shard * rows:(shard + 1) * rows]
        labels = labels[shard * rows:(shard + 1) * rows]
        emb = params["embed"]["emb"].detach().requires_grad_(True)
        with torch.enable_grad():
            x = embed({"emb": emb}, tokens)
        split = (num_micro, rows // num_micro)
        top = {"embed": params["embed"], "final_norm": params["final_norm"]}
        out = local(params["slots"][0], top,
                    x.detach().reshape(split + x.shape[1:]),
                    {"labels": labels.reshape(split + labels.shape[1:])})
        loss, gw, gtop, dxs = reduce_pipeline_outputs(
            *out, mesh=mesh, axis=stage_axis, dp_axis=dp_axis,
            grad_wire=grad_wire)
        # the embedding's VJP on this data shard's rows, summed over the
        # shards as the reference's global cotangent sums them
        (g_front,) = torch.autograd.grad(x, emb, dxs.reshape(x.shape))
        g_front = all_reduce(g_front, dp_group)
        g_embed = dict(gtop["embed"])
        g_embed["emb"] = g_embed["emb"] + g_front
        grads = {"embed": g_embed, "final_norm": gtop["final_norm"],
                 "slots": (gw,)}
        total = sum_of_squares({"embed": g_embed,
                                "final_norm": gtop["final_norm"]}) + \
            all_reduce(sum_of_squares(gw), stage_group)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, total)
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return train_step
