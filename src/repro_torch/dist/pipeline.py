"""Pipeline parallelism over a mesh axis. Counterpart of
``repro/dist/pipeline.py``.

Forward-only GPipe and pipelined **training** under the 1F1B and GPipe
schedules. ``n = |axis|`` stages map onto the ranks of the axis (rank s
holds stage s); microbatches stream through a static tick table, and
activations hop one rank a tick (stage s → s+1) while cotangents hop back
(s+1 → s), each hop a ``ppermute`` (`dist.collectives.ppermute`). The two
training schedules share one implementation and differ only in when rank
``s`` runs the backward of microbatch ``m``:

  1F1B   fwd(m,s) at tick m+s,  bwd(m,s) at tick m + 2n−1−s
  GPipe  fwd(m,s) at tick m+s,  bwd(m,s) at tick m + M+2n−2−s

Under 1F1B a rank stashes at most ``min(M, 2n−1)`` stage inputs (a ring),
against GPipe's M, and the two waves pack into ``M+2n−1`` ticks against
GPipe training's ``2(M+n−1)`` (:func:`bubble_fraction_1f1b`).

Each rank is one device of the reference's ``shard_map`` and knows its
stage index, so where the reference masks with ``jnp.where`` and
``lax.cond`` a rank branches: it skips a stage's compute on a tick where
its microbatch is invalid (the microbatch of the hop it would receive is
then invalid too) but takes part in every hop of every tick, zeros on the
wire included, so sends and receives always pair. The backward recomputes
the stage's forward from the stashed stage *input* under
``torch.enable_grad()`` and differentiates it with ``torch.autograd.grad``
(the reference's "recompute, don't stash residuals"); forward and backward
run in full f32 (`device.full_f32`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.qtensor import times_reciprocal
from repro_torch.device import full_f32
from repro_torch.dist.collectives import (all_gather_rows, all_reduce,
                                          axis_size, permute_quantized,
                                          ppermute, tree_quantized_allreduce)
from repro_torch.optim.optimizers import tree_leaves, tree_map, unflatten_like

WIRES = ("fp32", "int8", "b1")
GRAD_WIRES = ("fp32", "int8")


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    """GPipe idle fraction: (n−1) / (M+n−1), forward-only and for GPipe
    training (2(M+n−1) ticks, 2M useful: the same ratio)."""
    return (num_stages - 1) / (num_micro + num_stages - 1)


def bubble_fraction_1f1b(num_stages: int, num_micro: int) -> float:
    """1F1B idle-tick fraction of the lockstep schedule: (n−1) / (M+2n−1).

    The schedule spans ``M+2n−1`` ticks; rank ``s`` has a valid forward on
    M of them and a valid backward on M, overlapping on ``M−|2n−1−2s|``;
    averaged over stages it sits idle on ``n−1`` of ``M+2n−1``."""
    n, m = num_stages, num_micro
    if n <= 1:
        return 0.0
    return (n - 1) / (m + 2 * n - 1)


def _check_wire(act_wire: str) -> None:
    if act_wire not in WIRES:
        raise ValueError(f"unknown act_wire {act_wire!r}")


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def gpipe_reference(stage_fn: Callable, ws, x: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: run every stage over every microbatch in order."""
    n = tree_leaves(ws)[0].shape[0]
    for i in range(n):
        w = tree_map(lambda leaf: leaf[i], ws)
        x = torch.stack([stage_fn(w, xm) for xm in x])
    return x


def _hop(mesh, axis: str):
    """hop(x, perm, wire): the stage-boundary wire of ``axis``."""
    def hop(x: torch.Tensor, perm, wire: str) -> torch.Tensor:
        if wire == "fp32":
            return ppermute([x], mesh, axis, perm)[0]
        return permute_quantized(x, mesh, axis, perm, wire=wire)
    return hop


def gpipe(stage_fn: Callable, *, mesh, axis: str, num_micro: int,
          act_wire: str = "fp32") -> Callable:
    """Build ``f(ws, x)``: the pipelined equivalent of sequentially applying
    ``n = |axis|`` stages to ``num_micro`` microbatches, on every rank of
    ``axis``.

    stage_fn(w, x_mb) → y_mb (same shape and dtype: activations hop between
    ranks). ws: stage-stacked weights, every leaf (n, ...), the same on
    every rank (each takes its stage's). x: (num_micro, mb, ...), the same
    on every rank. Returns y (num_micro, mb, ...) on every rank.
    ``act_wire`` "int8" or "b1" ships the hops quantized
    (`dist.collectives.permute_quantized`)."""
    _check_wire(act_wire)
    n = axis_size(mesh, axis)
    ticks = num_micro + n - 1
    shift_right = [(i, i + 1) for i in range(n - 1)]
    hop = _hop(mesh, axis)

    @torch.no_grad()
    def run(ws, x):
        idx = mesh.get_local_rank(axis)
        w = tree_map(lambda leaf: leaf[idx], ws)     # this rank's stage
        carry = torch.zeros_like(x[0])               # activation from s−1
        ys = torch.zeros_like(x)
        for t in range(ticks):                       # static schedule
            m = t - idx                              # this rank's microbatch
            if 0 <= m < num_micro:
                out = stage_fn(w, x[m] if idx == 0 else carry)
                if idx == n - 1:
                    ys[m] = out
            else:
                out = torch.zeros_like(carry)
            if t < ticks - 1:
                carry = hop(out, shift_right, act_wire)
        # only the last stage holds results; the sum replicates them
        return all_reduce(ys, mesh.get_group(axis))

    return run


# ---------------------------------------------------------------------------
# Pipelined training (1F1B / GPipe schedules)
# ---------------------------------------------------------------------------

def _schedule_constants(num_stages: int, num_micro: int,
                        schedule: str) -> dict:
    """Static tick table. fwd(m,s) runs at tick m+s under both schedules;
    bwd(m,s) at tick m + base − s. Phases with no valid work on any rank
    are left out via the lo/hi ranges. ``ring`` is the stash depth."""
    n, m = num_stages, num_micro
    if schedule == "1f1b":
        return {"ticks": m + 2 * n - 1, "ring": min(m, 2 * n - 1),
                "base": 2 * n - 1, "bwd_lo": n, "bwd_hi": m + 2 * n - 2,
                "fwd_hi": m + n - 2}
    if schedule == "gpipe":
        return {"ticks": 2 * (m + n - 1), "ring": m,
                "base": m + 2 * n - 2, "bwd_lo": m + n - 1,
                "bwd_hi": 2 * m + 2 * n - 3, "fwd_hi": m + n - 2}
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


def stage_calls(num_stages: int, num_micro: int, schedule: str,
                stage: int) -> list:
    """The microbatch of each ``stage_fn`` call a rank of ``stage`` makes
    in `pipeline_train_local`, in order: on each tick, the backward half's
    recompute, then the forward half's, where the microbatch is valid."""
    sc = _schedule_constants(num_stages, num_micro, schedule)
    calls = []
    for t in range(sc["ticks"]):
        m_b, m_f = t - (sc["base"] - stage), t - stage
        if sc["bwd_lo"] <= t <= sc["bwd_hi"] and 0 <= m_b < num_micro:
            calls.append(m_b)
        if t <= sc["fwd_hi"] and 0 <= m_f < num_micro:
            calls.append(m_f)
    return calls


def _detached(tree):
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def _grads(out: torch.Tensor, inputs: list, ct=None) -> list:
    """Gradients of ``out`` (cotangent ``ct``) by ``inputs``; zeros for an
    input it does not reach, as ``jax.vjp`` gives."""
    return list(torch.autograd.grad(out, inputs, grad_outputs=ct,
                                    allow_unused=True,
                                    materialize_grads=True))


def pipeline_train_local(stage_fn: Callable, loss_fn: Callable, *, mesh,
                         axis: str, num_stages: int, num_micro: int,
                         schedule: str = "1f1b",
                         act_wire: str = "fp32") -> Callable:
    """A rank's pipelined forward and backward.

    Returns ``local(w, top, x_all, aux) → (loss, dw, dtop, dx)`` where
    ``w`` is this rank's stage weights (the reference's ``ws_l[0]``),
    ``top`` a replicated tree the loss reads (LM head, final norm; ``{}``
    if unused), ``x_all`` the (M, mb, ...) microbatched input and ``aux``
    a tree of per-microbatch loss inputs with leading dim M (``{}`` if
    unused). ``loss_fn(top, y_mb, aux_mb) → scalar``.

    Outputs are rank-local: ``dw`` is the grad of this rank's stage,
    ``loss``/``dtop`` are nonzero only on the last stage and ``dx`` (the
    cotangent of ``x_all``) only on stage 0; `reduce_pipeline_outputs`
    sums them over ``axis``. All are for the *mean* loss over
    microbatches.

    The b1 wire carries the forward activations only: cotangents are never
    sign-dominated, so the backward wave falls back to the int8 wire."""
    n, num_m = num_stages, num_micro
    _check_wire(act_wire)
    sc = _schedule_constants(n, num_m, schedule)
    fwd_wire = act_wire
    bwd_wire = "int8" if act_wire == "b1" else act_wire
    hop = _hop(mesh, axis)
    shift_right = [(i, i + 1) for i in range(n - 1)]
    shift_left = [(i + 1, i) for i in range(n - 1)]

    def backward(w, top, x_saved, aux_m, ct_in, last: bool):
        """(loss, dtop, dw, dx) of one microbatch through this stage; the
        loss head (and its dtop) only on the last stage."""
        wl, xl = _detached(w), x_saved.detach().requires_grad_(True)
        with torch.enable_grad():
            y = stage_fn(wl, xl)
            loss_m, dtop_m, ct = None, None, ct_in
            if last:
                tl, yl = _detached(top), y.detach().requires_grad_(True)
                loss_m = loss_fn(tl, yl, aux_m)
                g = _grads(loss_m, tree_leaves(tl) + [yl])
                dtop_m, ct = g[:-1], g[-1]
            g = _grads(y, tree_leaves(wl) + [xl], ct)
        return loss_m, dtop_m, g[:-1], g[-1]

    def local(w, top, x_all, aux):
        idx = mesh.get_local_rank(axis)
        first, last = idx == 0, idx == n - 1
        mb_shape = x_all.shape[1:]
        zeros = torch.zeros(mb_shape, dtype=x_all.dtype, device=x_all.device)
        carry, ct_in = zeros, zeros       # activation from s−1, cotangent
        stash = [None] * sc["ring"]       # from s+1; the stage-input ring
        gw = [_zeros_f32(p) for p in tree_leaves(w)]
        gtop = [_zeros_f32(p) for p in tree_leaves(top)]
        dxs = torch.zeros_like(x_all)
        loss_acc = torch.zeros((), dtype=torch.float32, device=x_all.device)

        with full_f32():
            for t in range(sc["ticks"]):          # static schedule
                # the backward half-tick runs first: when the ring is full
                # the forward half of the same tick reuses the slot read here
                if sc["bwd_lo"] <= t <= sc["bwd_hi"]:
                    m_b = t - (sc["base"] - idx)
                    dx_m = zeros
                    if 0 <= m_b < num_m:
                        aux_m = tree_map(lambda a: a[m_b], aux)
                        loss_m, dtop_m, dw_m, dx_m = backward(
                            w, top, stash[m_b % sc["ring"]], aux_m, ct_in,
                            last)
                        gw = [a + g for a, g in zip(gw, dw_m)]
                        if last:
                            gtop = [a + g for a, g in zip(gtop, dtop_m)]
                            loss_acc = loss_acc + loss_m.detach()
                        if first:
                            dxs[m_b] = dx_m
                    if t < sc["bwd_hi"]:
                        ct_in = hop(dx_m, shift_left, bwd_wire)
                if t <= sc["fwd_hi"]:
                    m_f = t - idx
                    out = zeros
                    if 0 <= m_f < num_m:
                        x_in = x_all[m_f] if first else carry
                        with torch.no_grad():
                            out = stage_fn(w, x_in)
                        stash[m_f % sc["ring"]] = x_in
                    if t < sc["fwd_hi"]:
                        carry = hop(out, shift_right, fwd_wire)

        inv = 1.0 / num_m                         # grads of the MEAN loss
        gw = tree_map(lambda g, p: (g * inv).to(p.dtype),
                      unflatten_like(w, gw), w)
        gtop = tree_map(lambda g, p: (g * inv).to(p.dtype),
                        unflatten_like(top, gtop), top)
        return loss_acc * inv, gw, gtop, dxs * inv

    return local


def reduce_pipeline_outputs(loss, gw, gtop, dxs, *, mesh, axis: str,
                            dp_axis: Optional[str] = None,
                            grad_wire: str = "fp32"):
    """Post-processing of :func:`pipeline_train_local`'s outputs: sum the
    stage-local pieces over the pipeline ``axis`` (the last stage holds
    loss and dtop, stage 0 dx), then reduce grads and loss across
    ``dp_axis``, over the int8 wire (`dist.collectives`) when
    ``grad_wire == 'int8'``, else an exact mean. ``dxs`` stays the data
    rank's, rescaled to be the cotangent of the data-mean loss."""
    group = mesh.get_group(axis)
    loss = all_reduce(loss, group)
    gtop = tree_map(lambda g: all_reduce(g, group), gtop)
    dxs = all_reduce(dxs, group)
    if dp_axis is not None:
        dp_group, dp_n = mesh.get_group(dp_axis), axis_size(mesh, dp_axis)

        def pmean(g):
            return times_reciprocal(all_reduce(g, dp_group), dp_n)
        if grad_wire == "int8":
            gw = tree_quantized_allreduce(gw, mesh, dp_axis)
            gtop = tree_quantized_allreduce(gtop, mesh, dp_axis)
        else:
            gw, gtop = tree_map(pmean, gw), tree_map(pmean, gtop)
        loss = pmean(loss)
        dxs = times_reciprocal(dxs, dp_n)
    return loss, gw, gtop, dxs


def _shard(x: torch.Tensor, mesh, dp_axis: Optional[str]) -> torch.Tensor:
    """This data rank's block of dim 1 (the microbatch rows)."""
    if dp_axis is None:
        return x
    k, d = axis_size(mesh, dp_axis), mesh.get_local_rank(dp_axis)
    rows = x.shape[1] // k
    return x[:, d * rows:(d + 1) * rows]


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable, *, mesh,
                        axis: str, num_micro: int, schedule: str = "1f1b",
                        dp_axis: Optional[str] = None,
                        grad_wire: str = "fp32",
                        act_wire: str = "fp32") -> Callable:
    """Build ``f(ws, x, aux=None, top=None)``: pipelined training over
    ``n = |axis|`` stages, numerically matching the sequential
    :func:`pipeline_train_reference`, on every rank of the mesh.

    ws: stage-stacked weights, every leaf (n, ...); x: (num_micro, mb,
    ...); aux: per-microbatch loss inputs, leading dim num_micro; all the
    same on every rank, as the reference's global arrays. With ``dp_axis``
    the mb dim shards over the data ranks and grads and loss reduce across
    them, over the int8 wire when ``grad_wire == 'int8'``, else an exact
    mean. ``act_wire == 'int8'`` carries the stage hops (activations and
    cotangents) as int8 codes + f32 scale; ``'b1'`` carries the forward
    activations as packed signs + α and the cotangents as int8.

    Returns ``(loss, grads)``, with ``top`` given ``(loss, grads,
    grads_top, dx)``, every one the global value on every rank (grads
    gathered over the stages, dx over the data ranks), as the reference's
    ``out_specs`` assemble them."""
    if grad_wire not in GRAD_WIRES:
        raise ValueError(f"unknown grad_wire {grad_wire!r}")
    _check_wire(act_wire)
    n = axis_size(mesh, axis)
    local = pipeline_train_local(stage_fn, loss_fn, mesh=mesh, axis=axis,
                                 num_stages=n, num_micro=num_micro,
                                 schedule=schedule, act_wire=act_wire)
    stage_group = mesh.get_group(axis)

    def run(ws, x, aux=None, top=None):
        top_in = {} if top is None else top
        aux_in = {} if aux is None else aux
        idx = mesh.get_local_rank(axis)
        w = tree_map(lambda leaf: leaf[idx], ws)
        out = local(w, top_in, _shard(x, mesh, dp_axis),
                    tree_map(lambda a: _shard(a, mesh, dp_axis), aux_in))
        loss, gw, gtop, dxs = reduce_pipeline_outputs(
            *out, mesh=mesh, axis=axis, dp_axis=dp_axis, grad_wire=grad_wire)
        gws = tree_map(lambda g: all_gather_rows(g[None], stage_group), gw)
        if top is None:
            return loss, gws
        if dp_axis is not None:
            dxs = all_gather_rows(dxs.transpose(0, 1),
                                  mesh.get_group(dp_axis)).transpose(0, 1)
        return loss, gws, gtop, dxs

    return run


def pipeline_train_reference(stage_fn: Callable, loss_fn: Callable, ws, x,
                             aux=None, top=None):
    """Sequential autograd oracle for :func:`pipeline_train_step`: every
    stage on every microbatch in order, the losses' mean differentiated.
    Returns ``(loss, grads)``, plus ``(grads_top, dx)`` when ``top`` is
    given."""
    top_in = {} if top is None else top
    aux_in = {} if aux is None else aux
    n = tree_leaves(ws)[0].shape[0]
    wl, tl = _detached(ws), _detached(top_in)
    xl = x.detach().requires_grad_(True)
    with torch.enable_grad(), full_f32():
        losses = []
        for m in range(x.shape[0]):
            h = xl[m]
            for i in range(n):
                h = stage_fn(tree_map(lambda leaf: leaf[i], wl), h)
            losses.append(loss_fn(tl, h, tree_map(lambda a: a[m], aux_in)))
        loss = torch.mean(torch.stack(losses))
        g = _grads(loss, tree_leaves(wl) + tree_leaves(tl) + [xl])
    nw = len(tree_leaves(wl))
    gws = unflatten_like(ws, g[:nw])
    if top is None:
        return loss.detach(), gws
    return loss.detach(), gws, unflatten_like(top_in, g[nw:-1]), g[-1]
