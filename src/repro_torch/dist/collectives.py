"""Quantized collectives: int8-on-the-wire gradient all-reduce, and the
pipeline's quantized point-to-point hop. Counterpart of
``repro/dist/collectives.py``.

A mean all-reduce over the ``n`` ranks of a mesh axis decomposes into

    quantize → all_to_all(int8 codes) → local sum (int32) →
    requantize → all_gather(int8 codes) → dequantize

a reduce-scatter and an all-gather in which every payload between ranks is
one byte an element: about 4× less traffic than an f32 ring all-reduce.
Both legs share one scale across the ranks (an all-reduce MAX of the local
abs-max, one float), so codes from different ranks sum exactly in int32.
Symmetric int8 with round-half-away carries about 0.23%·max of noise a
leg; on unit-normal gradients the two legs compose to about 1% relative
error on the mean (the tests hold 3%).

Tensor parallelism (Megatron's f and g, and the gathers between them):
``psum`` sums a split computation's partial outputs (identity backward),
``sum_grad`` marks where one starts (its backward sums the partial
cotangents), ``gather_cols`` all-gathers the ranks' column blocks into the
whole last dim (backward: the rank's block of a cotangent every rank
holds whole) and ``take_block`` is its inverse (forward: the rank's
block of a tensor every rank holds whole; backward: the all-gather).

Where the reference runs inside ``shard_map`` over a named axis, these
functions take a `DeviceMesh` and the axis name and run over
``mesh.get_group(axis)``: ``pmax`` is ``all_reduce(MAX)``, ``psum``
``all_reduce(SUM)``, ``all_to_all`` ``all_to_all_single`` of the int8
codes, ``all_gather(tiled)`` an all-gather into one tensor and
``ppermute`` paired `P2POp`s through ``batch_isend_irecv``. Every rank of
the axis calls each collective, with tensors of the same shapes. NCCL on
the card, gloo on the CPU; nothing here picks the backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.qtensor import (S8_QMAX, SCALE_FLOOR, QTensor,
                                      s8_codes, times_reciprocal)
from repro_torch.optim.optimizers import tree_leaves, tree_map

# torch renamed the all-gather into one tensor; either name does the same
_all_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def axis_size(mesh, axis: str) -> int:
    return dist.get_world_size(mesh.get_group(axis))


def alone(group) -> bool:
    """Whether ``group`` holds this rank only: its collectives are then
    the identity and are not called."""
    return dist.get_world_size(group) == 1


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``x`` over ``group``, out of place."""
    out = x.detach().clone().reshape(-1)
    if not alone(group):
        dist.all_reduce(out, op=op, group=group)
    return out.reshape(x.shape)


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=False)``:
    dim 0 (the group's size) splits into one chunk a rank; chunk j goes to
    rank j, which puts what it receives from rank i at i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`all_to_all_rows`, whose backward is itself (a permutation)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_rows(g, ctx.group), None


class _SumForward(torch.autograd.Function):
    """All-reduce SUM forward, identity backward: a ``psum`` whose output
    every rank of the group uses whole."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, all-reduce SUM backward: where a computation
    split over the group starts, each rank's cotangent is a part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def group_rank(group) -> int:
    """This process's rank within ``group``."""
    return dist.get_group_rank(group, dist.get_rank())


def _last_block(x: torch.Tensor, group) -> torch.Tensor:
    """The rank's block of the last dim split evenly over ``group``."""
    n = x.shape[-1] // dist.get_world_size(group)
    r = group_rank(group)
    return x[..., r * n:(r + 1) * n]


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last dim in rank order."""
    if alone(group):
        return x
    out = all_gather_rows(x.movedim(-1, 0), group)
    return out.movedim(0, -1).contiguous()


class _GatherCols(torch.autograd.Function):
    """All-gather along the last dim forward; the rank's block of the
    cotangent backward (the whole output is used alike on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _last_block(g, ctx.group).contiguous(), None


class _TakeBlock(torch.autograd.Function):
    """The rank's block of the last dim forward (the input is whole and
    alike on every rank); the blocks' cotangents all-gathered backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _last_block(x, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable `all_to_all_rows`."""
    return _AllToAll.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; its gradient passes through unchanged
    (Megatron's *g*: the output is replicated over the group)."""
    return x if alone(group) else _SumForward.apply(x, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group`` (Megatron's
    *f*: the ranks' partial cotangents of a split computation)."""
    return x if alone(group) else _SumBackward.apply(x, group)


def gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' column blocks of a tensor gathered into the whole last
    dim; the gradient is the rank's block of the whole one."""
    return _GatherCols.apply(x, group)


def take_block(x: torch.Tensor, group) -> torch.Tensor:
    """The rank's block of the last dim of ``x``, which every rank of
    ``group`` holds whole; the gradient is the blocks' gathered."""
    return _TakeBlock.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order (a tiled
    all-gather)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather_flat(out, x, group=group)
    return out


def _shared_scale(x: torch.Tensor, group) -> torch.Tensor:
    """One scale for every rank: the all-reduced MAX of the local abs-max,
    clamped to 1e-20, over 127."""
    amax = all_reduce(torch.amax(torch.abs(x)), group, dist.ReduceOp.MAX)
    return times_reciprocal(torch.clamp(amax, min=SCALE_FLOOR), S8_QMAX)


@torch.no_grad()
def quantized_allreduce_mean(g: torch.Tensor, mesh, axis: str
                             ) -> torch.Tensor:
    """Mean of ``g`` across the ranks of ``axis`` with int8 payloads.

    Non-float leaves (step counters riding in the tree) fall back to an
    exact dtype-preserving mean, sum then floor division: identical
    replicated values come back unchanged."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if not g.is_floating_point():
        return torch.div(all_reduce(g, group), n, rounding_mode="floor")
    shape, dtype = g.shape, g.dtype
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1)                       # row j → rank j

    # reduce-scatter leg: int8 codes, exchanged with all_to_all
    scale1 = _shared_scale(chunks, group)
    codes = torch.empty_like(chunks, dtype=torch.int8)
    dist.all_to_all_single(codes, s8_codes(chunks, scale1), group=group)
    # local accumulation is exact: |sum| ≤ n·127 ≪ int32
    part = torch.sum(codes.to(torch.int32), dim=0, dtype=torch.int32)
    part = times_reciprocal(part.to(torch.float32) * scale1, n)

    # all-gather leg: requantized int8 codes of the mean chunk
    scale2 = _shared_scale(part, group)
    gathered = all_gather_rows(s8_codes(part, scale2), group)
    out = gathered.to(torch.float32) * scale2
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(dtype)


def tree_quantized_allreduce(tree, mesh, axis: str):
    """Per-leaf-scaled int8 mean all-reduce over a gradient tree."""
    return tree_map(lambda g: quantized_allreduce_mean(g, mesh, axis), tree)


def wire_bytes_saved(tree, n: int) -> dict:
    """Accounting helper: int8 ring traffic vs f32 ring all-reduce."""
    numel = sum(int(x.numel()) for x in tree_leaves(tree))
    f = (n - 1) / max(n, 1)
    f32 = 2 * 4 * numel * f
    int8 = 2 * 1 * numel * f
    return {"f32_bytes": f32, "int8_bytes": int8,
            "ratio": f32 / max(int8, 1)}


# ---------------------------------------------------------------------------
# Point-to-point: the pipeline stage hop (``ppermute``), f32 or quantized
# ---------------------------------------------------------------------------

def ppermute(tensors: list, mesh, axis: str, perm) -> list:
    """``ppermute`` of a list of tensors over ``axis``: a rank ``i`` sends
    its tensors to ``j`` for each ``(i, j)`` in ``perm`` and receives those
    of the ``(k, i)`` pair; a rank that no pair sends to gets zeros. Every
    rank calls it with tensors of the same shapes."""
    group = mesh.get_group(axis)
    me = dist.get_group_rank(group, dist.get_rank())
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    # contiguous buffers: a receive lands in the view ``reshape`` gives
    out = [torch.zeros(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    ops = []
    for j in dst:
        peer = dist.get_global_rank(group, j)
        ops += [dist.P2POp(dist.isend, t.contiguous().reshape(-1), peer,
                           group) for t in tensors]
    for i in src:
        peer = dist.get_global_rank(group, i)
        ops += [dist.P2POp(dist.irecv, t.reshape(-1), peer, group)
                for t in out]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def quantize_wire(x: torch.Tensor, qtype: str = "s8") -> QTensor:
    """f32 → QTensor wire payload with a *local* per-tensor scale.

    Each stage-to-stage hop carries one tensor from one sender, so no
    shared scale is needed: the 4-byte scale rides the wire beside its
    codes. ``qtype="s8"``: symmetric int8, one byte an element
    (`QTensor.quantize_s8`). ``qtype="b1"``: packed sign bits along the
    trailing axis + α = mean|x|, one bit an element (`QTensor.quantize_b1`),
    the wire for sign-dominated boundaries."""
    if qtype == "s8":
        return QTensor.quantize_s8(x)
    if qtype == "b1":
        return QTensor.quantize_b1(x)
    raise ValueError(f"unknown wire qtype {qtype!r}")


def dequantize_wire(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    return qt.dequantize().to(dtype)


_WIRE_QTYPES = {"int8": "s8", "b1": "b1"}


@torch.no_grad()
def permute_quantized(x: torch.Tensor, mesh, axis: str, perm,
                      wire: str = "int8") -> torch.Tensor:
    """``ppermute`` with quantized codes + f32 scale on the wire, not f32.

    quantize → send codes and scale together → dequantize on the receiver.
    A rank outside ``perm`` receives zeros for both, so it dequantizes to
    exactly 0, as a plain f32 ppermute gives (for ``wire="b1"`` the zero
    words unpack to −1 signs, but the zero scale still yields 0).

    Error envelopes: ``wire="int8"`` |x̂ − x| ≤ scale/2 = max|x|/254 an
    element; ``wire="b1"`` x̂ = sign(x)·mean|x|, tight only on
    sign-dominated tensors (|x| ≈ const)."""
    qt = quantize_wire(x, _WIRE_QTYPES[wire])
    data, scale = ppermute([qt.data, qt.scale.reshape(1)], mesh, axis, perm)
    got = QTensor(data, scale.reshape(qt.scale.shape), qt.qtype,
                  axis=qt.axis, kdim=qt.kdim)
    return dequantize_wire(got, x.dtype)


def permute_wire_bytes(x: torch.Tensor, n_hops: int) -> dict:
    """Accounting: per-schedule-tick permute payload, f32 vs int8 vs b1.

    int8: one byte an element + one 4-byte scale a hop. b1: the trailing
    axis packs 32 signs a word (padded to a word boundary) + one 4-byte α
    a hop; the code payload is 8× smaller than int8's."""
    numel = int(x.numel())
    last = int(x.shape[-1]) if x.dim() else 1
    words = (numel // max(last, 1)) * ((last + 31) // 32)
    f32 = 4 * numel * n_hops
    int8 = (1 * numel + 4) * n_hops
    b1 = (4 * words + 4) * n_hops
    return {"f32_bytes": f32, "int8_bytes": int8, "b1_bytes": b1,
            "ratio": f32 / max(int8, 1),
            "ratio_f32_b1": f32 / max(b1, 1),
            "ratio_int8_b1": int8 / max(b1, 1),
            "ratio_int8_b1_codes": numel / max(4 * words, 1)}
