"""Top-k dropping MoE with expert-parallel all-to-all dispatch
(counterpart of ``repro/models/moe.py``).

Tokens are sorted by destination expert and packed into a static (E, cap,
D) buffer, the experts run as grouped GEMMs, and the outputs are combined
with the router gates. Capacity cap = ceil(T·k / E · cf) bounds the
buffer; an assignment past its expert's cap is dropped (gate 0), standard
dropping semantics. The capacity is per source shard, from its own tokens.

Sharded (``ep_group`` / ``tp_group``, process groups a `ShardCtx`'s mesh
resolves; `models.transformer._apply_moe`): the experts split over the
``ep`` ranks, (ep, E_local, cap, D) buffer → all-to-all → (E_local,
ep·cap, D), the expert hidden dim F over ``tp`` with the down projection
all-reduced, and the way back. ``a2a_quant`` ships the dispatch as uint8
codes against the layer's act step (`_A2AU8`) and the return leg in bf16.
Without groups the same code runs every expert locally (ep = 1), with no
collective.

Gradients follow the one-device step: the TP sum's backward is the
identity (every model rank uses its output whole), and the F-split expert
compute starts with `dist.collectives.sum_grad` on the received buffer,
so the tokens' cotangent is whole on every model rank while the router,
which reads the same tokens, sees no model sum.

Where the reference scatters and gathers at ranks past ``cap`` (JAX drops
or clamps such indices silently), the port clamps the index and masks the
value with ``keep``: the kept rows are never selected by a boolean mask,
so nothing syncs the host or takes a shape from the data. The top-k takes
the lower expert first among equal logits, as ``jax.lax.top_k`` does.

W1A8: expert weights are (E, K, N) stacks; in QAT mode they binarize with
sign-STE like the dense layers (per-expert α; under TP the down
projection's α = mean_F|w| is all-reduced to the mean over the whole F).
Deployed experts (`serve.packed.deploy_lm`) hold (E, ⌈K/32⌉, N) sign words
and run one grouped launch of the popcount matmul per projection
(`w1a8_matmul_grouped`): an expert reads its weights only for the rows it
holds. After the all-to-all an expert's rows are ``ep`` runs of up to
``cap``; its count is the end of its last non-empty run (the rows between
runs are zero and give exact zeros), so at ep = 1 the counts are the
local path's.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.quant import (binarize_ste, binarize_weight,
                                    lsq_fake_quant, lsq_grad_scale)
from repro_torch.device import full_f32
from repro_torch.dist.collectives import (all_reduce, all_to_all,
                                          all_to_all_rows, psum, sum_grad)
from repro_torch.kernels.w1a8_matmul.ops import w1a8_matmul_grouped
from repro_torch.models import layers
from repro_torch.models.layers import Leaf, ModelConfig, _act
from repro_torch.optim.optimizers import full_like0


def init_moe(cfg: ModelConfig) -> dict:
    """One MoE FFN's param leaves."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = 1.0 / math.sqrt(d)
    p = {"router": Leaf((d, e), std=s),
         "up": Leaf((e, d, f), std=s),
         "gate": Leaf((e, d, f), std=s),
         "down": Leaf((e, f, d), std=1.0 / math.sqrt(f))}
    if cfg.w1a8_body:
        p["act_step"] = Leaf((), fill=0.05)
    if cfg.shared_experts:
        fs = f * cfg.shared_experts
        p["shared_up"] = Leaf((d, fs), std=s)
        p["shared_gate"] = Leaf((d, fs), std=s)
        p["shared_down"] = Leaf((fs, d), std=1.0 / math.sqrt(fs))
    return p


def _packed_experts(p: dict, name: str, x: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """Deployed experts: uint8 codes of x (E, cap, K) against the sign
    words, Σ code·sign exact, times α·step; rows from ``counts[e]`` on
    are zero."""
    k = x.shape[-1]
    step = p["act_step"].to(x.dtype)
    codes = layers.quantize_act(x, step).to(torch.uint8)
    div = p[name + "_alpha"][:, 0, :].to(torch.float32) \
        * step.to(torch.float32)
    y = w1a8_matmul_grouped(codes, p[name + "_packed"], counts, div,
                            torch.zeros_like(div), k=k)
    return y.to(x.dtype)


def _expert_mm(p: dict, name: str, x: torch.Tensor, mode: str,
               counts: torch.Tensor, mean_group=None) -> torch.Tensor:
    """Grouped GEMM (E, T, K) @ (E, K, N), W1A8 QAT / packed-deploy
    aware. ``counts`` (E,) holds each expert's rows (the packed route
    reads no weights past them). ``mean_group``: the group K is split
    over (the down projection under TP); QAT's α = mean_K|w| is then the
    mean over the group's slices, as the reference's ``pmean``."""
    act_step = p.get("act_step")
    if name + "_packed" in p:
        return _packed_experts(p, name, x, counts)
    w = p[name]
    with full_f32():
        if act_step is not None and mode != "float":
            if mode == "w1a8_train":
                gs = lsq_grad_scale(max(x.numel() // max(x.shape[-1], 1), 1))
                xq = lsq_fake_quant(x, act_step, gs)
                wb = binarize_ste(w)
            else:  # w1a8_eval: the same forward value, no STE graph
                xq = layers.quantize_act(x, act_step) * act_step
                wb = binarize_weight(w)
            alpha = torch.mean(torch.abs(w), dim=1, keepdim=True).detach()
            if mean_group is not None:
                alpha = all_reduce(alpha, mean_group) / full_like0(
                    alpha, dist.get_world_size(mean_group))
            return torch.bmm(xq, wb.to(xq.dtype)) * alpha.to(xq.dtype)
        return torch.bmm(x, w.to(x.dtype))


class _A2AU8(torch.autograd.Function):
    """The uint8-wire all-to-all (the reference's ``_a2a_u8``): forward,
    uint8 codes of ``x`` against ``step``, a 1-byte all-to-all, codes ·
    step; backward, a plain all-to-all of the cotangent (straight through
    the quantizer) and a zero gradient for the step."""

    @staticmethod
    def forward(ctx, x, step, group):
        ctx.group = group
        codes = layers.quantize_act(x, step).to(torch.uint8)
        return all_to_all_rows(codes, group).to(x.dtype) * step

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return all_to_all_rows(g, ctx.group), zero, None


@dataclasses.dataclass(frozen=True)
class MoEDispatch:
    """Static dispatch plan for one MoE call."""
    num_experts: int
    top_k: int
    capacity: int       # per-expert, per source shard
    ep: int             # expert-parallel degree (1 = single shard)


def plan_dispatch(cfg: ModelConfig, tokens_local: int,
                  ep: int = 1) -> MoEDispatch:
    """The reference's capacity: ceil(T·k·cf / E) of the shard's own
    tokens, at most T·k, padded to a multiple of 8 (at least 8). Dropping
    makes outputs depend on batch composition; capacity_factor ≥
    num_experts never drops (cap ≥ T·k)."""
    cap = max(1, math.ceil(tokens_local * cfg.top_k * cfg.capacity_factor
                           / cfg.num_experts))
    cap = min(cap, tokens_local * cfg.top_k)
    cap = max(8, -(-cap // 8) * 8)
    return MoEDispatch(cfg.num_experts, cfg.top_k, cap, ep)


def top_k(logits: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order): a stable
    descending sort, first k."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ router in full f32 (TF32 would change which experts win)."""
    with full_f32():
        return (x @ p["router"].to(x.dtype)).to(torch.float32)


def _held_rows(counts: torch.Tensor, ep: int, cap: int,
               group) -> torch.Tensor:
    """Each local expert's rows after the all-to-all: the end of its last
    non-empty run of the ``ep`` runs of ``cap`` (0 if all are empty)."""
    runs = all_to_all_rows(counts.reshape(ep, -1), group)   # (ep, E_local)
    start = torch.arange(ep, dtype=runs.dtype,
                         device=runs.device)[:, None] * cap
    return torch.where(runs > 0, start + runs, 0).amax(0).to(torch.int32)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
            ep_group=None, tp_group=None, shared_tp=None,
            a2a_quant: bool = False) -> torch.Tensor:
    """x: (T_local, D) tokens of this rank → (T_local, D).

    ``ep_group``: the experts split over its ranks (``p``'s expert leaves
    hold this rank's E / ep) and tokens travel by all-to-all. ``tp_group``:
    the expert hidden dim F split over its ranks, the down projection
    summed over them. ``shared_tp``: the same for the shared experts.
    Without groups every expert is local and no collective runs."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    ep = dist.get_world_size(ep_group) if ep_group is not None else 1
    cap = plan_dispatch(cfg, t, ep).capacity
    e_local = e // ep
    dev = x.device

    # --- routing -----------------------------------------------------------
    gates, idx = top_k(router_logits(p, x), k)                # (T, k)
    gates = torch.softmax(gates, dim=-1).to(x.dtype)

    # --- pack: order assignments by expert, keep first `cap` per expert ----
    flat_e = idx.reshape(-1)                                  # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank of each assignment within its expert
    pos_in_e = torch.arange(t * k, device=dev) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos_in_e < cap
    slot = torch.clamp(pos_in_e, max=cap - 1)                 # in range
    src_tok = order // k
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
    # a dropped assignment adds 0 at its expert's last row
    buf.index_put_((sorted_e, slot),
                   torch.where(keep[:, None], x[src_tok], 0.0),
                   accumulate=True)
    # each expert's kept rows, from the sorted assignments (bincount would
    # read its largest index back to the host)
    starts = torch.searchsorted(sorted_e, torch.arange(e + 1, device=dev),
                                side="left")
    counts = torch.clamp(starts[1:] - starts[:-1], max=cap).to(torch.int32)

    # --- all_to_all to expert shards ---------------------------------------
    if ep_group is not None:
        buf = buf.reshape(ep, e_local, cap, d)
        if a2a_quant and "act_step" in p:
            # W1A8 dispatch: uint8 codes on the wire (the experts quantize
            # with the same step, so they see the same codes)
            buf = _A2AU8.apply(buf, p["act_step"], ep_group)
        else:
            buf = all_to_all(buf, ep_group)
        buf = buf.transpose(0, 1).reshape(e_local, ep * cap, d)
        counts = _held_rows(counts, ep, cap, ep_group)
    if tp_group is not None:
        buf = sum_grad(buf, tp_group)

    # --- expert computation (grouped GEMM, W1A8-aware, TP over tp_group) ---
    up = _expert_mm(p, "up", buf, mode, counts)
    gate = _expert_mm(p, "gate", buf, mode, counts)
    h = up * _act(cfg.act_fn)(gate)
    out = _expert_mm(p, "down", h, mode, counts, mean_group=tp_group)
    if tp_group is not None:
        out = psum(out, tp_group)                             # TP reduce

    # --- return to source shards & unpack ----------------------------------
    if ep_group is not None:
        out = out.reshape(e_local, ep, cap, d).transpose(0, 1)
        if a2a_quant and out.dtype == torch.float32:
            out = out.to(torch.bfloat16)          # halve the return wire
        out = all_to_all(out, ep_group).reshape(e, cap, d).to(x.dtype)

    # --- unpack and combine --------------------------------------------------
    fetched = torch.where(keep[:, None], out[sorted_e, slot], 0.0)
    contrib = torch.empty((t * k, d), dtype=x.dtype, device=dev)
    contrib[order] = fetched                                  # a permutation
    y = torch.sum(contrib.reshape(t, k, d) * gates[..., None], dim=1)

    # --- shared experts (kimi-k2): always-on dense path --------------------
    if "shared_up" in p:
        xs = x if shared_tp is None else sum_grad(x, shared_tp)
        with full_f32():
            h = (xs @ p["shared_up"].to(x.dtype)) \
                * _act(cfg.act_fn)(xs @ p["shared_gate"].to(x.dtype))
            sh = h @ p["shared_down"].to(x.dtype)
        y = y + (sh if shared_tp is None else psum(sh, shared_tp))
    return y


def load_balance_loss(p: dict, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · p_e (train-time hook)."""
    logits = router_logits(p, x)
    probs = torch.softmax(logits, dim=-1)
    _, idx = top_k(logits, cfg.top_k)
    f = torch.mean(torch.nn.functional.one_hot(
        idx, cfg.num_experts).to(torch.float32), dim=(0, 1))
    return cfg.num_experts * torch.sum(f * torch.mean(probs, 0)) * 1e-2
