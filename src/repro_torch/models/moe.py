"""Top-k dropping MoE, local path (counterpart of ``repro/models/moe.py``
without the expert-parallel all-to-all).

Tokens are sorted by destination expert and packed into a static (E, cap,
D) buffer, the experts run as grouped GEMMs, and the outputs are combined
with the router gates. Capacity cap = ceil(T·k / E · cf) bounds the
buffer; an assignment past its expert's cap is dropped (gate 0), standard
dropping semantics.

Where the reference scatters and gathers at ranks past ``cap`` (JAX drops
or clamps such indices silently), the port clamps the index and masks the
value with ``keep``: the kept rows are never selected by a boolean mask,
so nothing syncs the host or takes a shape from the data. The top-k takes
the lower expert first among equal logits, as ``jax.lax.top_k`` does.

W1A8: expert weights are (E, K, N) stacks; in QAT mode they binarize with
sign-STE like the dense layers (per-expert α). Deployed experts
(`serve.packed.deploy_lm`) hold (E, ⌈K/32⌉, N) sign words and run one
grouped launch of the popcount matmul per projection
(`w1a8_matmul_grouped`): an expert reads its weights only for the rows it
holds.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quant import (binarize_ste, binarize_weight,
                                    lsq_fake_quant, lsq_grad_scale)
from repro_torch.device import full_f32
from repro_torch.kernels.w1a8_matmul.ops import w1a8_matmul_grouped
from repro_torch.models import layers
from repro_torch.models.layers import Leaf, ModelConfig, _act


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
               counts: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM (E, T, K) @ (E, K, N), W1A8 QAT / packed-deploy
    aware. ``counts`` (E,) holds each expert's kept rows (the packed
    route reads no weights past them)."""
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
            return torch.bmm(xq, wb.to(xq.dtype)) * alpha.to(xq.dtype)
        return torch.bmm(x, w.to(x.dtype))


@dataclasses.dataclass(frozen=True)
class MoEDispatch:
    """Static dispatch plan for one MoE call (the local path: the
    reference's expert-parallel degree is 1)."""
    num_experts: int
    top_k: int
    capacity: int       # per-expert


def plan_dispatch(cfg: ModelConfig, tokens_local: int) -> MoEDispatch:
    """The reference's capacity: ceil(T·k·cf / E), at most T·k, padded to
    a multiple of 8 (at least 8). Dropping makes outputs depend on batch
    composition; capacity_factor ≥ num_experts never drops (cap ≥ T·k)."""
    cap = max(1, math.ceil(tokens_local * cfg.top_k * cfg.capacity_factor
                           / cfg.num_experts))
    cap = min(cap, tokens_local * cfg.top_k)
    cap = max(8, -(-cap // 8) * 8)
    return MoEDispatch(cfg.num_experts, cfg.top_k, cap)


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


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
            mode: str) -> torch.Tensor:
    """x: (T, D) tokens → (T, D), every expert local."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = plan_dispatch(cfg, t).capacity
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

    # --- expert computation (grouped GEMM, W1A8-aware) ---------------------
    up = _expert_mm(p, "up", buf, mode, counts)
    gate = _expert_mm(p, "gate", buf, mode, counts)
    h = up * _act(cfg.act_fn)(gate)
    out = _expert_mm(p, "down", h, mode, counts)              # (E, cap, D)

    # --- unpack and combine --------------------------------------------------
    fetched = torch.where(keep[:, None], out[sorted_e, slot], 0.0)
    contrib = torch.empty((t * k, d), dtype=x.dtype, device=dev)
    contrib[order] = fetched                                  # a permutation
    y = torch.sum(contrib.reshape(t, k, d) * gates[..., None], dim=1)

    # --- shared experts (kimi-k2): always-on dense path --------------------
    if "shared_up" in p:
        with full_f32():
            h = (x @ p["shared_up"].to(x.dtype)) \
                * _act(cfg.act_fn)(x @ p["shared_gate"].to(x.dtype))
            y = y + h @ p["shared_down"].to(x.dtype)
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
