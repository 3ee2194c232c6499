"""Transformer building blocks with first-class W1A8 quantization.

Counterpart of ``repro/models/layers.py``. Every projection runs in one of
four modes:
  "float"       — plain f32 matmul (the fp baseline the paper compares to)
  "w1a8_train"  — QAT: LSQ fake-quant activations + sign-STE weights
  "w1a8_eval"   — deployment algebra on fake-quant params (eval oracle)
  packed        — deployed 1-bit weights (``"w_packed" in p``,
                  `serve.packed.deploy_lm`), whatever the mode says

The packed projection forms uint8 codes and runs the popcount matmul
(``csrc/w1a8_matmul_popcount.cu`` on the card, its plain version on the
CPU), which reads 1 bit a weight. Float matmuls and attention run inside
`device.full_f32` (TF32 would flip codes downstream). Where the reference
divides by a number, the port divides by a tensor on the operand's device:
CUDA multiplies by the reciprocal of a Python number.

Tensor parallelism (a `dist.sharding.TPPlan`, ``tp=``; Megatron's layout,
which XLA gives the reference's jitted cells): every weight is the rank's
block as ``param_spec`` lays it out. A column-parallel projection
multiplies the whole input by its columns, with `dist.collectives.
sum_grad` after the quantizer, so the act step's LSQ gradient and dL/dx
come out whole; a row-parallel one quantizes its slice of the input and
sums the partial products with ``psum`` (α = Σ|w| summed over the group
over the whole K; the bias once, after the sum; the act step's gradient a
partial the train step sums). Attention runs on the rank's query heads
(`attention_qkv`), the embedding on its vocabulary rows and the head on
its vocabulary columns. A product whose column blocks do not fall on the
rank's heads is gathered first (`head_block`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import (binarize_ste, binarize_weight,
                                    lsq_fake_quant, lsq_grad_scale,
                                    quantize_act)
from repro_torch.device import full_f32
from repro_torch.dist.collectives import (all_reduce, gather_cols, psum,
                                          sum_grad, take_block)
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.w1a8_matmul.ops import w1a8_matmul

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads
    # attention flavor
    rope_theta: float = 1e4
    rope_fraction: float = 1.0     # chatglm3: 0.5 (2D RoPE)
    qkv_bias: bool = False         # qwen2.5
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    sliding_window: int = 0        # mixtral: 4096; gemma2 local layers: 4096
    local_global: bool = False     # gemma2: alternate SWA / global layers
    post_norms: bool = False       # gemma2: post-attn/post-ffn RMSNorm
    # MoE
    num_experts: int = 0
    top_k: int = 0
    shared_experts: int = 0        # kimi-k2: 1
    moe_every: int = 1             # jamba: 2 (MoE on every other layer)
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_kind: str = "mamba2"       # mamba2 (SSD) | mamba1 (selective scan)
    attn_every: int = 0            # jamba: 8 (1 attention per 8 layers)
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # blockwise (flash) attention: 0 = off, else the KV/Q block size
    flash_block: int = 0
    # query heads padded to a count that shards evenly (extra heads are
    # real params)
    pad_heads_to: int = 0
    # expand the KV heads to the flat head count in attention
    flat_head_attn: bool = False
    # enc-dec / modality stub
    encoder_layers: int = 0
    frontend: str = "none"         # none | audio | vision
    prefix_len: int = 0            # vision: 256 patch embeddings
    tie_embeddings: bool = True
    norm_kind: str = "rms"         # rms | layer
    act_fn: str = "silu"           # silu | gelu
    gated_mlp: bool = True
    # the paper's technique
    w1a8_body: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def heads_eff(self) -> int:
        return self.pad_heads_to or self.num_heads

    @property
    def period(self) -> int:
        """Repeating layer-pattern length (one stage)."""
        p = 1
        if self.local_global:
            p = 2
        if self.attn_every:
            p = max(p, self.attn_every)
        if self.num_experts and self.moe_every > 1:
            p = max(p, self.moe_every)
        return p

    def mixer_kind(self, i: int) -> str:
        if self.family in ("ssm",):
            return "mamba"
        if self.attn_every:                      # hybrid: 1 attn per period
            return "attn" if i % self.attn_every == self.attn_every // 2 \
                else "mamba"
        if self.local_global:                    # gemma2: local, global, ...
            return "attn_local" if i % 2 == 0 else "attn_global"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        if self.family == "ssm":
            return "none"
        if self.num_experts and i % self.moe_every == self.moe_every - 1:
            return "moe"
        return "dense"


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One param leaf of one stage, as `transformer.init_lm_params` makes
    it: N(0, std²) draws from the generator when ``std`` > 0, else the
    constant ``fill`` (a number, or a function of (dtype, device) giving
    the leaf)."""
    shape: tuple
    std: float = 0.0
    fill: Any = 0.0


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v with v as a tensor on x's device: a true division on the card
    too."""
    return x / x.new_full((), v)


# ---------------------------------------------------------------------------
# Linear with W1A8 switch
# ---------------------------------------------------------------------------

def init_linear(k: int, n: int, *, w1a8: bool, bias: bool = False,
                scale: float = 1.0) -> dict:
    """One projection's param leaves."""
    p = {"w": Leaf((k, n), std=scale / math.sqrt(k))}
    if bias:
        p["b"] = Leaf((n,))
    if w1a8:
        p["act_step"] = Leaf((), fill=0.05)
    return p


POPCOUNT = KernelConfig(op="matmul", accum="popcount")


def packed_linear(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """A deployed projection: codes = quantize_act(x, step) as uint8
    (negatives clip to 0), then the popcount matmul's exact int32 Σ
    code·sign, times α·step, plus the bias. ``p["act_step"]`` holds one
    step, broadcast to (K,) by `deploy_lm`, so the kernel's fold of the
    codes onto one grid is the identity. ``tp`` (a `dist.sharding.Proj`):
    'col' launches on the rank's columns; 'row' on its K-slice of the
    words, the partial products summed over the group and the bias added
    once after."""
    k = x.shape[-1]
    row = tp is not None and tp.kind == "row"
    step = p["act_step"]
    if row:
        step = step[..., tp.plan.rank * k:(tp.plan.rank + 1) * k]
    step = step.to(x.dtype)
    codes = quantize_act(x, step).to(torch.uint8)
    alpha = p["alpha"]
    bias = p["b"] if "b" in p and not row else torch.zeros_like(alpha)
    y = w1a8_matmul(codes, p["w_packed"], torch.broadcast_to(step, (k,)),
                    alpha, bias, k=k, config=POPCOUNT).to(x.dtype)
    if row:
        y = psum(y, tp.plan.group)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
    return y


def _alpha(w: torch.Tensor, tp) -> torch.Tensor:
    """mean |w| over K, detached; a row-parallel block's sums all-reduced
    over the group, over the whole K (at one rank the local path's mean,
    bit for bit)."""
    if tp is None or tp.kind != "row" or tp.plan.n == 1:
        return torch.mean(torch.abs(w), dim=0).detach()
    total = all_reduce(torch.sum(torch.abs(w.detach()), dim=0),
                       tp.plan.group)
    return _div(total, tp.k)


def linear(p: dict, x: torch.Tensor, mode: str = "float",
           tp=None) -> torch.Tensor:
    """Apply a (possibly W1A8) projection; mode selects the datapath.
    ``tp``: the projection's `dist.sharding.Proj` under tensor
    parallelism ('col': ``x`` whole, the product the rank's columns;
    'row': ``x`` the rank's K-slice, the product summed; 'whole' or None:
    as on one device)."""
    if "w_packed" in p:
        return packed_linear(p, x, tp)
    kind = "whole" if tp is None else tp.kind
    w = p["w"]
    with full_f32():
        if "act_step" in p and mode != "float":
            if mode == "w1a8_train":
                gs = lsq_grad_scale(x.numel() // max(x.shape[-1], 1))
                xq = lsq_fake_quant(x, p["act_step"], gs)
                wb = binarize_ste(w)
            else:  # w1a8_eval
                xq = quantize_act(x, p["act_step"]) * p["act_step"]
                wb = binarize_weight(w)
            if kind == "col":
                xq = sum_grad(xq, tp.plan.group)
            alpha = _alpha(w, tp)
            y = (xq @ wb.to(xq.dtype)) * alpha.to(xq.dtype)
        else:
            if kind == "col":
                x = sum_grad(x, tp.plan.group)
            y = x @ w.to(x.dtype)
    if kind == "row":
        y = psum(y, tp.plan.group)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def feed(x: torch.Tensor, split: bool, tp) -> torch.Tensor:
    """``x`` as projection ``tp`` takes it: a row-parallel one its even
    block of the last dim, any other the whole. ``split``: ``x`` holds the
    rank's block (a column-parallel product), else it is whole."""
    if tp is None:
        return x
    if tp.kind == "row":
        return x if split else take_block(x, tp.plan.group)
    return gather_cols(x, tp.plan.group) if split else x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str = "rms") -> dict:
    p = {"scale": Leaf((d,), fill=1.0)}
    if kind == "layer":
        p["bias"] = Leaf((d,))
    return p


def norm(p: dict, x: torch.Tensor, kind: str = "rms",
         eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "layer":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + partial/2D fraction)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). chatglm3 rotates only the
    first half of head_dim (fraction=0.5, '2D RoPE')."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(theta, _div(-ar, half))
    ang = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), xp], -1)


# ---------------------------------------------------------------------------
# Attention (GQA, SWA, softcap, cross)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    he = cfg.heads_eff
    w1a8 = cfg.w1a8_body
    return {
        "wq": init_linear(d, he * hd, w1a8=w1a8, bias=cfg.qkv_bias),
        "wk": init_linear(d, cfg.num_kv_heads * hd, w1a8=w1a8,
                          bias=cfg.qkv_bias),
        "wv": init_linear(d, cfg.num_kv_heads * hd, w1a8=w1a8,
                          bias=cfg.qkv_bias),
        "wo": init_linear(he * hd, d, w1a8=w1a8),
    }


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(_div(logits, cap))


def _attn_weights(q, k, *, causal: bool, window: int, softcap_: float,
                  q_pos, k_pos):
    """q (B,S,H,hd), k (B,T,KV,hd) → probs (B,KV,G,S,T) with GQA
    broadcast."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    with full_f32():
        logits = _div(torch.einsum("bskgd,btkd->bkgst", qg, k),
                      math.sqrt(hd))
    logits = logits.to(torch.float32)
    if softcap_ > 0:
        logits = softcap(logits, softcap_)
    if q_pos is not None and (causal or window > 0):
        qp = q_pos[:, :, None]
        kp = k_pos[:, None, :]
        valid = torch.ones((b, s, t), dtype=torch.bool, device=q.device)
        if causal:
            valid &= kp <= qp
        if window > 0:
            valid &= kp > qp - window
        logits = torch.where(valid[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return probs.to(q.dtype), g


def _blockwise_attention(q, k, v, *, causal: bool, window: int,
                         softcap_: float, q_pos, k_pos, block: int):
    """Flash-attention pattern in plain torch: double-chunked online
    softmax, never the (S, T) score matrix. q (B,S,H,hd); k/v (B,T,KV,hd).
    Positions drive the causal/window mask."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    bq, bk = min(block, s), min(block, t)
    nq, nk = -(-s // bq), -(-t // bk)
    pad_q, pad_k = nq * bq - s, nk * bk - t
    qp = F.pad(q_pos, (0, pad_q), value=-1)
    kp = F.pad(k_pos, (0, pad_k), value=2 ** 30)
    q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for iq in range(nq):
        qb = q[:, iq * bq:(iq + 1) * bq].reshape(b, bq, kv, g, hd)
        qpb = qp[:, iq * bq:(iq + 1) * bq]
        m = torch.full((b, kv, g, bq), -math.inf, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((b, kv, g, bq), dtype=torch.float32,
                           device=q.device)
        acc = torch.zeros((b, kv, g, bq, hd), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            kb = k[:, ik * bk:(ik + 1) * bk]
            vb = v[:, ik * bk:(ik + 1) * bk]
            kpb = kp[:, ik * bk:(ik + 1) * bk]
            with full_f32():
                logits = torch.einsum("bqkgd,btkd->bkgqt", qb, kb) \
                    .to(torch.float32) * scale
            if softcap_ > 0:
                logits = softcap(logits, softcap_)
            valid = torch.ones((b, bq, bk), dtype=torch.bool,
                               device=q.device)
            if causal:
                valid &= kpb[:, None, :] <= qpb[:, :, None]
            if window > 0:
                valid &= kpb[:, None, :] > qpb[:, :, None] - window
            logits = torch.where(valid[:, None, None, :, :], logits, -1e30)
            m_new = torch.maximum(m, torch.amax(logits, -1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, -1)
            with full_f32():
                acc = acc * corr[..., None] + torch.einsum(
                    "bkgqt,btkd->bkgqd", p, vb.to(torch.float32))
            m = m_new
        out = acc / torch.clamp(lsum, min=1e-20)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(v.dtype))  # (B,bq,KV,G,hd)
    out = torch.cat(outs, dim=1).reshape(b, nq * bq, h, hd)
    return out[:, :s]


def head_block(y: torch.Tensor, tp, proj, heads: int, lo: int, hi: int,
               hd: int) -> torch.Tensor:
    """Heads [lo, hi) of a projection's product ``y`` (``proj`` its
    `dist.sharding.Proj`), which hold ``heads`` heads of ``hd`` columns in
    all. Where the product is the rank's column block and that block is
    these heads, ``y`` itself. Otherwise the product is gathered (if it is
    a block) and sliced, and the slice's cotangent is summed over the
    group: each rank differentiates its own heads only."""
    if proj.kind == "col" and heads % tp.n == 0 and \
            (lo, hi) == tp.block(heads):
        return y
    if proj.kind == "col":
        y = gather_cols(y, tp.group)
    return sum_grad(y, tp.group)[..., lo * hd:hi * hd]


def local_kv(k: torch.Tensor, v: torch.Tensor, h0: int, h1: int, g: int,
             kv0: int) -> tuple:
    """k, v (B, T, KV_l, hd) of the KV heads from ``kv0`` on, laid out for
    query heads [h0, h1) of groups of ``g``: as they are where each of the
    KV heads serves the same count of consecutive query heads, else one KV
    head a query head."""
    hl, kvl = h1 - h0, k.shape[2]
    want = [(h0 + i) // g - kv0 for i in range(hl)]
    if hl % kvl == 0 and want == [i // (hl // kvl) for i in range(hl)]:
        return k, v
    # made on the device: a copy from the host would sync, which a CUDA
    # graph capture of a sharded decode tick refuses
    idx = torch.div(torch.arange(h0, h1, device=k.device), g,
                    rounding_mode="floor") - kv0
    return k.index_select(2, idx), v.index_select(2, idx)


def attention_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  src: torch.Tensor, mode: str, tp,
                  kv_range: Optional[tuple] = None,
                  with_q: bool = True) -> tuple:
    """(q, k, v, (h0, h1), (kv0, kv1)): q (B, S, h1 - h0, hd) of this
    rank's query heads (None unless ``with_q``), k and v (B, T, kv1 - kv0,
    hd) of the KV heads [kv0, kv1): those the query heads need, or
    ``kv_range``. Without ``tp`` every head."""
    b, s, _ = x.shape
    t = src.shape[1]
    hd, h, kvh = cfg.hd, cfg.heads_eff, cfg.num_kv_heads
    if tp is None:
        q = linear(p["wq"], x, mode).reshape(b, s, h, hd) if with_q \
            else None
        k = linear(p["wk"], src, mode).reshape(b, t, kvh, hd)
        v = linear(p["wv"], src, mode).reshape(b, t, kvh, hd)
        return q, k, v, (0, h), (0, kvh)
    d, packed = cfg.d_model, "w_packed" in p["wq"]
    h0, h1 = tp.heads(h)
    g = h // kvh
    kv0, kv1 = kv_range or (h0 // g, (h1 - 1) // g + 1)
    tq = tp.proj("wq", d, h * hd, packed)
    tk = tp.proj("wk", d, kvh * hd, packed)
    tv = tp.proj("wv", d, kvh * hd, packed)
    q = head_block(linear(p["wq"], x, mode, tq), tp, tq, h, h0, h1,
                   hd).reshape(b, s, h1 - h0, hd) if with_q else None
    k = head_block(linear(p["wk"], src, mode, tk), tp, tk, kvh, kv0, kv1,
                   hd)
    v = head_block(linear(p["wv"], src, mode, tv), tp, tv, kvh, kv0, kv1,
                   hd)
    return (q, k.reshape(b, t, kv1 - kv0, hd),
            v.reshape(b, t, kv1 - kv0, hd), (h0, h1), (kv0, kv1))


def attention_out(p: dict, cfg: ModelConfig, out: torch.Tensor, mode: str,
                  tp) -> torch.Tensor:
    """``wo`` over the attention output of this rank's heads (B, S,
    (h1 - h0)·hd): row-parallel where those heads are its block of wo's
    rows; otherwise the heads are summed into the whole output first."""
    if tp is None:
        return linear(p["wo"], out, mode)
    h, hd = cfg.heads_eff, cfg.hd
    t = tp.proj("wo", h * hd, cfg.d_model, "w_packed" in p["wo"])
    if t.kind == "row" and h % tp.n == 0:
        return linear(p["wo"], out, mode, t)
    h0, h1 = tp.heads(h)
    whole = psum(F.pad(out, (h0 * hd, (h - h1) * hd)), tp.group)
    return linear(p["wo"], feed(whole, False, t), mode, t)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              mode: str, causal: bool = True, window: int = 0,
              positions: Optional[torch.Tensor] = None,
              kv_x: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              tp=None) -> torch.Tensor:
    """Self- or cross-attention (kv_x given ⇒ cross, no RoPE on kv
    source). ``tp``: a `dist.sharding.TPPlan`; the rank then attends with
    its query heads (`attention_qkv`), so its scores are 1/n of the
    whole."""
    b, s, d = x.shape
    src = kv_x if kv_x is not None else x
    t = src.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if kv_positions is None:
        kv_positions = positions if kv_x is None else \
            torch.arange(t, device=x.device).expand(b, t)
    q, k, v, (h0, h1), (kv0, _) = attention_qkv(p, cfg, x, src, mode, tp)
    if kv_x is None:                              # RoPE only for self-attn
        q = rope(q, positions, theta=cfg.rope_theta,
                 fraction=cfg.rope_fraction)
        k = rope(k, kv_positions, theta=cfg.rope_theta,
                 fraction=cfg.rope_fraction)
    g = cfg.heads_eff // cfg.num_kv_heads
    if cfg.flat_head_attn:
        idx = torch.arange(h0, h1, device=k.device) // g - kv0
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    elif tp is not None:
        k, v = local_kv(k, v, h0, h1, g, kv0)
    if cfg.flash_block > 0 and s > cfg.flash_block and kv_x is None:
        out = _blockwise_attention(q, k, v, causal=causal, window=window,
                                   softcap_=cfg.attn_softcap,
                                   q_pos=positions, k_pos=kv_positions,
                                   block=cfg.flash_block)
        return attention_out(p, cfg, out.reshape(b, s, -1), mode, tp)
    probs, g = _attn_weights(q, k, causal=causal and kv_x is None,
                             window=window, softcap_=cfg.attn_softcap,
                             q_pos=positions, k_pos=kv_positions)
    with full_f32():
        out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, -1)
    return attention_out(p, cfg, out, mode, tp)


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    w1a8 = cfg.w1a8_body
    p = {"up": init_linear(d, f, w1a8=w1a8),
         "down": init_linear(f, d, w1a8=w1a8)}
    if cfg.gated_mlp:
        p["gate"] = init_linear(d, f, w1a8=w1a8)
    return p


def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    return F.silu


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor, mode: str,
        tp=None) -> torch.Tensor:
    """``up``/``gate`` then ``down``; under ``tp`` column- then
    row-parallel where the plan splits them (a whole ``down`` after split
    ``up`` takes the gathered hidden)."""
    if tp is None:
        up = linear(p["up"], x, mode)
        if "gate" in p:
            up = up * _act(cfg.act_fn)(linear(p["gate"], x, mode))
        else:
            up = _act(cfg.act_fn)(up)
        return linear(p["down"], up, mode)
    d, f, packed = cfg.d_model, cfg.d_ff, "w_packed" in p["up"]
    t_up = tp.proj("up", d, f, packed)
    t_down = tp.proj("down", f, d, packed)
    up = linear(p["up"], x, mode, t_up)
    if "gate" in p:
        up = up * _act(cfg.act_fn)(linear(p["gate"], x, mode,
                                          tp.proj("gate", d, f, packed)))
    else:
        up = _act(cfg.act_fn)(up)
    return linear(p["down"], feed(up, t_up.kind == "col", t_down), mode,
                  t_down)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig) -> dict:
    p = {"emb": Leaf((cfg.vocab_size, cfg.d_model), std=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = Leaf((cfg.d_model, cfg.vocab_size), std=0.02)
    return p


def embed(p: dict, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The tokens' rows of ``emb``; under ``tp`` with the vocabulary
    split, each rank looks up its rows (zeros for tokens it does not hold)
    and the ranks' lookups are summed."""
    vocab = None if tp is None else tp.vocab()
    if vocab is None:
        return p["emb"][tokens.long()]
    v0, v1 = vocab
    t = tokens.long() - v0
    held = (t >= 0) & (t < v1 - v0)
    x = p["emb"][torch.clamp(t, 0, v1 - v0 - 1)]
    x = torch.where(held[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return psum(x, tp.group)


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    """Logits (…, V), or under ``tp`` with the vocabulary split this
    rank's block of them (…, V/n): x times its columns of ``head`` (or of
    the tied ``emb.T``), the cotangent of x summed over the group."""
    if tp is not None and tp.vocab() is not None:
        x = sum_grad(x, tp.group)
    with full_f32():
        logits = x @ (p["head"] if "head" in p
                      else p["emb"].T.to(x.dtype))
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits
