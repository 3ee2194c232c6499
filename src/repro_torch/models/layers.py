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


def packed_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A deployed projection: codes = quantize_act(x, step) as uint8
    (negatives clip to 0), then the popcount matmul's exact int32 Σ
    code·sign, times α·step, plus the bias. ``p["act_step"]`` holds one
    step, broadcast to (K,) by `deploy_lm`, so the kernel's fold of the
    codes onto one grid is the identity."""
    k = x.shape[-1]
    step = p["act_step"].to(x.dtype)
    codes = quantize_act(x, step).to(torch.uint8)
    alpha = p["alpha"]
    bias = p["b"] if "b" in p else torch.zeros_like(alpha)
    y = w1a8_matmul(codes, p["w_packed"], torch.broadcast_to(step, (k,)),
                    alpha, bias, k=k, config=POPCOUNT)
    return y.to(x.dtype)


def linear(p: dict, x: torch.Tensor, mode: str = "float") -> torch.Tensor:
    """Apply a (possibly W1A8) projection; mode selects the datapath."""
    if "w_packed" in p:
        return packed_linear(p, x)
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
            alpha = torch.mean(torch.abs(w), dim=0).detach()
            y = (xq @ wb.to(xq.dtype)) * alpha.to(xq.dtype)
        else:
            y = x @ w.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


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


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              mode: str, causal: bool = True, window: int = 0,
              positions: Optional[torch.Tensor] = None,
              kv_x: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self- or cross-attention (kv_x given ⇒ cross, no RoPE on kv
    source)."""
    b, s, d = x.shape
    hd = cfg.hd
    src = kv_x if kv_x is not None else x
    t = src.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if kv_positions is None:
        kv_positions = positions if kv_x is None else \
            torch.arange(t, device=x.device).expand(b, t)
    q = linear(p["wq"], x, mode).reshape(b, s, cfg.heads_eff, hd)
    k = linear(p["wk"], src, mode).reshape(b, t, cfg.num_kv_heads, hd)
    v = linear(p["wv"], src, mode).reshape(b, t, cfg.num_kv_heads, hd)
    if kv_x is None:                              # RoPE only for self-attn
        q = rope(q, positions, theta=cfg.rope_theta,
                 fraction=cfg.rope_fraction)
        k = rope(k, kv_positions, theta=cfg.rope_theta,
                 fraction=cfg.rope_fraction)
    if cfg.flat_head_attn:
        g = cfg.heads_eff // cfg.num_kv_heads
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    if cfg.flash_block > 0 and s > cfg.flash_block and kv_x is None:
        out = _blockwise_attention(q, k, v, causal=causal, window=window,
                                   softcap_=cfg.attn_softcap,
                                   q_pos=positions, k_pos=kv_positions,
                                   block=cfg.flash_block)
        return linear(p["wo"], out.reshape(b, s, -1), mode)
    probs, g = _attn_weights(q, k, causal=causal and kv_x is None,
                             window=window, softcap_=cfg.attn_softcap,
                             q_pos=positions, k_pos=kv_positions)
    with full_f32():
        out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, -1)
    return linear(p["wo"], out, mode)


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


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor, mode: str
        ) -> torch.Tensor:
    up = linear(p["up"], x, mode)
    if "gate" in p:
        up = up * _act(cfg.act_fn)(linear(p["gate"], x, mode))
    else:
        up = _act(cfg.act_fn)(up)
    return linear(p["down"], up, mode)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig) -> dict:
    p = {"emb": Leaf((cfg.vocab_size, cfg.d_model), std=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = Leaf((cfg.d_model, cfg.vocab_size), std=0.02)
    return p


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["emb"][tokens.long()]


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    with full_f32():
        logits = x @ (p["head"] if "head" in p
                      else p["emb"].T.to(x.dtype))
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits
