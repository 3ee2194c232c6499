"""State-space mixers: Mamba-2 (SSD, chunked dual form) and Mamba-1
(selective scan), both with O(1)-state decode steps (counterpart of
``repro/models/mamba.py``).

The training form processes the sequence in chunks, carrying the
inter-chunk SSM state; where the reference scans over chunks with
``lax.scan``, the port loops over them in Python. Mamba-1's in-chunk
``lax.associative_scan`` becomes `pair_scan`, a doubling scan that forms
the same pair (cumulative decay, state from zero) in a tree of log2(l)
steps, and the carry is injected after, as the reference does. Projections run through `layers.linear` (so
packed ones through the popcount matmul); the einsums run in full f32.

mamba2-1.3b uses SSD; jamba's mamba layers use Mamba-1 (d_state 16).

Under tensor parallelism (``tp``, a `dist.sharding.TPPlan`) the column
blocks of ``in_proj`` do not fall on its components (z, x, B, C, dt;
x, z), so each rank multiplies by its columns and the product is
gathered (`dist.collectives.gather_cols`); the depthwise conv runs on the
rank's channels and is gathered likewise, ``x_proj`` and ``dt_proj`` as
``in_proj``; the scan runs whole on every rank, and ``out_proj`` takes the
rank's slice of its input, row-parallel. A decode step's conv and SSM
states are the rank's channel (head) blocks where the cache holds them so
(`serve.cache.init_cache` under a ctx), and the step's output gathered.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import full_f32, resolve_device
from repro_torch.dist.collectives import gather_cols, take_block
from repro_torch.models.layers import (Leaf, ModelConfig, feed, init_linear,
                                       linear)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def _a_log_mamba2(h: int):
    return lambda dtype, dev: torch.log(torch.linspace(
        1.0, 16.0, h, dtype=torch.float32, device=dev).to(dtype))


def _a_log_mamba1(di: int, n: int):
    return lambda dtype, dev: torch.log(torch.arange(
        1, n + 1, dtype=dtype, device=dev)).expand(di, n)


def init_mamba(cfg: ModelConfig) -> dict:
    """One Mamba mixer's param leaves."""
    d, di, n = cfg.d_model, d_inner(cfg), cfg.ssm_state
    w1a8 = cfg.w1a8_body
    if cfg.ssm_kind == "mamba2":
        h = di // cfg.ssm_headdim
        g = 1                                    # single B/C group
        proj_out = 2 * di + 2 * g * n + h        # z, x, B, C, dt
        return {
            "in_proj": init_linear(d, proj_out, w1a8=w1a8),
            "out_proj": init_linear(di, d, w1a8=w1a8),
            "conv_w": Leaf((cfg.ssm_conv, di + 2 * g * n), std=0.1),
            "conv_b": Leaf((di + 2 * g * n,)),
            "A_log": Leaf((h,), fill=_a_log_mamba2(h)),
            "D": Leaf((h,), fill=1.0),
            "dt_bias": Leaf((h,)),
            "norm_scale": Leaf((di,), fill=1.0),
        }
    dt_rank = max(1, math.ceil(d / 16))
    return {
        "in_proj": init_linear(d, 2 * di, w1a8=w1a8),
        "out_proj": init_linear(di, d, w1a8=w1a8),
        "conv_w": Leaf((cfg.ssm_conv, di), std=0.1),
        "conv_b": Leaf((di,)),
        "x_proj": init_linear(di, dt_rank + 2 * n, w1a8=False),
        "dt_proj": init_linear(dt_rank, di, w1a8=False, bias=True),
        "A_log": Leaf((di, n), fill=_a_log_mamba1(di, n)),
        "D": Leaf((di,), fill=1.0),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` forms it, logaddexp(x, 0):
    ``F.softplus`` returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _pad_seq(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zeros on axis 1 of x (B, S, ...)."""
    pad = [0, 0] * (x.ndim - 2) + [before, after]
    return F.pad(x, pad)


# ---------------------------------------------------------------------------
# Causal depthwise conv (width W) + cache-friendly step form
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x (B,S,C), w (W,C): y[t] = Σ_i w[i]·x[t-W+1+i] + b, zero history,
    as the reference's sum of shifted products (no cuDNN conv, which
    would run in TF32)."""
    width, s = w.shape[0], x.shape[1]
    xp = _pad_seq(x, width - 1, 0)
    acc = xp[:, 0:s, :] * w[0]
    for i in range(1, width):
        acc = acc + xp[:, i:i + s, :] * w[i]
    return F.silu(acc + b)


def causal_conv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode step. x_new (B,C); conv_state (B,W-1,C) past inputs. The
    window's products are summed in `causal_conv`'s order."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)
    acc = window[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i] * w[i]
    return F.silu(acc + b), window[:, 1:, :]


def _conv_state(x_raw: torch.Tensor, width: int) -> torch.Tensor:
    """The last W-1 conv inputs after a prompt, zeros before it."""
    s = x_raw.shape[1]
    if s >= width - 1:
        return x_raw[:, s - (width - 1):, :]
    return _pad_seq(x_raw, width - 1 - s, 0)


# ---------------------------------------------------------------------------
# Tensor parallelism: products gathered around the whole scan
# ---------------------------------------------------------------------------

def gathered(p: dict, name: str, x: torch.Tensor, mode: str, tp, k: int,
             n_out: int) -> torch.Tensor:
    """The whole product of the column-parallel projection ``name`` (a
    whole (k, n_out) weight): the rank's columns, gathered."""
    if tp is None:
        return linear(p[name], x, mode)
    t = tp.proj(name, k, n_out, "w_packed" in p[name])
    y = linear(p[name], x, mode, t)
    return gather_cols(y, tp.group) if t.kind == "col" else y


def out_proj(p: dict, cfg: ModelConfig, y: torch.Tensor, mode: str,
             tp) -> torch.Tensor:
    """``out_proj`` of the whole ``y``: row-parallel on the rank's slice
    where the plan splits it."""
    if tp is None:
        return linear(p["out_proj"], y, mode)
    t = tp.proj("out_proj", d_inner(cfg), cfg.d_model,
                "w_packed" in p["out_proj"])
    return linear(p["out_proj"], feed(y, False, t), mode, t)


def _conv_split(cfg: ModelConfig, tp, c: int) -> bool:
    return tp is not None and tp.split("['conv_w']", (cfg.ssm_conv, c))


def conv(p: dict, cfg: ModelConfig, x: torch.Tensor, tp) -> torch.Tensor:
    """`causal_conv` of the whole ``x``: on the rank's channels, gathered,
    where ``conv_w`` is split."""
    if not _conv_split(cfg, tp, x.shape[-1]):
        return causal_conv(x, p["conv_w"], p["conv_b"])
    y = causal_conv(take_block(x, tp.group), p["conv_w"], p["conv_b"])
    return gather_cols(y, tp.group)


def conv_step(p: dict, cfg: ModelConfig, x_new: torch.Tensor,
              state: torch.Tensor, tp) -> tuple:
    """`causal_conv_step` of the whole ``x_new`` (B, C) against
    ``state``, the rank's channel block where the cache splits it: the
    whole output, and the state in the cache's layout."""
    c = x_new.shape[-1]
    if not _conv_split(cfg, tp, c):
        return causal_conv_step(x_new, state, p["conv_w"], p["conv_b"])
    a, b = tp.block(c)
    whole = state.shape[-1] == c
    y, new = causal_conv_step(x_new[..., a:b],
                              state[..., a:b] if whole else state,
                              p["conv_w"], p["conv_b"])
    if whole:
        new = torch.cat([state, x_new[:, None, :]], dim=1)[:, 1:, :]
    return gather_cols(y, tp.group), new


def channel_block(tp, whole: int, held: int) -> tuple:
    """[a, b) of the rank's block of ``whole`` channels where a cache
    leaf holds ``held`` of them, else (0, whole)."""
    return (0, whole) if held == whole else tp.block(whole)


# ---------------------------------------------------------------------------
# Mamba-2: SSD chunked scan
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
    """SSD dual form. x (B,S,H,P), dt (B,S,H) ≥0, a (H,) <0,
    bmat/cmat (B,S,N). Returns (y (B,S,H,P), final_state (B,H,P,N)).

    The reference pads S to a multiple of ``chunk`` with dt = 0, where the
    state passes through unchanged and x·dt adds zeros; the port's last
    chunk is the short one instead."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = init_state if init_state is not None else \
        torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    with full_f32():
        for c0 in range(0, s, chunk):
            xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
            bc, cc = bmat[:, c0:c0 + chunk], cmat[:, c0:c0 + chunk]
            ln = xc.shape[1]
            da = dtc * a                                     # (B,l,H)
            da_cs = torch.cumsum(da, dim=1)
            xdt = xc * dtc[..., None]
            # intra-chunk (quadratic) term
            scores = torch.einsum("bin,bjn->bij", cc, bc)    # (B,l,l)
            diff = da_cs[:, :, None, :] - da_cs[:, None, :, :]
            # mask BEFORE exp: where-after-exp leaks inf·0 = NaN into the
            # backward
            lmat = torch.exp(torch.where(tri[None, :ln, :ln, None], diff,
                                         -1e30))
            y_diag = torch.einsum("bij,bijh,bjhp->bihp", scores, lmat, xdt)
            # inter-chunk: contribution of the carried state
            state_decay = torch.exp(da_cs)                   # (B,l,H)
            y_off = torch.einsum("bin,bhpn,bih->bihp", cc, state,
                                 state_decay)
            # new state: decay-weighted sum of this chunk + decayed carry
            tail = torch.exp(da_cs[:, -1:, :] - da_cs)       # (B,l,H)
            chunk_state = torch.einsum("bln,blhp,blh->bhpn", bc, xdt, tail)
            state = state * torch.exp(da_cs[:, -1, :])[..., None, None] \
                + chunk_state
            ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), state


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor,
                dtype) -> torch.Tensor:
    """Mamba-2's y·silu(z), RMS-normed in f32 with ``norm_scale``."""
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    ms = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-6) * p["norm_scale"]).to(dtype)


def _mamba2_dims(cfg: ModelConfig) -> tuple:
    di, n = d_inner(cfg), cfg.ssm_state
    h = di // cfg.ssm_headdim
    return di, n, h, 2 * di + 2 * n + h


def _mamba2_core(p: dict, cfg: ModelConfig, xin: torch.Tensor, mode: str,
                 tp=None):
    """in_proj → conv → SSD → gate → norm → out_proj; also the conv's raw
    input and the final state, for a prefill's cache."""
    bsz, s, _ = xin.shape
    di, n, h, proj_out = _mamba2_dims(cfg)
    hp = cfg.ssm_headdim
    proj = gathered(p, "in_proj", xin, mode, tp, cfg.d_model, proj_out)
    z, xbc_raw, dt_raw = torch.tensor_split(proj, [di, 2 * di + 2 * n],
                                            dim=-1)
    xbc = conv(p, cfg, xbc_raw, tp)
    xs, bmat, cmat = torch.tensor_split(xbc, [di, di + n], dim=-1)
    dt = softplus(dt_raw + p["dt_bias"])                     # (B,S,H)
    a = -torch.exp(p["A_log"])
    xh = xs.reshape(bsz, s, h, hp)
    y, state = ssd_chunked(xh, dt, a, bmat, cmat)
    y = y + xh * p["D"][:, None]
    y = _gated_norm(p, y.reshape(bsz, s, di), z, xin.dtype)
    return out_proj(p, cfg, y, mode, tp), xbc_raw, state


def mamba2_mixer(p: dict, cfg: ModelConfig, xin: torch.Tensor, *,
                 mode: str, tp=None) -> torch.Tensor:
    """Full Mamba-2 block: in_proj → conv → SSD → gate → norm →
    out_proj."""
    return _mamba2_core(p, cfg, xin, mode, tp)[0]


def mamba2_prefill(p: dict, cfg: ModelConfig, xin: torch.Tensor, *,
                   mode: str, tp=None):
    """Like mamba2_mixer but also returns the decode cache after the
    prompt (whole; the engine keeps the cache's block of it)."""
    out, xbc_raw, state = _mamba2_core(p, cfg, xin, mode, tp)
    return out, {"conv": _conv_state(xbc_raw, cfg.ssm_conv), "ssm": state}


def mamba2_decode_step(p: dict, cfg: ModelConfig, xin: torch.Tensor,
                       cache: dict, mode: str,
                       tp=None) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent update. xin (B,1,D); cache {conv (B,W-1,C),
    ssm (B,H,P,N)}: O(1) memory in sequence length. Under ``tp`` the
    cache may hold the rank's channels and heads: the step updates those
    and gathers its output."""
    bsz = xin.shape[0]
    di, n, h, proj_out = _mamba2_dims(cfg)
    hp = cfg.ssm_headdim
    proj = gathered(p, "in_proj", xin[:, 0, :], mode, tp, cfg.d_model,
                    proj_out)
    z, xbc, dt_raw = torch.tensor_split(proj, [di, 2 * di + 2 * n], dim=-1)
    xbc, conv_state = conv_step(p, cfg, xbc, cache["conv"], tp)
    xs, bmat, cmat = torch.tensor_split(xbc, [di, di + n], dim=-1)
    h0, h1 = channel_block(tp, h, cache["ssm"].shape[1])
    dt = softplus(dt_raw + p["dt_bias"])[:, h0:h1]           # (B,H_l)
    a = -torch.exp(p["A_log"][h0:h1])
    da = torch.exp(dt * a)                                   # (B,H_l)
    xh = xs.reshape(bsz, h, hp)[:, h0:h1]
    with full_f32():
        ssm = cache["ssm"] * da[..., None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", xh, bmat, dt)
        y = torch.einsum("bhpn,bn->bhp", ssm, cmat) + \
            xh * p["D"][h0:h1, None]
    y = y.reshape(bsz, -1)
    if h1 - h0 < h:
        y = gather_cols(y, tp.group)
    y = _gated_norm(p, y, z, xin.dtype)
    out = out_proj(p, cfg, y, mode, tp)
    return out[:, None, :], {"conv": conv_state, "ssm": ssm}


# ---------------------------------------------------------------------------
# Mamba-1: chunked selective scan (jamba's mixer, d_state 16)
# ---------------------------------------------------------------------------

def pair_scan(aa: torch.Tensor, hh: torch.Tensor) -> tuple:
    """The inclusive scan of (a, h) pairs along dim 1 under (a1, h1)∘(a2,
    h2) = (a1·a2, h1·a2 + h2), in log2(l) doubling steps (Hillis–Steele):
    after the step of span d each position holds the combine of the 2d
    steps that end at it. A chunk of 128 takes 7 steps of a few ops each
    where a fold over it takes three ops a position."""
    d = 1
    while d < aa.shape[1]:
        hh = torch.cat([hh[:, :d], hh[:, :-d] * aa[:, d:] + hh[:, d:]], 1)
        aa = torch.cat([aa[:, :d], aa[:, :-d] * aa[:, d:]], 1)
        d *= 2
    return aa, hh


def selective_scan_chunked(u: torch.Tensor, dt: torch.Tensor,
                           a: torch.Tensor, bmat: torch.Tensor,
                           cmat: torch.Tensor, *, chunk: int = 128,
                           init_state: Optional[torch.Tensor] = None):
    """u/dt (B,S,C), a (C,N), bmat/cmat (B,S,N) → (y (B,S,C), state
    (B,C,N)).

    h_t = exp(dt·a)·h_{t-1} + dt·b_t·u_t ; y_t = ⟨h_t, c_t⟩. Per chunk,
    `pair_scan` combines the steps with the reference's (a1, b1)∘(a2, b2)
    = (a1·a2, b1·a2 + b2) in a tree, as its ``lax.associative_scan``
    does, then the carry times the cumulative decay is added. The last
    chunk is short where the reference pads it with dt = 0 (decay 1,
    input 0: the state passes through).
    """
    bsz, s, c = u.shape
    n = bmat.shape[-1]
    state = init_state if init_state is not None else \
        torch.zeros((bsz, c, n), dtype=u.dtype, device=u.device)
    ys = []
    with full_f32():
        for c0 in range(0, s, chunk):
            da = torch.exp(dt[:, c0:c0 + chunk, :, None] * a)  # (B,l,C,N)
            dbu = dt[:, c0:c0 + chunk, :, None] \
                * bmat[:, c0:c0 + chunk, None, :] * u[:, c0:c0 + chunk, :,
                                                      None]
            aa, hh = pair_scan(da, dbu)
            hs = hh + aa * state[:, None]
            ys.append(torch.einsum("blcn,bln->blc", hs,
                                   cmat[:, c0:c0 + chunk]))
            state = hs[:, -1]
    return torch.cat(ys, dim=1), state


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _mamba1_dt(p: dict, cfg: ModelConfig, xs: torch.Tensor, tp) -> tuple:
    """(dt, B, C) of Mamba-1 from the conv's whole output ``xs``."""
    n, di, r = cfg.ssm_state, d_inner(cfg), _dt_rank(cfg)
    proj = gathered(p, "x_proj", xs, "float", tp, di, r + 2 * n)
    dt_lr, bmat, cmat = torch.tensor_split(proj, [r, r + n], dim=-1)
    dt = softplus(gathered(p, "dt_proj", dt_lr, "float", tp, r, di))
    return dt, bmat, cmat


def _mamba1_core(p: dict, cfg: ModelConfig, xin: torch.Tensor, mode: str,
                 tp=None):
    di = d_inner(cfg)
    xz = gathered(p, "in_proj", xin, mode, tp, cfg.d_model, 2 * di)
    xs_raw, z = torch.chunk(xz, 2, dim=-1)
    xs = conv(p, cfg, xs_raw, tp)
    dt, bmat, cmat = _mamba1_dt(p, cfg, xs, tp)
    a = -torch.exp(p["A_log"])
    y, state = selective_scan_chunked(xs, dt, a, bmat, cmat)
    y = (y + xs * p["D"]) * F.silu(z)
    return out_proj(p, cfg, y, mode, tp), xs_raw, state


def mamba1_mixer(p: dict, cfg: ModelConfig, xin: torch.Tensor, *,
                 mode: str, tp=None) -> torch.Tensor:
    return _mamba1_core(p, cfg, xin, mode, tp)[0]


def mamba1_prefill(p: dict, cfg: ModelConfig, xin: torch.Tensor, *,
                   mode: str, tp=None):
    out, xs_raw, state = _mamba1_core(p, cfg, xin, mode, tp)
    return out, {"conv": _conv_state(xs_raw, cfg.ssm_conv), "ssm": state}


def mamba1_decode_step(p: dict, cfg: ModelConfig, xin: torch.Tensor,
                       cache: dict, mode: str,
                       tp=None) -> Tuple[torch.Tensor, dict]:
    di = d_inner(cfg)
    xz = gathered(p, "in_proj", xin[:, 0, :], mode, tp, cfg.d_model, 2 * di)
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, conv_state = conv_step(p, cfg, xs, cache["conv"], tp)
    dt, bmat, cmat = _mamba1_dt(p, cfg, xs, tp)               # (B,C)
    c0, c1 = channel_block(tp, di, cache["ssm"].shape[1])
    dt, xb = dt[:, c0:c1], xs[:, c0:c1]
    a = -torch.exp(p["A_log"][c0:c1])                         # (C_l,N)
    da = torch.exp(dt[..., None] * a)
    with full_f32():
        ssm = cache["ssm"] * da + dt[..., None] * bmat[:, None, :] \
            * xb[..., None]
        y = torch.einsum("bcn,bn->bc", ssm, cmat) + xb * p["D"][c0:c1]
    if c1 - c0 < di:
        y = gather_cols(y, tp.group)
    y = y * F.silu(z)
    out = out_proj(p, cfg, y, mode, tp)
    return out[:, None, :], {"conv": conv_state, "ssm": ssm}


def mamba_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    """Shapes of one Mamba layer's decode state: the conv inputs and the
    SSM state, the batch first."""
    di, n = d_inner(cfg), cfg.ssm_state
    if cfg.ssm_kind == "mamba2":
        h, hp = di // cfg.ssm_headdim, cfg.ssm_headdim
        return {"conv": (batch, cfg.ssm_conv - 1, di + 2 * n),
                "ssm": (batch, h, hp, n)}
    return {"conv": (batch, cfg.ssm_conv - 1, di), "ssm": (batch, di, n)}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """Zero decode state of one Mamba layer on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dtype, device=dev)
            for k, shape in mamba_cache_shapes(cfg, batch).items()}
