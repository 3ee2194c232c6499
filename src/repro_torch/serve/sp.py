"""Sequence parallelism (SP) for long-context decode (counterpart of
``repro/serve/sp.py``).

For the long_500k cells the KV cache shards over a mesh axis on the
*sequence* dim: each of the 16 data ranks holds 32k of the 512k context.
One decode step computes a partial softmax on each rank's shard and
combines them with the global log-sum-exp:

    m = max_r m_r;  l = Σ_r l_r·e^{m_r−m};  o = Σ_r o_r·e^{m_r−m} / l

an all-reduce MAX and two all-reduce SUMs of (B, H)-sized partials a layer
instead of gathering 512k positions of K and V. Used by jamba's attention
layers at long_500k; Mamba needs no SP (O(1) state) and mixtral's window
bounds its ring cache.

Each rank passes its own shard (there are no global arrays to slice).
Logits past ``cur_pos`` are −inf; a shard that holds no valid position
gives m = −inf, l = 0, o = 0 and adds nothing to the combine (where the
reference's e^{m_r−m} would be NaN if no rank held one, the port's is 0,
and the result is 0).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import full_f32
from repro_torch.dist.collectives import all_reduce
from repro_torch.models.layers import _div


def sp_attention_local(q: torch.Tensor, k_local: torch.Tensor,
                       v_local: torch.Tensor, pos_local: torch.Tensor,
                       cur_pos: torch.Tensor) -> tuple:
    """Partial attention of one shard. q (B, H, hd); k, v (B, T_l, KV, hd);
    pos_local (B, T_l) global positions; cur_pos (B,).
    Returns (o (B, H, hd), m (B, H), l (B, H))."""
    b, h, hd = q.shape
    kv = k_local.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    with full_f32():
        logits = _div(torch.einsum("bkgd,btkd->bkgt", qg, k_local),
                      math.sqrt(hd)).to(torch.float32)
        valid = pos_local <= cur_pos[:, None]
        logits = torch.where(valid[:, None, None, :], logits, -math.inf)
        m = torch.amax(logits, dim=-1)                       # (B, KV, G)
        e = torch.exp(logits - m[..., None])
        e = torch.where(torch.isfinite(logits), e, 0.0)
        l = torch.sum(e, dim=-1)
        o = torch.einsum("bkgt,btkd->bkgd", e.to(v_local.dtype), v_local)
    return o.reshape(b, h, hd), m.reshape(b, h), l.reshape(b, h)


def sp_combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
               group) -> torch.Tensor:
    """The global log-sum-exp combine of the ranks' partials over
    ``group`` → (B, H, hd)."""
    m_glob = all_reduce(m, group, dist.ReduceOp.MAX)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_glob), 0.0)
    l_glob = all_reduce(l * corr, group)
    o_glob = all_reduce(o * corr[..., None].to(o.dtype), group)
    return o_glob / torch.clamp(l_glob, min=1e-20)[..., None].to(o.dtype)


def sp_decode_attention(mesh, axis: str, q: torch.Tensor,
                        k_local: torch.Tensor, v_local: torch.Tensor,
                        pos_local: torch.Tensor,
                        cur_pos: torch.Tensor) -> torch.Tensor:
    """One decode step's attention with K, V and positions sharded on T
    over ``axis`` of ``mesh`` (a `DeviceMesh`): q (B, H, hd) and cur_pos
    (B,) whole on every rank, k, v (B, T_l, KV, hd) and pos (B, T_l) this
    rank's shard. Every rank of the axis calls it. Returns (B, H, hd)."""
    o, m, l = sp_attention_local(q, k_local, v_local, pos_local, cur_pos)
    return sp_combine(o, m, l, mesh.get_group(axis))
