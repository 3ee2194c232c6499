"""Deployment packing for LM serving — the parameter-extraction step (§4)
generalized: every W1A8 projection's latent weights become 1-bit sign
words (counterpart of ``repro/serve/packed.py``).

The body's weight bytes drop 32× against f32. A decode step reads every
weight once, so its weight traffic drops by the same factor: chatglm3-6b's
28 layers hold about 0.71 GB of sign words against 22.8 GB of f32.

The packed tree keeps the reference's keys and leading stage axes; sign
words are the reference's ``uint32`` bits in an int32 carrier.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.models.transformer import tree_items


def _stage_mean_abs(w: torch.Tensor, axis: int,
                    keepdim: bool = False) -> torch.Tensor:
    """mean |w| over ``axis``, one leading index at a time: a stacked
    leaf's |w| is never held whole."""
    if w.ndim <= 2:
        return torch.mean(torch.abs(w), dim=axis, keepdim=keepdim)
    return torch.stack([_stage_mean_abs(w[i], axis - 1, keepdim)
                        for i in range(w.shape[0])])


def _pack_linear(p: dict) -> dict:
    """Pack along the K (second-to-last) axis — stacked per-stage params
    carry leading (n_stages,) dims that are preserved."""
    w = p["w"].detach()
    kax = w.ndim - 2
    step = p["act_step"].detach()
    step = step[..., None] if step.ndim else step
    out = {"w_packed": packing.pack_signs(w, axis=kax),
           "alpha": _stage_mean_abs(w, kax).to(torch.float32),
           "act_step": torch.broadcast_to(step, w.shape[:-1])
           .to(torch.float32).contiguous()}
    if "b" in p:
        out["b"] = p["b"].detach()
    return out


def _pack_moe(p: dict) -> dict:
    """An MoE FFN's expert stacks (..., E, K, N): sign words along K and
    α with K kept as 1, as the reference packs them."""
    out = dict(p)
    for name in ("up", "gate", "down"):
        w = p[name].detach()
        kax = w.ndim - 2
        out[name + "_packed"] = packing.pack_signs(w, axis=kax)
        out[name + "_alpha"] = _stage_mean_abs(w, kax, keepdim=True) \
            .to(torch.float32)
        del out[name]
    return out


@torch.no_grad()
def deploy_lm(params):
    """Walk the param tree, packing every W1A8 projection (dicts holding
    both 'w' and 'act_step'). Non-quantized leaves pass through."""
    def walk(node):
        if isinstance(node, dict):
            if "w" in node and "act_step" in node:
                return _pack_linear(node)
            if "router" in node and "up" in node:
                return _pack_moe(node) if "act_step" in node else \
                    {k: walk(v) for k, v in node.items()}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(params)


def packed_param_bytes(tree) -> dict:
    """Byte accounting: packed vs bf16-equivalent (the 16× claim,
    audited)."""
    packed = eq_bf16 = 0
    for name, leaf in tree_items(tree):
        packed += int(leaf.numel()) * leaf.element_size()
        if "packed" in name:
            eq_bf16 += int(leaf.numel()) * 32 * 2   # 32 signs/word → bf16
        else:
            eq_bf16 += int(leaf.numel()) * 2
    return {"packed_bytes": packed, "bf16_equivalent_bytes": eq_bf16,
            "ratio": eq_bf16 / max(packed, 1)}
