"""Deployment packing for LM serving — the parameter-extraction step (§4)
generalized: every W1A8 projection's latent weights become 1-bit sign
words (counterpart of ``repro/serve/packed.py``).

The body's weight bytes drop 32× against f32. A decode step reads every
weight once, so its weight traffic drops by the same factor: chatglm3-6b's
28 layers hold about 0.71 GB of sign words against 22.8 GB of f32.

The packed tree keeps the reference's keys and leading stage axes; sign
words are the reference's ``uint32`` bits in an int32 carrier.

`init_packed_lm` gives `deploy_lm(init_lm_params(...))` without the f32
tree, which for mixtral (187 GB) or jamba (1.6 TB) outgrows the card: it
draws one leaf of one stage at a time, in `init_lm_params`'s order, packs
it into its slot of the stacked words and frees it.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.device import resolve_device
from repro_torch.models import transformer
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
    out = {k: v.detach() for k, v in p.items()}
    for name in ("up", "gate", "down"):
        w = p[name].detach()
        kax = w.ndim - 2
        out[name + "_packed"] = packing.pack_signs(w, axis=kax)
        out[name + "_alpha"] = _stage_mean_abs(w, kax, keepdim=True) \
            .to(torch.float32)
        del out[name]
    return out


def _is_linear(node: dict) -> bool:
    return "w" in node and "act_step" in node


def _is_moe(node: dict) -> bool:
    return "router" in node and "up" in node and "act_step" in node


EXPERTS = ("up", "gate", "down")


def _allocate_packed(spec, lead: tuple, dev):
    """`deploy_lm`'s tree for a spec tree, empty: the nodes it packs in
    packed form, the rest as `transformer.allocate` makes them."""
    if isinstance(spec, transformer.Stack):
        return _allocate_packed(spec.tree, (spec.n,), dev)
    if isinstance(spec, tuple):
        return tuple(_allocate_packed(s, lead, dev) for s in spec)
    if not isinstance(spec, dict):
        return transformer.allocate(spec, lead, torch.float32, dev)

    def empty(shape, dt):
        return torch.empty(lead + shape, dtype=dt, device=dev)
    if _is_linear(spec):
        k, n = spec["w"].shape
        out = {key: transformer.allocate(v, lead, torch.float32, dev)
               for key, v in spec.items() if key != "w"}
        out["act_step"] = torch.broadcast_to(
            out["act_step"][..., None], lead + (k,)).contiguous()
        out["w_packed"] = empty((packing.packed_dim(k), n), torch.int32)
        out["alpha"] = empty((n,), torch.float32)
        return out
    if _is_moe(spec):
        out = {key: transformer.allocate(v, lead, torch.float32, dev)
               for key, v in spec.items() if key not in EXPERTS}
        for name in EXPERTS:
            e, k, n = spec[name].shape
            out[name + "_packed"] = empty((e, packing.packed_dim(k), n),
                                          torch.int32)
            out[name + "_alpha"] = empty((e, 1, n), torch.float32)
        return out
    return {key: _allocate_packed(v, lead, dev) for key, v in spec.items()}


def _pack_leaf(out: dict, name: str, st, w: torch.Tensor) -> None:
    """`transformer.draw`'s sink for a packed init: a projection's or an
    expert stack's drawn stage goes into its sign words and α; any other
    leaf is written as drawn."""
    kax = w.ndim - 2
    if name == "w" and "w_packed" in out:
        out["w_packed"][st] = packing.pack_signs(w, axis=kax)
        out["alpha"][st] = _stage_mean_abs(w, kax).to(torch.float32)
    elif name in EXPERTS and name + "_packed" in out:
        out[name + "_packed"][st] = packing.pack_signs(w, axis=kax)
        out[name + "_alpha"][st] = _stage_mean_abs(
            w, kax, keepdim=True).to(torch.float32)
    else:
        transformer.write_leaf(out, name, st, w)


@torch.no_grad()
def init_packed_lm(cfg, generator, device=None) -> dict:
    """``deploy_lm(init_lm_params(cfg, generator, device))``, leaf for
    leaf, holding at most one f32 leaf of one stage at a time (jamba's
    expert up-projection, (16, 8192, 24576), is 12.9 GB)."""
    dev = resolve_device(device)
    if generator is None:
        raise ValueError(f"init_packed_lm needs a torch.Generator on {dev}")
    specs = transformer.lm_param_specs(cfg)
    out = _allocate_packed(specs, (), dev)
    transformer.draw(specs, out, generator, torch.float32, dev, _pack_leaf)
    return out


@torch.no_grad()
def deploy_lm(params):
    """Walk the param tree, packing every W1A8 projection (dicts holding
    both 'w' and 'act_step'). Non-quantized leaves pass through detached:
    a trained tree's leaves may require grad, and no leaf of the packed
    tree keeps a grad or a graph."""
    def walk(node):
        if isinstance(node, dict):
            if _is_linear(node):
                return _pack_linear(node)
            if _is_moe(node):
                return _pack_moe(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node.detach()
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
