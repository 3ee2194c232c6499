"""Generic LM assembly over stage-stacked params (dense family).

Counterpart of ``repro/models/transformer.py``. The layer pattern repeats
with period ``cfg.period`` (1 for uniform stacks, 2 for gemma2's local /
global pair). Each param leaf under ``params["slots"]`` carries a leading
``(num_layers // period,)`` stage axis, as the reference's; where the
reference scans over that axis, the port loops over it in Python.

W1A8 (the paper's technique): every body projection runs through
`layers.linear` in the requested mode; embedding and LM head stay full
precision (the Conv1/Conv11 rule).

Only the dense family is ported: a config with a Mamba mixer, an MoE FFN,
an encoder or a modality prefix raises `NotImplementedError` naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import (ModelConfig, attention, embed,
                                       init_attention, init_embed, init_mlp,
                                       init_norm, mlp, norm, unembed)

LATER = ("is not ported yet (ROADMAP.md, Queue 1, item 4: {what})")


def check_dense(cfg: ModelConfig) -> None:
    """Raises unless every layer of ``cfg`` is attention + a dense MLP."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder stack "
            + LATER.format(what="encoder-decoder"))
    for i in range(cfg.period):
        if cfg.mixer_kind(i) == "mamba":
            raise NotImplementedError(
                f"{cfg.name}: the Mamba mixer "
                + LATER.format(what="Mamba/hybrid and the mamba caches"))
        if cfg.ffn_kind(i) == "moe":
            raise NotImplementedError(
                f"{cfg.name}: the MoE FFN "
                + LATER.format(what="MoE and _apply_moe"))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a param or cache tree (nested dicts and
    tuples; anything else is a leaf), with the matching subtrees of
    ``rest``, in ``tree``'s shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, path: str = ""):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    tuples in order; a path reads like ``jax.tree_util.keystr``'s."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, f"{path}[{i}]")]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def kinds(cfg: ModelConfig) -> list:
    """(mixer, ffn) kind of each slot of one stage."""
    return [(cfg.mixer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.period)]


def window_of(cfg: ModelConfig, mixer_kind: str) -> int:
    """The attention window of a slot (0: none)."""
    if mixer_kind == "attn_local" or (cfg.sliding_window and
                                      not cfg.local_global):
        return cfg.sliding_window
    return 0


def stage(tree, i: int):
    """Stage ``i`` of stage-stacked slots: every leaf indexed on axis 0."""
    return tree_map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_slot(gen, cfg: ModelConfig, mixer_kind: str, ffn_kind: str,
               dtype, device, n_stages: int) -> dict:
    """One slot's params for all stages at once: each leaf is drawn with
    its leading (n_stages,) axis, so a full-width init holds no per-stage
    copies to stack."""
    lead = (n_stages,)
    kw = dict(dtype=dtype, device=device, lead=lead)
    slot = {"norm1": init_norm(cfg.d_model, cfg.norm_kind, **kw)}
    slot["attn"] = init_attention(gen, cfg, **kw)
    if cfg.post_norms:
        slot["post_norm1"] = init_norm(cfg.d_model, cfg.norm_kind, **kw)
    if ffn_kind != "none":
        slot["norm2"] = init_norm(cfg.d_model, cfg.norm_kind, **kw)
        slot["mlp"] = init_mlp(gen, cfg, **kw)
        if cfg.post_norms:
            slot["post_norm2"] = init_norm(cfg.d_model, cfg.norm_kind, **kw)
    return slot


def init_lm_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                   device=None, dtype=torch.float32) -> dict:
    """Random-init params in the reference's tree (``embed``,
    ``final_norm``, ``slots``: a tuple of one stage-stacked dict per slot
    of the period), drawn from ``generator``, which lives on ``device``
    (default: the card). On ``device="meta"`` only the shapes are made and
    ``generator`` may be None: `count_lm_params` of a full config needs
    no memory."""
    dev = resolve_device(device)
    check_dense(cfg)
    if generator is None and dev.type != "meta":
        raise ValueError("init_lm_params needs a torch.Generator on "
                         f"{dev}")
    period = cfg.period
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    n_stages = cfg.num_layers // period
    params = {"embed": init_embed(generator, cfg, dtype, dev),
              "final_norm": init_norm(cfg.d_model, cfg.norm_kind, dtype,
                                      dev)}
    params["slots"] = tuple(
        _init_slot(generator, cfg, mk, fk, dtype, dev, n_stages)
        for mk, fk in kinds(cfg))
    return params


def count_lm_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def add_mixer_out(slot: dict, cfg: ModelConfig, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """The residual add after a mixer (post-norm first, for gemma2)."""
    if cfg.post_norms:
        out = norm(slot["post_norm1"], out, cfg.norm_kind)
    return x + out.to(x.dtype)


def ffn_block(slot: dict, cfg: ModelConfig, x: torch.Tensor, ffn_kind: str,
              mode: str) -> torch.Tensor:
    """norm2 → dense MLP (→ post-norm) → residual add."""
    if ffn_kind == "none":
        return x
    h = norm(slot["norm2"], x, cfg.norm_kind)
    out = mlp(slot["mlp"], cfg, h, mode)
    if cfg.post_norms:
        out = norm(slot["post_norm2"], out, cfg.norm_kind)
    return x + out.to(x.dtype)


def _apply_slot(slot: dict, cfg: ModelConfig, x: torch.Tensor, *,
                mixer_kind: str, ffn_kind: str, mode: str,
                positions: torch.Tensor) -> torch.Tensor:
    h = norm(slot["norm1"], x, cfg.norm_kind)
    out = attention(slot["attn"], cfg, h, mode=mode, causal=True,
                    window=window_of(cfg, mixer_kind), positions=positions)
    x = add_mixer_out(slot, cfg, x, out)
    return ffn_block(slot, cfg, x, ffn_kind, mode)


def stage_count(params: dict) -> int:
    return tree_leaves(params["slots"])[0].shape[0]


# ---------------------------------------------------------------------------
# Forward (train/eval)
# ---------------------------------------------------------------------------

def lm_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
               mode: str = "float",
               prefix_embeds: Optional[torch.Tensor] = None,
               encoder_embeds: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """tokens (B, S) int → logits (B, S, vocab)."""
    check_dense(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError(
            "prefix_embeds " + LATER.format(what="the VLM prefix"))
    if encoder_embeds is not None:
        raise NotImplementedError(
            "encoder_embeds " + LATER.format(what="encoder-decoder"))
    x = embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for st in range(stage_count(params)):
        slots = stage(params["slots"], st)
        for i, (mk, fk) in enumerate(kinds(cfg)):
            x = _apply_slot(slots[i], cfg, x, mixer_kind=mk, ffn_kind=fk,
                            mode=mode, positions=positions)
    x = norm(params["final_norm"], x, cfg.norm_kind)
    return unembed(params["embed"], cfg, x)
