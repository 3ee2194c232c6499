"""The LM train step: QAT loss, microbatch gradient accumulation, clip,
update. Counterpart of ``repro/train/step.py`` (`lm_loss`,
`make_train_step`); the pipelined step waits for the distribution layer
(ROADMAP.md, Queue 1, item 6).

Gradients come from ``torch.autograd.grad`` on detached copies of the
param leaves, so a step changes no tensor it was handed. Autograd runs the
backward at that call, after the forward's `device.full_f32` blocks have
closed, and would run its matmuls in the global TF32 setting: the forward
and the backward both run inside `full_f32`. With ``microbatches`` > 1
the batch splits along dim 0 into equal slices; each slice's loss and
grads are summed in f32 and the sums divided by the count, as the
reference's ``lax.scan`` does. No graph is held across slices.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.device import full_f32
from repro_torch.models.transformer import lm_forward
from repro_torch.optim import (apply_updates, clip_by_global_norm,
                               tree_leaves, tree_map)
from repro_torch.optim.optimizers import full_like0

Z_LOSS = 1e-4
EMBEDS = ("encoder_embeds", "prefix_embeds")


def lm_loss(cfg, params: dict, batch: dict, *, mode: str,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL over the batch's tokens (the modality prefix's
    logits dropped), log-softmax in f32, plus the z-loss
    1e-4·mean(logsumexp²). ``batch``: tokens and labels (B, S) int, and
    ``encoder_embeds`` / ``prefix_embeds`` where the arch takes them."""
    kw = {k: batch[k] for k in EMBEDS if k in batch}
    logits = lm_forward(cfg, params, batch["tokens"], mode=mode,
                        remat=remat, **kw)
    seq = batch["tokens"].shape[1]
    logits = logits[:, -seq:, :].to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    zloss = Z_LOSS * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return torch.mean(nll) + zloss


def loss_and_grads(loss_fn: Callable, params, batch) -> tuple:
    """→ (loss, grads as a list in `tree_leaves` order) of
    ``loss_fn(params, batch)``, forward and backward in full f32. A leaf
    the loss does not reach gets zeros, as ``jax.value_and_grad`` gives
    it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree_leaves(leaves)
    with torch.enable_grad(), full_f32():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def unflatten_like(params, flat: list):
    """``flat`` (in `tree_leaves` order of ``params``) in params' shape."""
    by_id = dict(zip(map(id, tree_leaves(params)), flat))
    return tree_map(lambda p: by_id[id(p)], params)


def accumulated_grads(loss_fn: Callable, params, batch: dict,
                      microbatches: int) -> tuple:
    """(loss, grads in `tree_leaves` order) of ``batch`` split along dim 0
    into ``microbatches`` equal slices: the slices' losses and grads summed
    in f32, then divided by the count."""
    if microbatches == 1:
        return loss_and_grads(loss_fn, params, batch)
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"a batch of {b} does not split into "
                         f"{microbatches} microbatches")
    m = b // microbatches
    loss_sum, gsum = None, None
    for i in range(microbatches):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss, grads = loss_and_grads(loss_fn, params, mb)
        if gsum is None:
            loss_sum = loss.to(torch.float32)
            gsum = [g.to(torch.float32) for g in grads]
            continue
        loss_sum = loss_sum + loss
        for j, g in enumerate(grads):
            # out of place: autograd may hand two leaves one tensor
            gsum[j] = gsum[j] + g
            grads[j] = None
    return (loss_sum / full_like0(loss_sum, microbatches),
            [g / full_like0(g, microbatches) for g in gsum])


def make_train_step(cfg, optimizer, *, mode: str = "w1a8_train",
                    microbatches: int = 1, max_grad_norm: float = 1.0,
                    remat: bool = True,
                    loss_fn: Optional[Callable] = None):
    """→ train_step(params, opt_state, batch) → (params, opt_state,
    metrics), metrics ``{"loss", "grad_norm", "step"}`` as tensors on the
    params' device (a step makes no host sync).

    batch: dict of tensors whose dim 0 is the step's global batch, split
    into ``microbatches`` equal slices accumulated in f32. ``loss_fn(params,
    batch)`` replaces `lm_loss` (mode and remat then unused)."""
    _, update = optimizer
    loss_fn = loss_fn or functools.partial(lm_loss, cfg, mode=mode,
                                           remat=remat)

    def train_step(params, opt_state, batch):
        loss, grads = accumulated_grads(loss_fn, params, batch, microbatches)
        grads, gnorm = clip_by_global_norm(unflatten_like(params, grads),
                                           max_grad_norm)
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return train_step
