"""QAT training of the paper's W1A8 detector: latent float weights through
the sign STE, LSQ activation steps (§3.2). Counterpart of
``repro/train/yolo_qat.py``.

The loss is YOLOv3's on the single 10×10 head: MSE on σ(tx), σ(ty) and on
the raw tw, th at the assigned cells, BCE on objectness and classes.

Autograd runs the conv backward at ``torch.autograd.grad``, long after the
forward's `device.full_f32` block has closed, and cuDNN's default would
compute the gradients in TF32. So the backward runs inside `full_f32` too
(`train.step.loss_and_grads`).
"""
from __future__ import annotations

import torch

from repro_torch.data.pipeline import yolo_target
from repro_torch.models import yolo
from repro_torch.models.yolo import GRID, NUM_ANCHORS, NUM_CLASSES
from repro_torch.optim import apply_updates, clip_by_global_norm
from repro_torch.train import step


def _bce_logits(logit: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """BCE in the softplus form, as the reference writes it (torch.maximum
    splits the gradient at a tie, as jnp.maximum does)."""
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * t
            + torch.log1p(torch.exp(-torch.abs(logit))))


def yolo_loss(params: dict, images: torch.Tensor,
              target: torch.Tensor) -> torch.Tensor:
    """target: (B, G, G, A, 5 + C) rasterized ground truth (`yolo_target`).
    The head must be GRID × GRID, so images are INPUT_SIZE square."""
    raw = yolo.yolo_forward_float(params, images, train=True)
    r = raw.reshape(raw.shape[0], GRID, GRID, NUM_ANCHORS, 5 + NUM_CLASSES)
    obj_t = target[..., 4]
    pos = (obj_t > 0.5)[..., None]

    pxy = torch.sigmoid(r[..., 0:2])
    # box centres relative to their cell: (x, y) is the (i, j) grid flipped
    ar = torch.arange(GRID, device=raw.device)
    cell = torch.stack(torch.meshgrid(ar, ar, indexing="ij"),
                       -1)[None, :, :, None, :]
    txy_t = target[..., 0:2] * GRID - cell.flip(-1)
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    loss_xy = torch.sum(torch.where(pos, (pxy - txy_t) ** 2, zero))
    wh_t = torch.log(torch.clamp(target[..., 2:4], 1e-3, 1.0))
    loss_wh = torch.sum(torch.where(pos, (r[..., 2:4] - wh_t) ** 2, zero))
    loss_obj = torch.mean(_bce_logits(r[..., 4], obj_t))
    loss_cls = torch.sum(torch.where(
        pos, _bce_logits(r[..., 5:], target[..., 5:]), zero))
    npos = torch.clamp(torch.sum(pos).to(raw.dtype), min=1.0)
    return (loss_xy + loss_wh + loss_cls) / npos + loss_obj


def loss_and_grads(params: dict, images: torch.Tensor,
                   target: torch.Tensor) -> tuple:
    """→ (loss, grads in params' shape), forward and backward in full f32.
    ``params`` is not changed."""
    loss, flat = step.loss_and_grads(
        lambda p, _: yolo_loss(p, images, target), params, None)
    return loss, step.unflatten_like(params, flat)


def make_yolo_train_step(optimizer, *, max_grad_norm: float = 5.0):
    """→ step(params, opt_state, images, boxes, classes) → (params,
    opt_state, {"loss", "grad_norm", "step"}). The metrics stay tensors on
    the params' device, so a step makes no host sync."""
    _, update = optimizer

    def step_fn(params, opt_state, images, boxes, classes):
        target = yolo_target(boxes, classes)
        loss, grads = loss_and_grads(params, images, target)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": opt_state["step"]}

    return step_fn
