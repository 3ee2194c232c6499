"""QAT training of the paper's W1A8 detector: latent float weights through
the sign STE, LSQ activation steps (§3.2). Counterpart of
``repro/train/yolo_qat.py``.

The loss is YOLOv3's on the single 10×10 head: MSE on σ(tx), σ(ty) and on
the raw tw, th at the assigned cells, BCE on objectness and classes.

Autograd runs the conv backward at ``torch.autograd.grad``, long after the
forward's `device.full_f32` block has closed, and cuDNN's default would
compute the gradients in TF32. So the backward runs inside `full_f32` too
(`train.step.loss_and_grads`).

The reference jits its train step. Here the step's body (`make_eager_step`:
target, forward and backward, clip, AdamW) runs on tensors made once
(`fixed_tensors`, `qat_step`), and on the card one CUDA graph captured over
it (`capture_qat_step`) replays a step (`make_yolo_train_step`).
"""
from __future__ import annotations

import torch

from repro_torch.data.pipeline import yolo_target
from repro_torch.kernels import _build
from repro_torch.models import yolo
from repro_torch.models.yolo import GRID, NUM_ANCHORS, NUM_CLASSES
from repro_torch.optim import (apply_updates, clip_by_global_norm, tree_leaves,
                               tree_map)
from repro_torch.train import step

# eager steps before a capture: PyTorch's whole-network capture with
# autograd warms up with three on a side stream
WARM_STEPS = 3


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


def make_eager_step(optimizer, *, max_grad_norm: float = 5.0):
    """The step's body, out of place: → step(params, opt_state, images,
    boxes, classes) → (params, opt_state, {"loss", "grad_norm", "step"}),
    new tensors each, the arguments unchanged. The metrics stay tensors on
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


def fixed_tensors(params: dict, opt_state: dict, images: torch.Tensor,
                  boxes: torch.Tensor, classes: torch.Tensor) -> dict:
    """The tensors a step on fixed tensors reads and writes, each a clone:
    ``params``, ``state`` (the optimizer's), ``batch`` (images, boxes,
    classes) and ``metrics`` (loss, grad_norm, step)."""
    return tree_map(torch.clone, {
        "params": params, "state": opt_state,
        "batch": (images, boxes, classes),
        "metrics": {"loss": images.new_zeros(()),
                    "grad_norm": images.new_zeros(()),
                    "step": opt_state["step"]}})


def qat_step(body, fixed: dict) -> None:
    """One step of ``body`` (`make_eager_step`'s) on ``fixed``
    (`fixed_tensors`'s), every new param, moment, ``step`` and metric
    `copy_`'d back into its tensor after the whole step has run, so that a
    CUDA graph captured over it (`capture_qat_step`) replays it."""
    params, state, metrics = body(fixed["params"], fixed["state"],
                                  *fixed["batch"])
    new = {"params": params, "state": state, "metrics": metrics}
    with torch.no_grad():
        for key, tree in new.items():
            for dst, src in zip(tree_leaves(fixed[key]), tree_leaves(tree)):
                dst.copy_(src)


def capture_qat_step(body, fixed: dict) -> _build.Graph:
    """`qat_step` on ``fixed`` captured as a CUDA graph (the counterpart
    of the reference's jitted step). WARM_STEPS eager steps run first on a
    side stream, on clones of ``fixed``, so that cuDNN picks its
    algorithms and autograd and the allocator warm up while the live
    params, moments and ``step`` stay as they were; the capture itself
    runs nothing. A capture that fails raises."""
    dev = fixed["metrics"]["loss"].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        warm = tree_map(torch.clone, fixed)
        for _ in range(WARM_STEPS):
            qat_step(body, warm)
    cur.wait_stream(side)
    del warm
    graph = torch.cuda.CUDAGraph()
    with _build.capturing() as launches, torch.cuda.device(dev), \
            torch.cuda.graph(graph):
        qat_step(body, fixed)
    return _build.Graph(graph, launches)


def _same_layout(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.device == y.device
        for x, y in zip(a, b))


class QATStep:
    """`make_yolo_train_step`'s step: `qat_step` on tensors of its own
    (``fixed``), made at the first call from clones of the arguments, and
    made anew where the arguments' shapes, dtypes or devices change. On
    the card (``device``) a call is one replay of a graph captured at the
    first call (``graph``, `capture_qat_step`); on the CPU it runs
    `qat_step` directly."""

    def __init__(self, optimizer, max_grad_norm: float):
        self.body = make_eager_step(optimizer, max_grad_norm=max_grad_norm)
        self.fixed, self.graph, self.device = None, None, None

    def __call__(self, params, opt_state, images, boxes, classes):
        batch = (images, boxes, classes)
        held = tree_leaves(params) + tree_leaves(opt_state)
        fixed = self.fixed
        mine = [] if fixed is None else (tree_leaves(fixed["params"])
                                         + tree_leaves(fixed["state"]))
        if fixed is None or not _same_layout(mine + list(fixed["batch"]),
                                             held + list(batch)):
            self.fixed = fixed = fixed_tensors(params, opt_state, *batch)
            self.graph, self.device = None, images.device
        else:
            with torch.no_grad():
                for dst, src in zip(fixed["batch"], batch):
                    dst.copy_(src)
                if any(a is not b for a, b in zip(mine, held)):
                    for dst, src in zip(mine, held):
                        dst.copy_(src)
        if self.device.type == "cuda":
            if self.graph is None:
                self.graph = capture_qat_step(self.body, fixed)
            self.graph.replay()
        else:
            qat_step(self.body, fixed)
        return fixed["params"], fixed["state"], {
            k: v.clone() for k, v in fixed["metrics"].items()}


def make_yolo_train_step(optimizer, *,
                         max_grad_norm: float = 5.0) -> QATStep:
    """→ step(params, opt_state, images, boxes, classes) → (params,
    opt_state, {"loss", "grad_norm", "step"}): `make_eager_step`'s body on
    the step's own tensors, on the card one CUDA graph replay a step. The
    caller's params and state are never written: the params and state it
    returns are the step's own tensors, which its next call overwrites
    (clone them to keep them). The metrics are new tensors each call, on
    the params' device, so a step makes no host sync."""
    return QATStep(optimizer, max_grad_norm)
